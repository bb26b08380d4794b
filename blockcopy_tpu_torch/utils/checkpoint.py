"""Checkpoint loading and saving (counterpart of
``blockcopy_tpu/utils/checkpoint.py``).

Two formats:

* Reference torch ``.pth`` checkpoints (``checkpoint["state_dict"]`` of
  SwiftNet): converted key by key into the port's parameter tree.  Conv
  weights stay OIHW; eval-mode BatchNorms are folded to (scale, bias) with
  the JAX converter's fp32 numpy arithmetic, so the result equals it bit for
  bit after the layout transpose.
* The JAX package's flat ``.npz`` trees ('/'-joined keys, HWIO conv
  weights), for model parameters and policy state.  Files the JAX package
  writes load here; model files written here load there (policy files lack
  the JAX sampling ``key``, which the port does not keep).
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import numpy as np
import torch

from blockcopy_tpu_torch.device import resolve_device
from blockcopy_tpu_torch.policy.optim import tree_map
from blockcopy_tpu_torch.utils.convert import params_from_jax, params_to_numpy

logger = logging.getLogger(__name__)

BN_EPS = 1e-5


def _fold_bn(sd: Dict[str, np.ndarray], prefix: str):
    gamma = sd[f"{prefix}.weight"]
    beta = sd[f"{prefix}.bias"]
    mean = sd[f"{prefix}.running_mean"]
    var = sd[f"{prefix}.running_var"]
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"scale": torch.from_numpy(np.asarray(scale)),
            "bias": torch.from_numpy(np.asarray(beta - mean * scale))}


def _conv(sd: Dict[str, np.ndarray], key: str, bias_key: str = None):
    p = {"w": torch.from_numpy(np.array(sd[key]))}     # OIHW as stored
    if bias_key and bias_key in sd:
        p["b"] = torch.from_numpy(np.array(sd[bias_key]))
    return p


def _bnrc(sd, prefix: str):
    p = {"conv": _conv(sd, f"{prefix}.conv.weight", f"{prefix}.conv.bias")}
    if f"{prefix}.norm.weight" in sd:
        p["bn"] = _fold_bn(sd, f"{prefix}.norm")
    return p


def convert_swiftnet_state_dict(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """Torch SwiftNet ``state_dict`` (numpy values) -> the port's parameter
    tree, as CPU tensors.

    Key layout of the reference modules: ``backbone.*`` (torchvision
    ResNet), ``spp.spp.{spp_bn,spp0..,spp_fuse}.{norm,conv}``,
    ``upsample.{i}.{bottleneck,blend_conv}.{norm,conv}``,
    ``logits.{norm,conv}``."""
    rn = cfg.resnet
    bb: Dict = {
        "conv1": _conv(sd, "backbone.conv1.weight"),
        "bn1": _fold_bn(sd, "backbone.bn1"),
    }
    for stage in range(1, 5):
        blocks = []
        b = 0
        while f"backbone.layer{stage}.{b}.conv1.weight" in sd:
            pre = f"backbone.layer{stage}.{b}"
            blk = {
                "conv1": _conv(sd, f"{pre}.conv1.weight"),
                "bn1": _fold_bn(sd, f"{pre}.bn1"),
                "conv2": _conv(sd, f"{pre}.conv2.weight"),
                "bn2": _fold_bn(sd, f"{pre}.bn2"),
            }
            if rn.bottleneck:
                blk["conv3"] = _conv(sd, f"{pre}.conv3.weight")
                blk["bn3"] = _fold_bn(sd, f"{pre}.bn3")
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = {
                    "conv": _conv(sd, f"{pre}.downsample.0.weight"),
                    "bn": _fold_bn(sd, f"{pre}.downsample.1"),
                }
            blocks.append(blk)
            b += 1
        bb[f"layer{stage}"] = blocks

    params: Dict = {"backbone": bb}
    params["spp"] = {
        "bn": _bnrc(sd, "spp.spp.spp_bn"),
        "levels": [_bnrc(sd, f"spp.spp.spp{i}")
                   for i in range(cfg.spp_levels)],
        "fuse": _bnrc(sd, "spp.spp.spp_fuse"),
    }
    params["ups"] = [
        {"bottleneck": _bnrc(sd, f"upsample.{i}.bottleneck"),
         "blend": _bnrc(sd, f"upsample.{i}.blend_conv")}
        for i in range(3)
    ]
    params["logits"] = _bnrc(sd, "logits")
    return params


def load_torch_checkpoint(path: str, cfg, dtype=torch.float32,
                          device=None) -> Dict:
    """A reference ``.pth`` as the port's parameters in ``dtype`` on
    ``device`` (default CUDA).  Loaded with ``weights_only=True``: tensors
    and plain containers only, no arbitrary objects."""
    device = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in sd.items()}
    params = convert_swiftnet_state_dict(sd, cfg)
    logger.info("converted torch checkpoint '%s' (%d tensors)", path, len(sd))
    return tree_map(lambda t: t.to(device=device, dtype=dtype), params)


# -- the JAX package's npz trees ----------------------------------------------


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_params(path: str, tree) -> None:
    """Write a tree of tensors (OIHW conv weights) as the JAX package's flat
    npz: HWIO conv weights, bf16 widened to fp32.  ``np.savez`` appends
    ``.npz`` to a path without it."""
    np.savez(path, **_flatten(params_to_numpy(tree)))


def _npz_path(path: str) -> str:
    if not os.path.exists(path) and not path.endswith(".npz") \
            and os.path.exists(path + ".npz"):
        # np.savez appended '.npz' to an extensionless save path
        return path + ".npz"
    return path


def load_npz(path: str, like, dtype=None, device=None) -> Dict:
    """A flat npz rebuilt into the structure of ``like`` (the port's
    layout: lists for the JAX package's lists and tuples), HWIO conv
    weights to OIHW, on ``device`` (default CUDA)."""
    device = resolve_device(device)
    with np.load(_npz_path(path)) as data:
        missing = set(_flatten(tree_map(lambda _: 0, like))) \
            - set(data.files)
        if missing:
            raise KeyError(
                f"checkpoint missing keys: {sorted(missing)[:5]} ...")

        def rebuild(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: rebuild(v, f"{prefix}{k}/")
                        for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [rebuild(v, f"{prefix}{i}/")
                        for i, v in enumerate(tree)]
            return np.asarray(data[prefix[:-1]])

        tree = params_from_jax(rebuild(like), device)
    return tree if dtype is None else tree_map(lambda t: t.to(dtype), tree)


def load_params(path: str, cfg, dtype=torch.float32, device=None) -> Dict:
    """SwiftNet parameters from a ``.pth``/``.pt`` or an ``.npz``."""
    if path.endswith((".pth", ".pt")):
        return load_torch_checkpoint(path, cfg, dtype, device)
    if path.endswith(".npz"):
        from blockcopy_tpu_torch.models.swiftnet import init_swiftnet
        like = init_swiftnet(cfg, device="meta")
        return load_npz(path, like, dtype, device)
    raise ValueError(f"unknown checkpoint format: {path}")


def save_orbax(path: str, tree) -> None:
    raise NotImplementedError(
        "orbax checkpoints (sharded mesh state) are not ported yet: ROADMAP "
        "Queue 1 item 13")


def load_orbax(path: str, like) -> Dict:
    raise NotImplementedError(
        "orbax checkpoints (sharded mesh state) are not ported yet: ROADMAP "
        "Queue 1 item 13")

