"""Pedestron/mmdet CSP checkpoint conversion (counterpart of
``blockcopy_tpu/tasks/detection/checkpoint.py``).

Converts a reference CSP checkpoint (``mmcv load_checkpoint`` state_dict,
including the mean-teacher ``.pth.stu`` student variants —
``tools/test_city_person.py:277-299``) into the port's CSP parameter tree.
The port keeps torch layouts (OIHW convs, the neck's transposed convs as
(in, out, kh, kw)), so the tensors keep their shapes: BatchNorms are folded
to (scale, bias) with the JAX converter's fp32 numpy arithmetic, ConvModule
GroupNorms kept as (gamma, beta), the head's ``Scale`` scalars kept.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from blockcopy_tpu_torch.device import resolve_device
from blockcopy_tpu_torch.policy.optim import tree_map
from blockcopy_tpu_torch.utils.checkpoint import _conv, _fold_bn

logger = logging.getLogger(__name__)


def _tensor(sd, key) -> torch.Tensor:
    return torch.from_numpy(np.array(sd[key]))


def convert_csp_state_dict(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """mmdet CSP ``state_dict`` (numpy values) -> the port's parameter tree,
    as CPU tensors."""
    bb: Dict = {
        "conv1": _conv(sd, "backbone.conv1.weight"),
        "bn1": _fold_bn(sd, "backbone.bn1"),
    }
    for stage in range(1, 5):
        blocks = []
        b = 0
        while f"backbone.layer{stage}.{b}.conv1.weight" in sd:
            pre = f"backbone.layer{stage}.{b}"
            blk = {}
            for i in (1, 2, 3):
                blk[f"conv{i}"] = _conv(sd, f"{pre}.conv{i}.weight")
                blk[f"bn{i}"] = _fold_bn(sd, f"{pre}.bn{i}")
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = {
                    "conv": _conv(sd, f"{pre}.downsample.0.weight"),
                    "bn": _fold_bn(sd, f"{pre}.downsample.1"),
                }
            blocks.append(blk)
            b += 1
        bb[f"layer{stage}"] = blocks

    neck: Dict = {}
    for p in ("p3", "p4", "p5"):
        # ConvTranspose2d weights are (in, out, kh, kw), the port's layout
        neck[p] = _conv(sd, f"neck.{p}.weight", f"neck.{p}.bias")
        neck[f"{p}_l2"] = _tensor(sd, f"neck.{p}_l2.weight")

    head: Dict = {}
    for branch in ("cls", "reg", "offset"):
        convs = []
        i = 0
        while f"bbox_head.{branch}_convs.{i}.conv.weight" in sd:
            pre = f"bbox_head.{branch}_convs.{i}"
            convs.append({
                "conv": _conv(sd, f"{pre}.conv.weight"),
                "gn": {"gamma": _tensor(sd, f"{pre}.gn.weight"),
                       "beta": _tensor(sd, f"{pre}.gn.bias")},
            })
            i += 1
        head[f"{branch}_convs"] = convs
    for key in ("csp_cls", "csp_reg", "csp_offset"):
        head[key] = _conv(sd, f"bbox_head.{key}.weight",
                          f"bbox_head.{key}.bias")
    head["reg_scale"] = _tensor(sd, "bbox_head.reg_scales.0.scale")
    head["offset_scale"] = _tensor(sd, "bbox_head.offset_scales.0.scale")
    return {"backbone": bb, "neck": neck, "head": head}


def load_csp_torch_checkpoint(path: str, cfg, dtype=torch.float32,
                              device=None) -> Dict:
    """A reference ``.pth``, ``.pt`` or ``.pth.stu`` as the port's CSP
    parameters, every leaf in ``dtype`` (as JAX's loader) on ``device``
    (default CUDA).  Loaded with ``weights_only=True``: tensors and plain
    containers only, no arbitrary objects."""
    device = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k.replace("module.", "", 1) if k.startswith("module.") else k:
          (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in sd.items()}
    params = convert_csp_state_dict(sd, cfg)
    logger.info("converted CSP checkpoint '%s' (%d tensors)", path, len(sd))
    return tree_map(lambda t: t.to(device=device, dtype=dtype), params)
