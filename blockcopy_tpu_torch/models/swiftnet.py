"""SwiftNet semantic segmentation, dense and blocked from one definition
(counterpart of ``blockcopy_tpu/models/swiftnet.py``).

ResNet encoder, Spatial Pyramid Pooling over the last stage (dense, through
``noblocks``), three upsample stages and a 1x1 logits head; output stride 4.
Parameters are nested dicts of tensors with the JAX pytree's structure; conv
weights are OIHW, BatchNorm is folded (scale, bias).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Sequence

import torch

from blockcopy_tpu_torch.core import blocked as _blocked
from blockcopy_tpu_torch.core.blocked import BlockPack, ExecCtx
from blockcopy_tpu_torch.core.engine import noblocks
from blockcopy_tpu_torch.device import resolve_device
from blockcopy_tpu_torch.ops import layers as L
from blockcopy_tpu_torch.ops.kernels.bottleneck import (bottleneck_tail,
                                                        kernel_takes)

# Fused bottleneck-tail kernel for stride-1 identity bottlenecks.  Tri-state
# like the JAX flag (``swiftnet.py:39``): None = auto, "0"/"1" force.  Auto is
# ON here, unlike the JAX default, so the main path runs the kernel.
FUSED_BOTTLENECK = {"0": False, "1": True}.get(
    os.environ.get("BLOCKCOPY_TPU_FUSED_BOTTLENECK", ""), None)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: Sequence[int]
    bottleneck: bool
    groups: int = 1
    base_width: int = 64

    @property
    def expansion(self) -> int:
        return 4 if self.bottleneck else 1

    @property
    def block_features(self) -> List[int]:
        return [c * self.expansion for c in (64, 128, 256, 512)]

    def width(self, planes: int) -> int:
        return int(planes * self.base_width / 64.0) * self.groups


RESNETS = {
    "resnet18": ResNetConfig((2, 2, 2, 2), False),
    "resnet34": ResNetConfig((3, 4, 6, 3), False),
    "resnet50": ResNetConfig((3, 4, 6, 3), True),
    "resnet101": ResNetConfig((3, 4, 23, 3), True),
    "resnet152": ResNetConfig((3, 8, 36, 3), True),
    "resnext50_32x4d": ResNetConfig((3, 4, 6, 3), True, groups=32,
                                    base_width=4),
    "resnext101_32x8d": ResNetConfig((3, 4, 23, 3), True, groups=32,
                                     base_width=8),
    "wide_resnet50_2": ResNetConfig((3, 4, 6, 3), True, base_width=128),
    "wide_resnet101_2": ResNetConfig((3, 4, 23, 3), True, base_width=128),
}


@dataclasses.dataclass(frozen=True)
class SwiftNetConfig:
    backbone: str = "resnet18"
    num_classes: int = 19
    num_features: int = 128
    spp_grids: Sequence[int] = (8, 4, 2, 1)
    spp_levels: int = 3

    @property
    def resnet(self) -> ResNetConfig:
        return RESNETS[self.backbone]


# ---------------------------------------------------------------------------
# initialization (same scheme as the JAX package, drawn from a torch
# Generator: the values differ; ``utils/convert.py`` carries JAX's across)
# ---------------------------------------------------------------------------


class _Init:
    def __init__(self, gen: torch.Generator, dtype, device):
        self.gen, self.dtype, self.device = gen, dtype, device

    def conv(self, kh, kw, cin, cout, bias=False):
        n = kh * kw * cout  # kaiming fan_out, relu
        w = torch.randn((cout, cin, kh, kw), generator=self.gen) \
            * math.sqrt(2.0 / n)
        p = {"w": w.to(device=self.device, dtype=self.dtype)}
        if bias:
            p["b"] = torch.zeros(cout, dtype=self.dtype, device=self.device)
        return p

    def bn(self, c):
        return {"scale": torch.ones(c, dtype=self.dtype, device=self.device),
                "bias": torch.zeros(c, dtype=self.dtype, device=self.device)}

    def bnrc(self, cin, cout, k, bias=False):
        return {"conv": self.conv(k, k, cin, cout, bias=bias),
                "bn": self.bn(cin)}

    def basic_block(self, cin, cout, stride):
        p = {"conv1": self.conv(3, 3, cin, cout), "bn1": self.bn(cout),
             "conv2": self.conv(3, 3, cout, cout), "bn2": self.bn(cout)}
        if stride != 1 or cin != cout:
            p["downsample"] = {"conv": self.conv(1, 1, cin, cout),
                               "bn": self.bn(cout)}
        return p

    def bottleneck(self, cin, planes, stride, groups, width):
        cout = planes * 4
        p = {"conv1": self.conv(1, 1, cin, width), "bn1": self.bn(width),
             "conv2": self.conv(3, 3, width // groups, width),
             "bn2": self.bn(width),
             "conv3": self.conv(1, 1, width, cout), "bn3": self.bn(cout)}
        if stride != 1 or cin != cout:
            p["downsample"] = {"conv": self.conv(1, 1, cin, cout),
                               "bn": self.bn(cout)}
        return p


def init_resnet(init: _Init, cfg: ResNetConfig) -> Dict:
    params: Dict = {"conv1": init.conv(7, 7, 3, 64), "bn1": init.bn(64)}
    cin = 64
    for stage, (planes, blocks) in enumerate(
            zip((64, 128, 256, 512), cfg.layers)):
        stage_params = []
        for b in range(blocks):
            s = (1 if stage == 0 else 2) if b == 0 else 1
            if cfg.bottleneck:
                stage_params.append(init.bottleneck(
                    cin, planes, s, cfg.groups, cfg.width(planes)))
                cin = planes * 4
            else:
                stage_params.append(init.basic_block(cin, planes, s))
                cin = planes
        params[f"layer{stage + 1}"] = stage_params
    return params


def init_swiftnet(cfg: SwiftNetConfig, seed: int = 0,
                  dtype=torch.float32, device=None) -> Dict:
    """Random SwiftNet parameters on ``device`` (default CUDA)."""
    init = _Init(torch.Generator().manual_seed(seed), dtype,
                 resolve_device(device))
    feats = cfg.resnet.block_features
    nf = cfg.num_features
    level_size = nf // cfg.spp_levels
    final_size = nf + cfg.spp_levels * level_size
    params: Dict = {"backbone": init_resnet(init, cfg.resnet)}
    params["spp"] = {
        "bn": init.bnrc(feats[3], nf, 1),
        "levels": [init.bnrc(nf, level_size, 1)
                   for _ in range(cfg.spp_levels)],
        "fuse": init.bnrc(final_size, nf, 1),
    }
    params["ups"] = [{"bottleneck": init.bnrc(skip, nf, 1),
                      "blend": init.bnrc(nf, nf, 3)}
                     for skip in (feats[2], feats[1], feats[0])]
    params["logits"] = init.bnrc(nf, cfg.num_classes, 1, bias=True)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _bnrc(ctx: ExecCtx, name: str, x, p, stride=1, dilation=1):
    """BN -> ReLU -> conv."""
    if "bn" in p:
        x = L.batch_norm(x, p["bn"]["scale"], p["bn"]["bias"])
    x = L.relu(x)
    return L.conv2d(ctx, name, x, p["conv"]["w"], p["conv"].get("b"),
                    stride=stride, dilation=dilation)


def _downsample(ctx, name, x, p, stride):
    identity = L.conv2d(ctx, f"{name}.ds", x, p["downsample"]["conv"]["w"],
                        stride=stride, padding=0)
    return L.batch_norm(identity, p["downsample"]["bn"]["scale"],
                        p["downsample"]["bn"]["bias"])


def _basic_block(ctx, name, x, p, stride):
    identity = _downsample(ctx, name, x, p, stride) \
        if "downsample" in p else x
    out = L.conv2d(ctx, f"{name}.conv1", x, p["conv1"]["w"], stride=stride)
    out = L.relu(L.batch_norm(out, p["bn1"]["scale"], p["bn1"]["bias"]))
    out = L.conv2d(ctx, f"{name}.conv2", out, p["conv2"]["w"])
    out = L.batch_norm(out, p["bn2"]["scale"], p["bn2"]["bias"])
    return L.relu(L.add(out, identity))


def _fused_bottleneck(ctx: ExecCtx, name: str, x: BlockPack, p):
    """Stride-1 identity bottleneck with the tail in the fused kernel; the h1
    strips go to the same named canvas the unfused path uses, and the
    kernel reads its halo from them in place."""
    h1 = L.conv2d(ctx, f"{name}.conv1", x, p["conv1"]["w"], padding=0)
    h1 = L.relu(L.batch_norm(h1, p["bn1"]["scale"], p["bn1"]["bias"]))
    halo = ctx.exchange_strips(f"{name}.conv2", h1, 1)
    y = bottleneck_tail(
        h1.data, x.data, halo,
        p["conv2"]["w"], p["bn2"]["scale"], p["bn2"]["bias"],
        p["conv3"]["w"], p["bn3"]["scale"], p["bn3"]["bias"])
    c_mid = p["conv2"]["w"].shape[1]
    ctx.add_macs(h1.data.numel() * c_mid * 9, f"{name}.conv2")
    ctx.add_macs(y.numel() * c_mid, f"{name}.conv3")
    return x.with_data(y)


def maybe_fused_bottleneck(ctx, name, x, p, stride, groups=1, dilation=1):
    """Run the fused tail when eligible (the gate of ``swiftnet.py:283``)
    and the kernel of the activations' dtype takes the block
    (``kernel_takes``), else return None.  In bf16 and fp32 the kernel takes
    every block the other conditions let through, so this fuses exactly the
    blocks JAX's gate fuses with its switch on (``swiftnet.py:283-298``)."""
    fused = True if FUSED_BOTTLENECK is None else FUSED_BOTTLENECK
    if (fused and isinstance(x, BlockPack) and not ctx.is_dense
            and not ctx.building and stride == 1 and groups == 1
            and dilation == 1 and "downsample" not in p
            and _blocked.HALO_IMPL == "strips"
            and p["conv2"]["w"].shape[1] % 128 == 0
            and x.data.shape[-1] % 128 == 0
            and x.data.shape[1] >= 8
            and kernel_takes(x.data.dtype, x.data.shape[1],
                             p["conv2"]["w"].shape[1], x.data.shape[-1])):
        return _fused_bottleneck(ctx, name, x, p)
    return None


def _bottleneck_block(ctx, name, x, p, stride, groups=1):
    out = maybe_fused_bottleneck(ctx, name, x, p, stride, groups)
    if out is not None:
        return out
    identity = _downsample(ctx, name, x, p, stride) \
        if "downsample" in p else x
    out = L.conv2d(ctx, f"{name}.conv1", x, p["conv1"]["w"], padding=0)
    out = L.relu(L.batch_norm(out, p["bn1"]["scale"], p["bn1"]["bias"]))
    out = L.conv2d(ctx, f"{name}.conv2", out, p["conv2"]["w"], stride=stride,
                   groups=groups)
    out = L.relu(L.batch_norm(out, p["bn2"]["scale"], p["bn2"]["bias"]))
    out = L.conv2d(ctx, f"{name}.conv3", out, p["conv3"]["w"], padding=0)
    out = L.batch_norm(out, p["bn3"]["scale"], p["bn3"]["bias"])
    return L.relu(L.add(out, identity))


def _stem(ctx: ExecCtx, x, params):
    """7x7 s2 conv + BN + ReLU + 3x3 s2 maxpool; on blocked input under strip
    halos, fused in s2d plane form (``swiftnet.py:325``)."""
    w = params["conv1"]["w"]
    if (L.STEM_PLANE_POOL and isinstance(x, BlockPack) and not ctx.is_dense
            and not L.BLOCKPAD_WITH_ZEROES and w.shape[2] == 7
            and w.shape[1] <= 4 and x.data.shape[1] % 4 == 0
            and x.data.shape[1] >= 8 and _blocked.HALO_IMPL == "strips"):
        out = L.stem_pool_s2d(ctx, "backbone.conv1", "backbone.maxpool", x,
                              w, params["bn1"]["scale"],
                              params["bn1"]["bias"])
        if out is not None:
            # the conv's output is 4x the pooled one (``swiftnet.py:343``)
            ctx.add_macs(out.data.numel() * 4 * w.shape[1] * 49,
                         "backbone.conv1")
            return out
    x = L.conv2d(ctx, "backbone.conv1", x, w, stride=2, padding=3)
    x = L.relu(L.batch_norm(x, params["bn1"]["scale"], params["bn1"]["bias"]))
    return L.max_pool2d(ctx, "backbone.maxpool", x, kernel=3, stride=2,
                        padding=1)


def resnet_forward_down(params, x, ctx: ExecCtx, cfg: ResNetConfig):
    """Backbone ``forward_down``: the four stage features."""
    x = _stem(ctx, x, params)
    feats = []
    for stage in range(4):
        for b, p in enumerate(params[f"layer{stage + 1}"]):
            s = (1 if stage == 0 else 2) if b == 0 else 1
            name = f"backbone.layer{stage + 1}.{b}"
            if cfg.bottleneck:
                x = _bottleneck_block(ctx, name, x, p, s, groups=cfg.groups)
            else:
                x = _basic_block(ctx, name, x, p, s)
        feats.append(x)
    return feats


def spp_forward_dense(params, x, cfg: SwiftNetConfig, dense_ctx=None):
    """Dense SPP, called through ``noblocks``."""
    dense_ctx = dense_ctx if dense_ctx is not None else ExecCtx.dense()
    h, w = x.shape[1], x.shape[2]
    ar = w / h
    x = _bnrc(dense_ctx, "spp.bn", x, params["bn"])
    levels = [x]
    for i in range(cfg.spp_levels):
        g = cfg.spp_grids[i]
        pooled = L.adaptive_avg_pool2d(x, (g, max(1, round(ar * g))))
        lvl = _bnrc(dense_ctx, f"spp.level{i}", pooled, params["levels"][i])
        levels.append(L.resize_bilinear(lvl, (h, w)))
    return _bnrc(dense_ctx, "spp.fuse", torch.cat(levels, dim=-1),
                 params["fuse"])


def _upsample_stage(ctx, name, x, skip, p):
    skip = _bnrc(ctx, f"{name}.bottleneck", skip, p["bottleneck"])
    x = L.add(L.upsample2x(x), skip)
    return _bnrc(ctx, f"{name}.blend", x, p["blend"])


def swiftnet_apply(params, x, ctx: ExecCtx, cfg: SwiftNetConfig):
    """Full forward: logits at output stride 4."""
    feats = resnet_forward_down(params["backbone"], x, ctx, cfg.resnet)
    out = noblocks(ctx, "spp", feats[3],
                   lambda dctx, d: spp_forward_dense(params["spp"], d, cfg,
                                                     dctx))
    for i, skip in enumerate([feats[2], feats[1], feats[0]]):
        out = _upsample_stage(ctx, f"up{i}", out, skip, params["ups"][i])
    return _bnrc(ctx, "logits", out, params["logits"])


def make_apply_fn(cfg: SwiftNetConfig):
    def apply_fn(params, x, ctx):
        return swiftnet_apply(params, x, ctx, cfg)
    return apply_fn
