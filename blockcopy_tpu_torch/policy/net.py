"""Policy network (counterpart of ``blockcopy_tpu/policy/net.py``).

Two architectures: ``ref`` (CIFAR-style ResNet-8 trunk + 3-layer strided
head, the reference PolicyNet) and ``fast`` (space-to-depth-4 stem as one
k4s4 conv, two basic blocks, 2-layer head).  The net always runs in train
mode: BatchNorm normalises with batch statistics (biased variance) and
updates running statistics (unbiased variance, momentum 0.02).

Precision: convolutions run in ``COMPUTE_DTYPE`` (bf16 by default) and are
cast to fp32 before the bias; parameters, BN statistics, gradients and the
optimizer state stay fp32.  Conv weights are OIHW.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from blockcopy_tpu_torch.device import resolve_device
from blockcopy_tpu_torch.ops.layers import nchw, nhwc, resize_nearest

BN_MOMENTUM = 0.02
BN_EPS = 1e-5
COMPUTE_DTYPE = {"bf16": torch.bfloat16, "fp32": torch.float32}[
    os.environ.get("BLOCKCOPY_TPU_POLICY_COMPUTE", "bf16")]
S2D = 4  # space-to-depth factor of the fast arch's stem


# ---------------------------------------------------------------------------
# parameter initialization
# ---------------------------------------------------------------------------


class _Init:
    def __init__(self, gen: torch.Generator, device):
        self.gen, self.device = gen, device

    def _t(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def conv(self, kh, kw, cin, cout, bias=False):
        # normal(0, sqrt(2/n)), n = kh*kw*cout (reference init)
        w = torch.randn((cout, cin, kh, kw), generator=self.gen) \
            * math.sqrt(2.0 / (kh * kw * cout))
        p = {"w": self._t(w)}
        if bias:
            p["b"] = self._t(torch.zeros(cout))
        return p

    def bn(self, c):
        return {"gamma": self._t(torch.ones(c)),
                "beta": self._t(torch.zeros(c))}

    def bn_state(self, c):
        return {"mean": self._t(torch.zeros(c)), "var": self._t(torch.ones(c))}

    def basic_block(self, cin, cout, stride):
        p = {"conv1": self.conv(3, 3, cin, cout), "bn1": self.bn(cout),
             "conv2": self.conv(3, 3, cout, cout), "bn2": self.bn(cout)}
        s = {"bn1": self.bn_state(cout), "bn2": self.bn_state(cout)}
        if stride != 1 or cin != cout:
            p["down_conv"] = self.conv(1, 1, cin, cout)
            p["down_bn"] = self.bn(cout)
            s["down_bn"] = self.bn_state(cout)
        return p, s


def init_policy_net(in_channels: int, seed: int = 0, width_factor: int = 2,
                    arch: str = "ref", head_bias: float = 0.0,
                    device=None) -> Tuple[Dict, Dict]:
    """Returns ``(params, bn_state)`` on ``device`` (default CUDA).
    ``head_bias`` initialises the fast arch's logit bias (callers pass
    logit(block_target)); its logit-head weights start at zero."""
    init = _Init(torch.Generator().manual_seed(seed), resolve_device(device))
    if arch == "fast":
        c0, c1, c2 = in_channels * S2D * S2D, 128, 256
        params: Dict = {"stem": init.conv(1, 1, c0, c1),
                        "stem_bn": init.bn(c1)}
        state: Dict = {"stem_bn": init.bn_state(c1)}
        params["block1"], state["block1"] = init.basic_block(c1, c1, 1)
        params["block2"], state["block2"] = init.basic_block(c1, c2, 2)
        params["head0"] = init.conv(3, 3, c2, c2)
        params["head0_bn"] = init.bn(c2)
        state["head0_bn"] = init.bn_state(c2)
        params["head1"] = {"w": init._t(torch.zeros(1, c2, 3, 3)),
                           "b": init._t(torch.full((1,), float(head_bias)))}
        return params, state
    if arch != "ref":
        raise ValueError(f"unknown policy arch {arch!r}")
    c1, c2, c3 = 16 * width_factor, 32 * width_factor, 64 * width_factor
    params = {"conv1": init.conv(3, 3, in_channels, c1), "bn1": init.bn(c1)}
    state = {"bn1": init.bn_state(c1)}
    for i, (cin, cout, stride) in enumerate(
            [(c1, c1, 1), (c1, c2, 2), (c2, c3, 2)]):
        params[f"layer{i + 1}"], state[f"layer{i + 1}"] = \
            init.basic_block(cin, cout, stride)
    planes = 128
    params["head0"] = init.conv(3, 3, c3, planes)
    params["head0_bn"] = init.bn(planes)
    state["head0_bn"] = init.bn_state(planes)
    params["head1"] = init.conv(3, 3, planes, planes)
    params["head1_bn"] = init.bn(planes)
    state["head1_bn"] = init.bn_state(planes)
    params["head2"] = init.conv(3, 3, planes, 1, bias=True)
    return params, state


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _conv(x, p, stride=1):
    """Conv in ``COMPUTE_DTYPE``, then fp32, then the bias."""
    w = p["w"]
    pad = 1 if w.shape[2] == 3 else 0
    out = F.conv2d(nchw(x.to(COMPUTE_DTYPE)), w.to(COMPUTE_DTYPE), None,
                   stride, pad)
    out = nhwc(out).float()
    return out + p["b"] if "b" in p else out


def _bn_train(x, p, s, update_stats: bool):
    """Train-mode BatchNorm over (N, H, W); optionally the running update."""
    dims = (0, 1, 2)
    mean = x.mean(dims)
    var = x.var(dims, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + BN_EPS) * p["gamma"] + p["beta"]
    if update_stats:
        count = x.shape[0] * x.shape[1] * x.shape[2]
        unbiased = var * count / max(count - 1, 1)
        s = {"mean": (1 - BN_MOMENTUM) * s["mean"] + BN_MOMENTUM * mean,
             "var": (1 - BN_MOMENTUM) * s["var"] + BN_MOMENTUM * unbiased}
    return y, s


def _basic_block(x, p, s, stride, update_stats):
    s = dict(s)
    identity = x
    if "down_conv" in p:
        identity = _conv(x, p["down_conv"], stride)
        identity, s["down_bn"] = _bn_train(identity, p["down_bn"],
                                           s["down_bn"], update_stats)
    out = _conv(x, p["conv1"], stride)
    out, s["bn1"] = _bn_train(out, p["bn1"], s["bn1"], update_stats)
    out = torch.clamp_min(out, 0)
    out = _conv(out, p["conv2"], 1)
    out, s["bn2"] = _bn_train(out, p["bn2"], s["bn2"], update_stats)
    return torch.clamp_min(out + identity, 0), s


def _conv_stem4(x, p):
    """k=4 stride-4 conv == space-to-depth-4 + the (w, 16C, 1, 1) 1x1 conv:
    the 16C input channels unflatten in (sr, sc, c) order."""
    w = p["w"]
    c_in = x.shape[-1]
    w4 = w.reshape(w.shape[0], S2D, S2D, c_in).permute(0, 3, 1, 2)
    out = F.conv2d(nchw(x.to(COMPUTE_DTYPE)), w4.to(COMPUTE_DTYPE), None,
                   S2D)
    return nhwc(out).float()


def policy_net_apply(params, bn_state, x, update_stats: bool = True,
                     arch: str = "ref"):
    """x: (N, H/4, W/4, Cin) -> logits (N, H/bs, W/bs, 1) fp32 and the new
    ``bn_state`` (the input state when ``update_stats=False``)."""
    s = dict(bn_state)
    if arch == "fast":
        x = _conv_stem4(x, params["stem"])
        x, s["stem_bn"] = _bn_train(x, params["stem_bn"], s["stem_bn"],
                                    update_stats)
        x = torch.clamp_min(x, 0)
        x, s["block1"] = _basic_block(x, params["block1"], s["block1"], 1,
                                      update_stats)
        x, s["block2"] = _basic_block(x, params["block2"], s["block2"], 2,
                                      update_stats)
        x = _conv(x, params["head0"], 2)
        x, s["head0_bn"] = _bn_train(x, params["head0_bn"], s["head0_bn"],
                                     update_stats)
        return _conv(torch.clamp_min(x, 0), params["head1"], 2), s
    if arch != "ref":
        raise ValueError(f"unknown policy arch {arch!r}")
    x = _conv(x, params["conv1"], 1)
    x, s["bn1"] = _bn_train(x, params["bn1"], s["bn1"], update_stats)
    x = torch.clamp_min(x, 0)
    for i, stride in enumerate([1, 2, 2]):
        x, s[f"layer{i + 1}"] = _basic_block(
            x, params[f"layer{i + 1}"], s[f"layer{i + 1}"], stride,
            update_stats)
    for i in range(2):
        x = _conv(x, params[f"head{i}"], 2)
        x, s[f"head{i}_bn"] = _bn_train(x, params[f"head{i}_bn"],
                                        s[f"head{i}_bn"], update_stats)
        x = torch.clamp_min(x, 0)
    return _conv(x, params["head2"], 2), s


def assemble_policy_input(frame, frame_state, output_repr, prev_grid,
                          block_size: int, dtype=torch.float32):
    """Policy input at 1/4 * (128/block_size) scale: nearest-resized frame ++
    frame_state ++ (output_repr - 0.5) ++ (prev_grid - 0.5).  Call it under
    ``torch.no_grad()`` (not ``inference_mode``: the REINFORCE loss
    differentiates a forward over it)."""
    n, h, w, _ = frame.shape
    scale = 0.25 * 128 / block_size
    oh, ow = int(h * scale), int(w * scale)
    feats = [
        resize_nearest(frame.to(dtype), (oh, ow)),
        resize_nearest(frame_state.to(dtype), (oh, ow)),
        resize_nearest(output_repr.to(dtype), (oh, ow)) - 0.5,
        resize_nearest(prev_grid.to(dtype)[..., None], (oh, ow)) - 0.5,
    ]
    return torch.cat(feats, dim=-1)


def policy_in_channels(num_classes: int) -> int:
    return 3 + 3 + num_classes + 1
