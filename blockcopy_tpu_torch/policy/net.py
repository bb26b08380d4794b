"""Policy network (counterpart of ``blockcopy_tpu/policy/net.py``).

Two architectures: ``ref`` (CIFAR-style ResNet-8 trunk + 3-layer strided
head, the reference PolicyNet) and ``fast`` (space-to-depth-4 stem as one
k4s4 conv, two basic blocks, 2-layer head).  The net always runs in train
mode: BatchNorm normalises with batch statistics (biased variance) and
updates running statistics (unbiased variance, momentum 0.02).

Precision: convolutions run in ``COMPUTE_DTYPE`` (bf16 by default) on
channels-last tensors; BatchNorm reads their outputs as they are, takes
fp32 statistics and computes its affine, the residual and the ReLU in fp32,
and writes the next convolution's input in ``COMPUTE_DTYPE`` (and fp32
only where a residual reads it later); the last conv's output is cast to
fp32 before the bias.  Parameters, BN statistics, gradients and the
optimizer state stay fp32.  Conv weights are OIHW.

Each BatchNorm, with the ReLU and residual after it, is
``ops/kernels/policy.py`` ``bn_train``: on CUDA two launches forward
(statistics, apply) and two backward; on the CPU its plain version.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from blockcopy_tpu_torch.device import resolve_device
from blockcopy_tpu_torch.ops.kernels.policy import bn_train
from blockcopy_tpu_torch.ops.layers import nchw, nhwc, resize_nearest

BN_MOMENTUM = 0.02
BN_EPS = 1e-5
COMPUTE_DTYPE = {"bf16": torch.bfloat16, "fp32": torch.float32}[
    os.environ.get("BLOCKCOPY_TPU_POLICY_COMPUTE", "bf16")]
S2D = 4  # space-to-depth factor of the fast arch's stem
# The fast arch's stem forms (``net.py:91-108``), read when the net runs.
# POLICY_STEM_CONV4 (default on): one k4s4 conv; off, an explicit
# space-to-depth and the 1x1 conv.  POLICY_SPLIT_STEM (default off; taken
# by the stepper with the fast arch and the conv4 stem): the four policy
# input sources stay apart and the stem is the sum of their convs.
POLICY_STEM_CONV4 = os.environ.get(
    "BLOCKCOPY_TPU_POLICY_STEM_CONV4", "1") == "1"
POLICY_SPLIT_STEM = os.environ.get(
    "BLOCKCOPY_TPU_POLICY_SPLIT_STEM", "0") == "1"


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


class _WeightCast(torch.autograd.Function):
    """A conv weight in ``dtype``, channels-last, as cuDNN takes it with a
    channels-last input (else it copies the weight itself); its gradient
    comes back as an fp32 contiguous tensor, as the parameter is."""

    @staticmethod
    def forward(ctx, w, dtype):
        return w.to(dtype=dtype, memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        return g.to(dtype=torch.float32,
                    memory_format=torch.contiguous_format), None


def _conv(x, p, stride=1):
    """Conv in ``COMPUTE_DTYPE`` on channels-last tensors: its NHWC output
    in that dtype (no bias)."""
    w = p["w"]
    pad = 1 if w.shape[2] == 3 else 0
    out = F.conv2d(nchw(x.to(COMPUTE_DTYPE)),
                   _WeightCast.apply(w, COMPUTE_DTYPE), None, stride, pad)
    return nhwc(out)


def _conv_bias(x, p, stride):
    """The last conv: ``_conv``, then fp32, then the bias."""
    return _conv(x, p, stride).float() + p["b"]


def _bn(y, p, s, update_stats: bool, relu: bool = True, residual=None,
        outs: str = "c"):
    """Train-mode BatchNorm of conv output ``y`` over (N, H, W), then the
    residual and the ReLU: the outputs ``outs`` names
    (``ops/kernels/policy.py`` ``OUTS``) and the running statistics,
    updated where ``update_stats``."""
    out, (mean, var) = bn_train(
        y, p["gamma"], p["beta"], s["mean"], s["var"],
        update_stats=update_stats, relu=relu, residual=residual, outs=outs,
        dtype_c=COMPUTE_DTYPE, eps=BN_EPS, momentum=BN_MOMENTUM)
    return out, ({"mean": mean, "var": var} if update_stats else s)


def _feeds(p_next) -> str:
    """What a unit's output feeds: a basic block with a down conv (two
    convs), one without (a conv and the residual), else a head conv."""
    if p_next is None:
        return "c"
    return "cc" if "down_conv" in p_next else "cf"


def _basic_block(xs, p, s, stride, update_stats, outs):
    """``xs`` is the block's input as ``_feeds(p)`` gave it; returns the
    outputs ``outs`` names and the block's BN statistics."""
    s = dict(s)
    if "down_conv" in p:
        x_down, x = xs
        (identity,), s["down_bn"] = _bn(
            _conv(x_down, p["down_conv"], stride), p["down_bn"],
            s["down_bn"], update_stats, relu=False, outs="f")
    else:
        x, identity = xs
    (h,), s["bn1"] = _bn(_conv(x, p["conv1"], stride), p["bn1"], s["bn1"],
                         update_stats)
    out, s["bn2"] = _bn(_conv(h, p["conv2"], 1), p["bn2"], s["bn2"],
                        update_stats, residual=identity, outs=outs)
    return out, s


def _conv_stem4(x, p):
    """k=4 stride-4 conv == space-to-depth-4 + the (w, 16C, 1, 1) 1x1 conv:
    the 16C input channels unflatten in (sr, sc, c) order."""
    w = p["w"]
    c_in = x.shape[-1]
    w4 = w.reshape(w.shape[0], S2D, S2D, c_in).permute(0, 3, 1, 2)
    out = F.conv2d(nchw(x.to(COMPUTE_DTYPE)), w4.to(COMPUTE_DTYPE), None,
                   S2D)
    return nhwc(out)


def _space_to_depth(x, r: int):
    n, h, w, c = x.shape
    return x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, h // r, w // r, r * r * c)


def _conv_stem4_split(xs, p):
    """``_conv_stem4`` of the four sources kept apart (``net.py:265``):
    ``xs`` is ``assemble_policy_input_split``'s (frame, frame_state,
    output_repr, prev_grid), unoffset, the grid at grid resolution.  The
    conv is linear, so it is the sum of per-source convs; the -0.5 offset
    of the outputs is a constant per channel, and the grid is constant in
    every 4x4 window, so its term is ``(g - 0.5) * sum of its taps``
    broadcast over the 8x8 stem positions of each grid cell."""
    frame_q, fs_q, out_q, grid = xs
    c_f, c_s, c_o = frame_q.shape[-1], fs_q.shape[-1], out_q.shape[-1]
    w = p["w"]
    co = w.shape[0]
    w4 = w.reshape(co, S2D, S2D, c_f + c_s + c_o + 1).permute(0, 3, 1, 2) \
        .to(COMPUTE_DTYPE)

    def part(x, lo, hi):
        return nhwc(F.conv2d(nchw(x.to(COMPUTE_DTYPE)), w4[:, lo:hi], None,
                             S2D)).float()

    y = part(frame_q, 0, c_f) + part(fs_q, c_f, c_f + c_s) \
        + part(out_q, c_f + c_s, c_f + c_s + c_o)
    y = y - 0.5 * w4[:, c_f + c_s:c_f + c_s + c_o].float().sum(dim=(1, 2, 3))
    gsum = w4[:, c_f + c_s + c_o].float().sum(dim=(1, 2))
    gterm = (grid.float() - 0.5)[..., None] * gsum
    n, gh, gw, _ = gterm.shape
    if tuple(y.shape[1:3]) != (gh * 8, gw * 8):
        raise ValueError(
            f"split stem: stem output {tuple(y.shape[1:3])} is not 8 "
            f"positions per cell of the {gh}x{gw} grid")
    gterm = gterm[:, :, None, :, None, :].expand(n, gh, 8, gw, 8, co)
    return y + gterm.reshape(n, gh * 8, gw * 8, co)


def policy_net_apply(params, bn_state, x, update_stats: bool = True,
                     arch: str = "ref"):
    """x: (N, H/4, W/4, Cin) -> logits (N, H/bs, W/bs, 1) fp32 and the new
    ``bn_state`` (the input state when ``update_stats=False``).  The fast
    arch also takes ``assemble_policy_input_split``'s tuple."""
    s = dict(bn_state)
    if arch == "fast":
        if isinstance(x, tuple):
            y = _conv_stem4_split(x, params["stem"])
        elif POLICY_STEM_CONV4:
            y = _conv_stem4(x, params["stem"])
        else:
            y = _conv(_space_to_depth(x, S2D), params["stem"], 1)
        xs, s["stem_bn"] = _bn(y, params["stem_bn"], s["stem_bn"],
                               update_stats, outs=_feeds(params["block1"]))
        xs, s["block1"] = _basic_block(xs, params["block1"], s["block1"], 1,
                                       update_stats,
                                       _feeds(params["block2"]))
        (x,), s["block2"] = _basic_block(xs, params["block2"], s["block2"],
                                         2, update_stats, "c")
        (x,), s["head0_bn"] = _bn(_conv(x, params["head0"], 2),
                                  params["head0_bn"], s["head0_bn"],
                                  update_stats)
        return _conv_bias(x, params["head1"], 2), s
    if arch != "ref":
        raise ValueError(f"unknown policy arch {arch!r}")
    xs, s["bn1"] = _bn(_conv(x, params["conv1"], 1), params["bn1"],
                       s["bn1"], update_stats, outs=_feeds(params["layer1"]))
    for i, stride in enumerate([1, 2, 2]):
        xs, s[f"layer{i + 1}"] = _basic_block(
            xs, params[f"layer{i + 1}"], s[f"layer{i + 1}"], stride,
            update_stats, _feeds(params.get(f"layer{i + 2}")))
    (x,) = xs
    for i in range(2):
        (x,), s[f"head{i}_bn"] = _bn(_conv(x, params[f"head{i}"], 2),
                                     params[f"head{i}_bn"],
                                     s[f"head{i}_bn"], update_stats)
    return _conv_bias(x, params["head2"], 2), s


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


def assemble_policy_input_split(frame, frame_state, output_repr, prev_grid,
                                block_size: int, dtype=torch.bfloat16):
    """``assemble_policy_input``'s sources as a tuple (``net.py:389``):
    resized, not concatenated and not offset (``_conv_stem4_split`` folds
    the offsets); ``prev_grid`` stays at grid resolution."""
    n, h, w, _ = frame.shape
    scale = 0.25 * 128 / block_size
    oh, ow = int(h * scale), int(w * scale)
    return (resize_nearest(frame.to(dtype), (oh, ow)),
            resize_nearest(frame_state.to(dtype), (oh, ow)),
            resize_nearest(output_repr.to(dtype), (oh, ow)),
            prev_grid)


def policy_in_channels(num_classes: int) -> int:
    return 3 + 3 + num_classes + 1
