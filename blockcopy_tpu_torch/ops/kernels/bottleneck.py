"""Fused bottleneck tail: the CUDA kernel ``csrc/bottleneck.cu`` with its
plain version.

Replaces the Pallas kernel ``blockcopy_tpu/ops/pallas/bottleneck.py``
(``bottleneck_tail`` :92):

    y = relu(bn3(conv1x1(relu(bn2(conv3x3(pad(h1)))))) + x)

with the padded 3x3 input built from ``h1`` and the 8 halo pieces of
``ExecCtx.exchange_pieces`` at pad 1.  A CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import build

PIECES = ("top", "bottom", "left", "right", "top_left", "top_right",
          "bottom_left", "bottom_right")
MAX_SMEM = 232_448  # dynamic shared memory one CTA may use on sm_90


def _padded(h1: torch.Tensor, pieces: Dict[str, torch.Tensor]) -> torch.Tensor:
    dt = h1.dtype
    c = {name: pieces[name].to(dt) for name in PIECES}
    top = torch.cat([c["top_left"], c["top"], c["top_right"]], dim=2)
    mid = torch.cat([c["left"], h1, c["right"]], dim=2)
    bot = torch.cat([c["bottom_left"], c["bottom"], c["bottom_right"]], dim=2)
    return torch.cat([top, mid, bot], dim=1)            # (K, bs+2, bs+2, Cm)


def bottleneck_tail_plain(h1, x, pieces, w2, s2, b2, w3, s3, b3):
    """Plain version with the kernel's cast order (``bottleneck.py:82-89``):
    fp32 accumulation, cast to the activation dtype, BN multiply and add
    each in that dtype, ReLU; ``w2`` (Cm, Cm, 3, 3), ``w3`` (Co, Cm, 1, 1)."""
    dt = h1.dtype
    full = _padded(h1, pieces).permute(0, 3, 1, 2).float()
    acc = F.conv2d(full, w2.to(dt).float())              # fp32 accumulation
    h2 = acc.permute(0, 2, 3, 1).to(dt) * s2.to(dt) + b2.to(dt)
    h2 = torch.clamp_min(h2, 0)
    y = torch.matmul(h2.float(), w3.to(dt)[:, :, 0, 0].t().float())
    y = y.to(dt) * s3.to(dt) + b3.to(dt)
    y = y + x.to(dt)
    return torch.clamp_min(y, 0)


def _lib():
    lib = build.library("bottleneck")
    if not getattr(lib, "_typed", False):
        lib.bottleneck_tail.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.bottleneck_tail.restype = ctypes.c_int
        lib.bottleneck_tail_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.bottleneck_tail_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _expect(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"{dtype} on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def bottleneck_tail(h1, x, pieces, w2, s2, b2, w3, s3, b3):
    """Fused tail.  ``h1`` (K, bs, bs, Cm) post-conv1 activations, ``x``
    (K, bs, bs, Co) identity, ``pieces`` the 8 halo pieces at pad 1,
    ``w2`` (Cm, Cm, 3, 3), ``w3`` (Co, Cm, 1, 1), BN folded (C,).  Output
    (K, bs, bs, Co) in ``h1.dtype``."""
    if h1.device.type == "cpu":
        return bottleneck_tail_plain(h1, x, pieces, w2, s2, b2, w3, s3, b3)
    dev, dt = h1.device, h1.dtype
    if dev.type != "cuda":
        raise ValueError(f"bottleneck kernel needs CUDA tensors, got {dev}")
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {dt}")
    k, bs, _, cm = h1.shape
    co = x.shape[-1]
    if cm % 64 or co % 64 or 8 % (cm // 64):
        raise ValueError(f"needs Cm in (64, 128, 256, 512) and Co a multiple "
                         f"of 64, got {cm}, {co}")
    lib = _lib()
    smem = lib.bottleneck_tail_smem_bytes(bs, cm)
    if dt == torch.bfloat16 and smem > MAX_SMEM:
        raise ValueError(f"block {bs}x{bs}x{cm} needs {smem} B of shared "
                         f"memory, more than {MAX_SMEM}")
    x = x.to(dt).contiguous()
    piece = {name: pieces[name].to(dt).contiguous() for name in PIECES}
    w2t = w2.to(dt).permute(2, 3, 1, 0).contiguous()     # [dy][dx][ci][co]
    w3t = w3.to(dt)[:, :, 0, 0].t().contiguous()         # (Cm, Co)
    bn = [v.to(dt).contiguous() for v in (s2, b2, s3, b3)]
    shapes = {"top": (k, 1, bs, cm), "bottom": (k, 1, bs, cm),
              "left": (k, bs, 1, cm), "right": (k, bs, 1, cm)}
    _expect("h1", h1, (k, bs, bs, cm), dt, dev)
    _expect("x", x, (k, bs, bs, co), dt, dev)
    for name in PIECES:
        _expect(name, piece[name], shapes.get(name, (k, 1, 1, cm)), dt, dev)
    _expect("w2", w2t, (3, 3, cm, cm), dt, dev)
    _expect("w3", w3t, (cm, co), dt, dev)
    for name, v, c in zip(("s2", "b2", "s3", "b3"), bn, (cm, cm, co, co)):
        _expect(name, v, (c,), dt, dev)
    y = torch.empty_like(x)
    scratch = None
    if dt == torch.float32:
        scratch = torch.empty((k, bs * bs, cm), dtype=torch.float32,
                              device=dev)
    tensors = [h1, x, *(piece[name] for name in PIECES), w2t, w3t, *bn, y]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    err = lib.bottleneck_tail(
        ptrs, ctypes.c_void_p(0 if scratch is None else scratch.data_ptr()),
        k, bs, cm, co, 1 if dt == torch.bfloat16 else 0,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    build.check(err, "bottleneck_tail")
    kernels.launches["bottleneck_tail"] += 1
    return y
