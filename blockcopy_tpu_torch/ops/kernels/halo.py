"""Halo gather: the CUDA kernel ``csrc/halo.cu`` with its plain versions.

Replaces the Pallas kernel ``blockcopy_tpu/ops/pallas/halo.py``
(``halo_gather_pallas`` :68).  Two entry points:

* ``halo_gather_canvas`` over a full block-layout canvas
  (contract of ``blockcopy_tpu/core/blocked.py:halo_gather`` with center);
* ``halo_gather_strips`` over edge-strip storage
  (contract of ``blockcopy_tpu/core/blocked.py:halo_gather_strips``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from blockcopy_tpu_torch.core.grid import neighbor_indices
from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


def _take(src: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    # indices never exceed the sentinel row, so jnp.take's mode="clip" is
    # a plain gather here
    return src.index_select(0, i)


def halo_gather_canvas_plain(canvas, pack_idx, pad, n, gh, gw, center=None):
    """Plain version: gather ``(K, bs+2p, bs+2p, C)`` padded blocks from a
    full canvas (``blocked.py:168``)."""
    p = pad
    if p <= 0:
        raise ValueError(f"pad must be positive, got {p}")
    nbr = neighbor_indices(pack_idx, n, gh, gw)
    tl, t, tr, l, r, bl, b, br = nbr.unbind(1)
    if center is None:
        center = _take(canvas, pack_idx)
    top = _take(canvas[:, -p:], t)
    bottom = _take(canvas[:, :p], b)
    left = _take(canvas[:, :, -p:], l)
    right = _take(canvas[:, :, :p], r)
    top_left = _take(canvas[:, -p:, -p:], tl)
    top_right = _take(canvas[:, -p:, :p], tr)
    bottom_left = _take(canvas[:, :p, -p:], bl)
    bottom_right = _take(canvas[:, :p, :p], br)
    row_top = torch.cat([top_left, top, top_right], dim=2)
    row_mid = torch.cat([left, center.to(canvas.dtype), right], dim=2)
    row_bot = torch.cat([bottom_left, bottom, bottom_right], dim=2)
    return torch.cat([row_top, row_mid, row_bot], dim=1)


def gather_halo_strips(strips: Dict[str, torch.Tensor], pack_idx, pad, n, gh,
                       gw) -> Dict[str, torch.Tensor]:
    """The 8 halo pieces of every executed block from strip storage
    (``blocked.py:234``): ``top``/``bottom`` (K,p,bs,C), ``left``/``right``
    (K,bs,p,C), corners (K,p,p,C)."""
    p = pad
    rows, cols = strips["rows"], strips["cols"]
    if rows.shape[1] != 2 * p:
        raise ValueError(f"strip width {rows.shape[1] // 2} != pad {p}")
    nbr = neighbor_indices(pack_idx, n, gh, gw)
    tl, t, tr, l, r, bl, b, br = nbr.unbind(1)
    return {
        "top": _take(rows[:, p:], t),          # neighbour above: bottom rows
        "bottom": _take(rows[:, :p], b),       # neighbour below: top rows
        "left": _take(cols[:, :, p:], l),      # left neighbour: right cols
        "right": _take(cols[:, :, :p], r),     # right neighbour: left cols
        "top_left": _take(rows[:, p:, -p:], tl),
        "top_right": _take(rows[:, p:, :p], tr),
        "bottom_left": _take(rows[:, :p, -p:], bl),
        "bottom_right": _take(rows[:, :p, :p], br),
    }


def halo_gather_strips_plain(strips, pack_idx, pad, n, gh, gw, center):
    """Plain version: assemble padded blocks from strip storage
    (``blocked.py:263``); same result as ``halo_gather_canvas_plain``."""
    h = gather_halo_strips(strips, pack_idx, pad, n, gh, gw)
    row_top = torch.cat([h["top_left"], h["top"], h["top_right"]], dim=2)
    row_mid = torch.cat([h["left"], center, h["right"]], dim=2)
    row_bot = torch.cat([h["bottom_left"], h["bottom"], h["bottom_right"]],
                        dim=2)
    return torch.cat([row_top, row_mid, row_bot], dim=1)


def _check(name: str, t: torch.Tensor, dtype, device, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _prepare(src: torch.Tensor, pack_idx, center, pad):
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"halo kernel needs CUDA tensors, got {dev}")
    if src.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {src.dtype}")
    if pad <= 0:
        raise ValueError(f"pad must be positive, got {pad}")
    k, bs, bs2, c = center.shape
    if bs != bs2:
        raise ValueError(f"center blocks must be square, got {center.shape}")
    _check("center", center, src.dtype, dev)
    _check("idx", pack_idx, torch.int64, dev, (k,))
    out = torch.empty((k, bs + 2 * pad, bs + 2 * pad, c), dtype=src.dtype,
                      device=dev)
    return out, k, bs, c * src.element_size()


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _lib():
    lib = build.library("halo")
    if not getattr(lib, "_typed", False):
        ints = [ctypes.c_int] * 7
        lib.halo_gather_canvas.argtypes = [ctypes.c_void_p] * 4 + ints + [
            ctypes.c_void_p]
        lib.halo_gather_strips.argtypes = [ctypes.c_void_p] * 5 + ints + [
            ctypes.c_void_p]
        lib.halo_gather_canvas.restype = ctypes.c_int
        lib.halo_gather_strips.restype = ctypes.c_int
        lib._typed = True
    return lib


def halo_gather_canvas(canvas, pack_idx, pad, n, gh, gw, center):
    """Padded blocks ``(K, bs+2p, bs+2p, C)`` from a full canvas
    ``(N*GH*GW+1, bs, bs, C)``; output dtype is the canvas dtype."""
    if canvas.device.type == "cpu":
        return halo_gather_canvas_plain(canvas, pack_idx, pad, n, gh, gw,
                                        center=center)
    out, k, bs, c_bytes = _prepare(canvas, pack_idx, center, pad)
    total = n * gh * gw
    _check("canvas", canvas, canvas.dtype, canvas.device,
           (total + 1, bs, bs, center.shape[-1]))
    err = _lib().halo_gather_canvas(
        _ptr(out), _ptr(canvas), _ptr(center), _ptr(pack_idx), k, bs,
        c_bytes, pad, n, gh, gw, _stream())
    build.check(err, "halo_gather_canvas")
    kernels.launches["halo_canvas"] += 1
    return out


def halo_gather_strips(strips, pack_idx, pad, n, gh, gw, center):
    """Padded blocks ``(K, bs+2p, bs+2p, C)`` from strip storage
    ``rows (T+1, 2p, bs, C)`` / ``cols (T+1, bs, 2p, C)``."""
    rows, cols = strips["rows"], strips["cols"]
    if rows.device.type == "cpu":
        return halo_gather_strips_plain(strips, pack_idx, pad, n, gh, gw,
                                        center)
    out, k, bs, c_bytes = _prepare(rows, pack_idx, center, pad)
    total, c = n * gh * gw, center.shape[-1]
    _check("rows", rows, rows.dtype, rows.device, (total + 1, 2 * pad, bs, c))
    _check("cols", cols, rows.dtype, rows.device, (total + 1, bs, 2 * pad, c))
    err = _lib().halo_gather_strips(
        _ptr(out), _ptr(rows), _ptr(cols), _ptr(center), _ptr(pack_idx), k,
        bs, c_bytes, pad, n, gh, gw, _stream())
    build.check(err, "halo_gather_strips")
    kernels.launches["halo_strips"] += 1
    return out
