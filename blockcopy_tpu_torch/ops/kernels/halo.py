"""Halo gather: the CUDA kernel ``csrc/halo.cu`` with its plain versions.

Replaces the Pallas kernel ``blockcopy_tpu/ops/pallas/halo.py``
(``halo_gather_pallas`` :68).  Three entry points:

* ``halo_gather_canvas`` over a full block-layout canvas
  (contract of ``blockcopy_tpu/core/blocked.py:halo_gather`` with center);
* ``halo_gather_strips`` over edge-strip storage
  (contract of ``blockcopy_tpu/core/blocked.py:halo_gather_strips``);
* ``halo_pieces``, the 8 pieces unassembled from edge-strip storage
  (contract of ``blockcopy_tpu/core/blocked.py:gather_halo_strips``).

The first two launch over the plan of ``halo_plan``: each padded output row
is three contiguous source segments, the rows are cut into pieces and the
pieces into equal shares, one a CTA, as many as the card's SM count asks.

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

# the assembled gather's plan (csrc/halo.cu gather_kernel): pieces of a
# padded row at most PIECE_MAX bytes, cut finer (not below PIECE_MIN) where a
# launch has fewer pieces than the card has SMs; CTAS_PER_SM shares an SM; a
# ring of at most RING_BYTES of piece buffers and GATHER_THREADS slots a CTA
# (the kernel's kGatherThreads; its entry refuses a deeper ring).  PIECE_MAX,
# CTAS_PER_SM and RING_BYTES gave the best per-frame sums of chip_smoke.py
# halo_frames' sweep on the H100
PIECE_MAX = 4096
PIECE_MIN = 2048
CTAS_PER_SM = 6
RING_BYTES = 24 * 1024
GATHER_THREADS = 64


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


def gather_halo_strips_plain(strips: Dict[str, torch.Tensor], pack_idx, pad,
                             n, gh, gw) -> Dict[str, torch.Tensor]:
    """Plain version of ``halo_pieces``: the 8 halo pieces of every executed
    block from strip storage (``blocked.py:234``): ``top``/``bottom``
    (K,p,bs,C), ``left``/``right`` (K,bs,p,C), corners (K,p,p,C)."""
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
    h = gather_halo_strips_plain(strips, pack_idx, pad, n, gh, gw)
    row_top = torch.cat([h["top_left"], h["top"], h["top_right"]], dim=2)
    row_mid = torch.cat([h["left"], center, h["right"]], dim=2)
    row_bot = torch.cat([h["bottom_left"], h["bottom"], h["bottom_right"]],
                        dim=2)
    return torch.cat([row_top, row_mid, row_bot], dim=1)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def halo_plan(k: int, bs: int, c_bytes: int, p: int, sms: int) -> Dict:
    """The launch plan of ``halo_gather_strips`` / ``halo_gather_canvas`` for
    ``k`` blocks of ``bs`` pixels, ``c_bytes`` bytes a pixel, pad ``p``, on a
    card of ``sms`` SMs.  The launch's ``k (bs+2p)`` padded rows are each cut
    into ``cuts`` pieces of ``piece`` bytes (the last of a row shorter), and
    the ``pieces`` pieces, row-major, into shares of ``share`` consecutive
    pieces, one a CTA (``ctas``).  ``depth`` is the CTA's ring of piece
    buffers (0 where ``c_bytes`` is no multiple of 16 and the kernel copies
    4- or 2-byte units instead), ``span`` the most blocks a share touches,
    ``smem`` the CTA's shared memory in bytes.  The C entry checks the plan
    and refuses one that leaves a row uncovered or does not fit."""
    w = bs + 2 * p
    row, rows = w * c_bytes, k * w
    if rows <= 0:
        return {"cuts": 1, "piece": 16, "share": 1, "ctas": 0, "depth": 0,
                "span": 0, "smem": 0, "pieces": 0}
    unit = 16 if c_bytes % 16 == 0 else 4 if c_bytes % 4 == 0 else 2
    units = row // unit
    cuts = _ceil(row, PIECE_MAX)
    if rows * cuts < sms:
        cuts = max(cuts, min(_ceil(sms, rows), row // PIECE_MIN))
    piece = _ceil(units, min(cuts, units)) * unit
    cuts = _ceil(row, piece)
    pieces = rows * cuts
    share = _ceil(pieces, CTAS_PER_SM * sms)
    depth = (min(share, max(1, RING_BYTES // piece), GATHER_THREADS)
             if unit == 16 else 0)
    span = min(k, ((share - 1) // cuts + 1) // w + 2)
    return {"cuts": cuts, "piece": piece, "share": share,
            "ctas": _ceil(pieces, share), "depth": depth, "span": span,
            "smem": depth * piece + 8 * depth + 64 * span, "pieces": pieces}


def _plan_args(k, bs, c_bytes, p, device) -> list:
    plan = halo_plan(k, bs, c_bytes, p, kernels.sms(device))
    return [plan[key] for key in ("cuts", "piece", "share", "ctas", "depth",
                                  "span")]


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
        plan = [ctypes.c_int] * 6
        lib.halo_gather_canvas.argtypes = [ctypes.c_void_p] * 4 + ints \
            + plan + [ctypes.c_void_p]
        lib.halo_gather_strips.argtypes = [ctypes.c_void_p] * 5 + ints \
            + plan + [ctypes.c_void_p]
        lib.halo_pieces.argtypes = [ctypes.c_void_p] * 4 + ints + [
            ctypes.c_void_p]
        lib.halo_gather_canvas.restype = ctypes.c_int
        lib.halo_gather_strips.restype = ctypes.c_int
        lib.halo_pieces.restype = ctypes.c_int
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
        c_bytes, pad, n, gh, gw,
        *_plan_args(k, bs, c_bytes, pad, canvas.device), _stream())
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
        bs, c_bytes, pad, n, gh, gw,
        *_plan_args(k, bs, c_bytes, pad, rows.device), _stream())
    build.check(err, "halo_gather_strips")
    kernels.launches["halo_strips"] += 1
    return out


PIECES = ("top", "bottom", "left", "right", "top_left", "top_right",
          "bottom_left", "bottom_right")


def halo_pieces(strips, pack_idx, pad, n, gh,
                gw) -> Dict[str, torch.Tensor]:
    """The 8 halo pieces of every executed block from strip storage in one
    launch: ``top``/``bottom`` (K,p,bs,C), ``left``/``right`` (K,bs,p,C),
    corners (K,p,p,C), in the strips' dtype.  The pieces are contiguous,
    16-byte aligned views of one buffer."""
    rows, cols = strips["rows"], strips["cols"]
    if rows.device.type in ("cpu", "meta"):
        return gather_halo_strips_plain(strips, pack_idx, pad, n, gh, gw)
    dev, dt, p = rows.device, rows.dtype, pad
    if dev.type != "cuda":
        raise ValueError(f"halo kernel needs CUDA tensors, got {dev}")
    if dt not in _DTYPES:
        raise ValueError(f"unsupported dtype {dt}")
    if p <= 0:
        raise ValueError(f"pad must be positive, got {p}")
    total, bs, c = n * gh * gw, rows.shape[2], rows.shape[-1]
    k = pack_idx.shape[0]
    _check("rows", rows, dt, dev, (total + 1, 2 * p, bs, c))
    _check("cols", cols, dt, dev, (total + 1, bs, 2 * p, c))
    _check("idx", pack_idx, torch.int64, dev, (k,))
    shapes = [(k, p, bs, c)] * 2 + [(k, bs, p, c)] * 2 + [(k, p, p, c)] * 4
    align = 16 // rows.element_size()
    starts, end = [], 0
    for shape in shapes:
        starts.append(end)
        end += -(-(k * shape[1] * shape[2] * c) // align) * align
    buf = torch.empty(end, dtype=dt, device=dev)
    out = {name: buf[o:o + k * s[1] * s[2] * c].view(s)
           for name, o, s in zip(PIECES, starts, shapes)}
    ptrs = (ctypes.c_void_p * 8)(*[out[name].data_ptr() for name in PIECES])
    err = _lib().halo_pieces(ptrs, _ptr(rows), _ptr(cols), _ptr(pack_idx), k,
                             bs, c * rows.element_size(), p, n, gh, gw,
                             _stream())
    build.check(err, "halo_pieces")
    kernels.launches["halo_pieces"] += 1
    return out
