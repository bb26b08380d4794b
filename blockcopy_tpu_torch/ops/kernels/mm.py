"""Tiled matrix products of the int8-vs-bf16 rate probe: the CUDA kernels
``csrc/mm.cu`` with their plain versions.

Replaces the Pallas kernel ``tools/probe_int8.py`` (``make_mm`` :38,
``_mm_kernel`` :33): ``y = x @ w`` with x (rows, k), w (k, n), as

- ``mm_bf16``: bf16 operands, fp32 accumulation, y rounded once to bf16;
- ``mm_int8``: int8 operands, int32 accumulation, y int32.

Both wrappers refuse what the kernel cannot take, on every device, so a CPU
run holds the same contract as the card: rows a multiple of ``ROW_TILE``, k a
multiple of the mma depth, n a multiple of 8, and for int8 a k small enough
that int32 cannot overflow.  Then a CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.

The launch plan (column tile, cluster, k splits) is computed here by the
pure function ``plan`` and passed to the kernel, so the CPU tests hold it.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import build

ROW_TILE = 128                                     # rows of a CTA tile
MMA_K = {torch.bfloat16: 16, torch.int8: 32}       # mma depth, elements
MMA_N = 8
CHUNK_BYTES = 128                                  # bytes of k per stage
MIN_SPLIT_CHUNKS = 4                               # chunks a k split keeps


class Plan(NamedTuple):
    """Column tile ``bn`` (CTA tiles are ``ROW_TILE`` x ``bn``), CTAs per
    cluster along rows (they share each w tile by TMA multicast), and the
    number of k splits (partial tiles summed by a second kernel)."""
    bn: int
    cluster: int
    splits: int


def plan(rows: int, k: int, n: int, sms: int, itemsize: int = 2) -> Plan:
    """The kernel's launch plan for x (rows, k) @ w (k, n) of ``itemsize``
    bytes on a card of ``sms`` SMs: 256-column tiles where n > 128 (x then
    leaves L2 once per row block at n = 256) unless they would fill at most
    half the SMs, and k split over CTAs where the tiles alone leave SMs
    idle, each split keeping at least ``MIN_SPLIT_CHUNKS`` chunks
    (4096x2304x256: 64 tiles of 128 x 128, k split 2 ways: the fastest of
    the plans timed on the H100), and 2-CTA clusters along rows (each w
    tile multicast to both) where the row blocks pair up."""
    blocks = rows // ROW_TILE
    bn = 256 if n > 128 else 128
    if bn == 256 and blocks * -(-n // bn) <= sms // 2:
        bn = 128          # twice the tiles; fewer k splits fill the card
    tiles = blocks * -(-n // bn)
    chunks = -(-k * itemsize // CHUNK_BYTES)
    splits = 1
    if tiles < sms:
        splits = max(1, min(sms // tiles, chunks // MIN_SPLIT_CHUNKS))
    return Plan(bn, 2 if blocks % 2 == 0 else 1, splits)


def split_ranges(chunks: int, splits: int) -> List[Tuple[int, int]]:
    """(first chunk, chunk count) of each k split, as the kernel cuts
    them."""
    return [(z * chunks // splits,
             (z + 1) * chunks // splits - z * chunks // splits)
            for z in range(splits)]


def mm_bf16_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 product of the bf16 operands, rounded once to bf16."""
    return (x.float() @ w.float()).to(torch.bfloat16)


def mm_int8_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 product: float64 holds every sum (|sum| <= k * 128**2 <
    2**53).  ``x @ w`` on int8 would wrap in int8 on the CPU and has no CUDA
    kernel."""
    return (x.double() @ w.double()).to(torch.int32)


def _lib():
    lib = build.library("mm")
    if not getattr(lib, "_typed", False):
        for fn in (lib.mm_bf16, lib.mm_int8):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> None:
    if x.device.type not in ("cpu", "cuda") or w.device != x.device:
        raise ValueError(f"mm needs CPU or CUDA tensors on one device, got "
                         f"{x.device} and {w.device}")
    if x.dtype != dtype or w.dtype != dtype:
        raise ValueError(f"unsupported dtype {x.dtype} @ {w.dtype}, "
                         f"expected {dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} are not "
                         f"(rows, k) @ (k, n)")
    (rows, k), n = x.shape, w.shape[1]
    if not rows or rows % ROW_TILE:
        raise ValueError(f"rows {rows} is not a multiple of {ROW_TILE}")
    if not k or k % MMA_K[dtype] or not n or n % MMA_N:
        raise ValueError(f"k {k} must be a multiple of {MMA_K[dtype]} and n "
                         f"{n} of {MMA_N}")
    if dtype == torch.int8 and k * 128 * 128 >= 2 ** 31:
        raise ValueError(f"k {k}: an int32 sum of int8 products could "
                         f"overflow")


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, n: int,
            out_dtype: torch.dtype, acc_dtype: torch.dtype) -> torch.Tensor:
    for t in (x, w):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("mm operands must be contiguous and 16-byte "
                             "aligned")
    rows, k = x.shape
    p = plan(rows, k, n, kernels.sms(x.device), x.element_size())
    y = torch.empty((rows, n), dtype=out_dtype, device=x.device)
    ws = None
    if p.splits > 1:
        ws = torch.empty((p.splits, rows, n), dtype=acc_dtype,
                         device=x.device)
    err = getattr(_lib(), name)(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), rows, k, n, p.bn, p.cluster,
        p.splits, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, name)
    kernels.launches[name] += 1
    return y


def mm_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (rows, k) bf16 @ w (k, n) bf16 -> (rows, n) bf16, fp32
    accumulation."""
    _check(x, w, torch.bfloat16)
    if x.device.type == "cpu":
        return mm_bf16_plain(x, w)
    return _launch("mm_bf16", x, w, w.shape[1], torch.bfloat16,
                   torch.float32)


def mm_int8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (rows, k) int8 @ w (k, n) int8 -> (rows, n) int32, exact.  The
    kernel reads w transposed to (n, k): the copy is made here, inside the
    call (``csrc/mm.cu`` says why)."""
    _check(x, w, torch.int8)
    if x.device.type == "cpu":
        return mm_int8_plain(x, w)
    return _launch("mm_int8", x, w.t().contiguous(), w.shape[1],
                   torch.int32, torch.int32)
