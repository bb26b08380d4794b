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
"""

from __future__ import annotations

import ctypes

import torch

from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import build

ROW_TILE = 128                                     # rows of a CTA tile
MMA_K = {torch.bfloat16: 16, torch.int8: 32}       # mma depth, elements
MMA_N = 8


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
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
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
            out_dtype: torch.dtype) -> torch.Tensor:
    for t in (x, w):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("mm operands must be contiguous and 16-byte "
                             "aligned")
    rows, k = x.shape
    y = torch.empty((rows, n), dtype=out_dtype, device=x.device)
    err = getattr(_lib(), name)(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, k, n,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, name)
    kernels.launches[name] += 1
    return y


def mm_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (rows, k) bf16 @ w (k, n) bf16 -> (rows, n) bf16, fp32
    accumulation."""
    _check(x, w, torch.bfloat16)
    if x.device.type == "cpu":
        return mm_bf16_plain(x, w)
    return _launch("mm_bf16", x, w, w.shape[1], torch.bfloat16)


def mm_int8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (rows, k) int8 @ w (k, n) int8 -> (rows, n) int32, exact.  The
    kernel reads w transposed to (n, k): the copy is made here, inside the
    call (``csrc/mm.cu`` says why)."""
    _check(x, w, torch.int8)
    if x.device.type == "cpu":
        return mm_int8_plain(x, w)
    return _launch("mm_int8", x, w.t().contiguous(), w.shape[1], torch.int32)
