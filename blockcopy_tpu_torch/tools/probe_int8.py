"""Rate probe: int8 against bf16 matrix products at the blocked-conv GEMM
shape, on the card, through the port's kernels ``mm_int8`` and ``mm_bf16``.

    python3 -m blockcopy_tpu_torch.tools.probe_int8 [--rows 16384 --k 2304
        --n 256 --chunk 1024 --frames 30 --windows 6]

The counterpart of the JAX package's ``tools/probe_int8.py``, with its flags,
defaults, operands and JSON line (``shape``, ``bf16_tflops``, ``int8_tops``,
``int8_over_bf16``): rows = K*bs*bs, k = 9*C, n = C is the im2col'd 3x3 conv
of the blocked RN50 layer2/3 tail; ``flops = 2*rows*k*n``; each variant's
rate is the best of ``windows`` windows of ``frames`` products, and both are
measured twice, interleaved.  ``--chunk`` has no counterpart in the CUDA
tiling; rows must still be a multiple of it, as the JAX grid needs.

A launch through ctypes costs the host about as long as one product takes
the card, so a window of eager launches would time the host: each window
replays ``frames`` launches captured in one CUDA graph, between CUDA events.
It runs on CUDA and raises where CUDA is absent.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import torch

from blockcopy_tpu_torch.device import resolve_device
from blockcopy_tpu_torch.ops.kernels.mm import mm_bf16, mm_int8
from blockcopy_tpu_torch.tools.measure import device_times


def report(rows: int, k: int, n: int, fps_bf16: float,
           fps_int8: float) -> Dict:
    """The JSON line from the two rates in products per second."""
    flops = 2.0 * rows * k * n
    return {
        "shape": [rows, k, n],
        "bf16_tflops": round(flops * fps_bf16 / 1e12, 1),
        "int8_tops": round(flops * fps_int8 / 1e12, 1),
        "int8_over_bf16": round(fps_int8 / fps_bf16, 3),
    }


def bench(fn, x, w, frames: int, windows: int) -> float:
    """Products per second of the best window."""
    return 1e3 / min(device_times(lambda: fn(x, w), windows, frames))


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--k", type=int, default=2304)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--windows", type=int, default=6)
    args = ap.parse_args(argv)
    if args.rows % args.chunk:
        raise ValueError(f"rows {args.rows} is not a multiple of chunk "
                         f"{args.chunk}")

    dev = resolve_device()
    gen = torch.Generator(dev).manual_seed(0)
    xk, kn = (args.rows, args.k), (args.k, args.n)
    xb = torch.randn(xk, generator=gen, device=dev).to(torch.bfloat16)
    wb = torch.randn(kn, generator=gen, device=dev).to(torch.bfloat16)
    ints = dict(generator=gen, device=dev, dtype=torch.int8)
    xi = torch.randint(-127, 128, xk, **ints)
    wi = torch.randint(-127, 128, kn, **ints)

    r_bf = bench(mm_bf16, xb, wb, args.frames, args.windows)
    r_i8 = bench(mm_int8, xi, wi, args.frames, args.windows)
    # interleave once more for fairness
    r_bf = max(r_bf, bench(mm_bf16, xb, wb, args.frames, args.windows))
    r_i8 = max(r_i8, bench(mm_int8, xi, wi, args.frames, args.windows))

    out = report(args.rows, args.k, args.n, r_bf, r_i8)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
