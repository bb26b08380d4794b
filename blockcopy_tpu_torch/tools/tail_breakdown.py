"""Where the bottleneck-tail kernel's time goes, on the GPU.

    python3 -m blockcopy_tpu_torch.tools.tail_breakdown

Builds ``csrc/bottleneck.cu`` three more times with its ablation switches
(``TAIL_NO_1X1_STAGE``: stop once h2 is built and exchanged;
``TAIL_NO_3X3_PRODUCTS``: drop the 3x3 conv's products but keep its fragment
loads, barriers and epilogue), times each build at the main path's two
shapes (bf16, 64 blocks) as device time per launch (CUDA graph of 10
launches, median of 30 replays), and prints one JSON line with the parts:

* ``3x3_products``  = full - no 3x3 products;
* ``1x1_stage``     = full - no 1x1 stage;
* ``rest``          = the tile fill, w2 chunk loads, barriers, 3x3 epilogue
  and the exchange of h2 between the block's two CTAs.

The variants are written to ``_build/ablation/``; the outputs of a variant
are not checked (they are wrong by design).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
from blockcopy_tpu_torch.ops.kernels import build
from blockcopy_tpu_torch.tools.measure import device_ms

VARIANTS = {"full": [], "no_1x1_stage": ["-DTAIL_NO_1X1_STAGE"],
            "no_3x3_products": ["-DTAIL_NO_3X3_PRODUCTS"]}
SHAPES = [(16, 128, 512), (8, 256, 1024)]   # RN50 layer2, layer3
K = 64


def _build_variants():
    out = build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out / f"bottleneck-{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [*build._compile_cmd("bottleneck", lib), *flags]))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {name}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].bottleneck_tail.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    return libs


def _inputs(bs, cm, co, gen):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    shapes = {"top": (K, 1, bs, cm), "bottom": (K, 1, bs, cm),
              "left": (K, bs, 1, cm), "right": (K, bs, 1, cm)}
    pieces = [rnd(*shapes.get(n, (K, 1, 1, cm))) for n in BT.PIECES]
    tensors = [rnd(K, bs, bs, cm), rnd(K, bs, bs, co), *pieces,
               rnd(3, 3, cm, cm), rnd(co, cm), rnd(cm), rnd(cm), rnd(co),
               rnd(co), torch.empty((K, bs, bs, co), dtype=torch.bfloat16,
                                    device="cuda")]
    return tensors, (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() for t in tensors])


def main() -> int:
    if not torch.cuda.is_available():
        print("tail_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    libs = _build_variants()
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for bs, cm, co in SHAPES:
        tensors, ptrs = _inputs(bs, cm, co, gen)
        t = {}
        for name, lib in libs.items():
            def launch(lib=lib):
                err = lib.bottleneck_tail(
                    ptrs, None, K, bs, cm, co, 1,
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                build.check(err, f"bottleneck_tail ({name})")
            t[name] = device_ms(launch, samples=30) * 1e3
        rows.append({
            "bs": bs, "cm": cm, "co": co, "full_us": t["full"],
            "3x3_products_us": t["full"] - t["no_3x3_products"],
            "1x1_stage_us": t["full"] - t["no_1x1_stage"],
            "rest_us": t["no_1x1_stage"] - (t["full"]
                                            - t["no_3x3_products"]),
        })
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "tail_breakdown": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
