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

Then the fp32 path's row tiles: builds with ``TAIL_F32_BM=64`` and ``=32``
(every stage on 64-row or on 32-row tiles) against the library's rule
(32-row tiles where 64-row ones would not fill one wave), each timed in
fp32 at K = 8, 64 and 128 at the same shapes: ``f32_row_tiles``, us per
launch.

Then the bf16 row route (the route of every bf16 block the wgmma route
does not hold: RN50 at block 256, the wide ResNets): at RN50's three
block-256 shapes and K = 2, 16 and 32, each of its two stages' device time
(the 3x3 conv into h2, the 1x1 into y; profiler) and the launch timed with
the library's row-tile rule and with every stage on 128-row or on 64-row
tiles (builds with ``TAIL_ROWS_BM=128`` and ``=64``): ``rows_stages``, us.

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
from blockcopy_tpu_torch.tools.measure import device_ms, tail_stage_ms

VARIANTS = {"full": [], "no_1x1_stage": ["-DTAIL_NO_1X1_STAGE"],
            "no_3x3_products": ["-DTAIL_NO_3X3_PRODUCTS"],
            "f32_bm64": ["-DTAIL_F32_BM=64"], "f32_bm32": ["-DTAIL_F32_BM=32"],
            "rows_bm128": ["-DTAIL_ROWS_BM=128"],
            "rows_bm64": ["-DTAIL_ROWS_BM=64"]}
SHAPES = [(16, 128, 512), (8, 256, 1024)]   # RN50 layer2, layer3
K = 64
F32_KS = (8, 64, 128)
# RN50's fused blocks at block 256 (layer2, layer3, layer4) and the
# block-256 capacities: ladder mode's smallest, the stepper's, every block
ROW_SHAPES = [(32, 128, 512), (16, 256, 1024), (8, 512, 2048)]
ROW_KS = (2, 16, 32)


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


def _inputs(bs, cm, co, gen, k=K, dtype=torch.bfloat16):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    shapes = {"top": (k, 1, bs, cm), "bottom": (k, 1, bs, cm),
              "left": (k, bs, 1, cm), "right": (k, bs, 1, cm)}
    pieces = [rnd(*shapes.get(n, (k, 1, 1, cm))) for n in BT.PIECES]
    tensors = [rnd(k, bs, bs, cm), rnd(k, bs, bs, co), *pieces,
               rnd(3, 3, cm, cm), rnd(co, cm), rnd(cm), rnd(cm), rnd(co),
               rnd(co), torch.empty((k, bs, bs, co), dtype=dtype,
                                    device="cuda")]
    return tensors, (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() for t in tensors])


def _launch(lib, ptrs, scratch, k, bs, cm, co, dtype_code):
    """One launch of ``lib``'s C entry on the current stream."""
    return lib.bottleneck_tail(
        ptrs, scratch, k, bs, cm, co, dtype_code,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))


def _launch_us(lib, name, ptrs, scratch, k, bs, cm, co, dtype_code):
    def launch():
        build.check(_launch(lib, ptrs, scratch, k, bs, cm, co, dtype_code),
                    f"bottleneck_tail ({name})")
    return device_ms(launch, samples=30) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("tail_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    libs = _build_variants()
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for bs, cm, co in SHAPES:
        tensors, ptrs = _inputs(bs, cm, co, gen)
        t = {name: _launch_us(libs[name], name, ptrs, None, K, bs, cm, co, 1)
             for name in ("full", "no_1x1_stage", "no_3x3_products")}
        rows.append({
            "bs": bs, "cm": cm, "co": co, "full_us": t["full"],
            "3x3_products_us": t["full"] - t["no_3x3_products"],
            "1x1_stage_us": t["full"] - t["no_1x1_stage"],
            "rest_us": t["no_1x1_stage"] - (t["full"]
                                            - t["no_3x3_products"]),
        })
    tiles = []
    for k in F32_KS:
        for bs, cm, co in SHAPES:
            tensors, ptrs = _inputs(bs, cm, co, gen, k, torch.float32)
            scratch = torch.empty((k, bs * bs, cm), device="cuda")
            tiles.append({"k": k, "bs": bs, "cm": cm, "co": co, **{
                name: _launch_us(libs[lib], lib, ptrs,
                                 ctypes.c_void_p(scratch.data_ptr()), k, bs,
                                 cm, co, 0)
                for name, lib in (("rule_us", "full"), ("bm64_us", "f32_bm64"),
                                  ("bm32_us", "f32_bm32"))}})
    stages = []
    for k in ROW_KS:
        for bs, cm, co in ROW_SHAPES:
            tensors, ptrs = _inputs(bs, cm, co, gen, k)
            scratch = torch.empty((k, bs * bs, cm), dtype=torch.bfloat16,
                                  device="cuda")
            h2 = ctypes.c_void_p(scratch.data_ptr())
            part = tail_stage_ms(
                lambda: build.check(_launch(libs["full"], ptrs, h2, k, bs, cm,
                                            co, 2), "bottleneck_tail (rows)"),
                "tail_rows")
            stages.append({"k": k, "bs": bs, "cm": cm, "co": co, **{
                f"{key}_us": ms * 1e3 for key, (ms, _) in part.items()},
                "rule_bm": {key: bm for key, (_, bm) in part.items()}, **{
                name: _launch_us(libs[lib], lib, ptrs, h2, k, bs, cm, co, 2)
                for name, lib in (("rule_us", "full"),
                                  ("bm128_us", "rows_bm128"),
                                  ("bm64_us", "rows_bm64"))}})
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "tail_breakdown": rows, "f32_row_tiles": tiles,
                      "rows_stages": stages}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
