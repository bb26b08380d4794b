"""Where the bottleneck-tail kernel's time goes, on the GPU.

    python3 -m blockcopy_tpu_torch.tools.tail_breakdown

Builds ``csrc/bottleneck.cu`` once more for each of its ablation switches
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
block-256 shapes and K = 2, 16 and 32, its launch plan and the same three
builds, giving ``rows_parts`` in us per launch:

* ``3x3_products``  = full - no 3x3 products;
* ``1x1_stage``     = full - no 1x1 stage (its products, x in, the
  epilogue, y out);
* ``staging_rest``  = the band staging by cp.async, the w2 boxes' ring,
  the 3x3 epilogue and the exchange of h2 across the cluster.

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
from blockcopy_tpu_torch.tools.measure import device_ms, strip_halo

VARIANTS = {"full": [], "no_1x1_stage": ["-DTAIL_NO_1X1_STAGE"],
            "no_3x3_products": ["-DTAIL_NO_3X3_PRODUCTS"],
            "f32_bm64": ["-DTAIL_F32_BM=64"], "f32_bm32": ["-DTAIL_F32_BM=32"]}
PARTS = ("full", "no_1x1_stage", "no_3x3_products")
SHAPES = [(16, 128, 512), (8, 256, 1024)]   # RN50 layer2, layer3
K = 64
F32_KS = (8, 64, 128)
# RN50's fused blocks at block 256 (layer2, layer3, layer4) and the
# block-256 capacities: ladder mode's smallest, the stepper's, every block
ROW_SHAPES = [(32, 128, 512), (16, 256, 1024), (8, 512, 2048)]
ROW_KS = (2, 16, 32)


def build_variants(names=tuple(VARIANTS)):
    """The library built with each named variant's switches, all ``nvcc``
    processes started together."""
    out = build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        flags = VARIANTS[name]
        lib = out / f"bottleneck-{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [*build._compile_cmd("bottleneck", lib), *flags]))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {name}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].bottleneck_tail.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
    return libs


def _inputs(bs, cm, co, gen, k=K, dtype=torch.bfloat16):
    """The C entry's tensors and pointers at K blocks of the 1024x2048
    block-128 grid, its halo in strip storage (``measure.strip_halo``)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    halo = strip_halo(gen, k, bs, cm, dtype)
    tensors = [rnd(k, bs, bs, cm), rnd(k, bs, bs, co), halo.rows, halo.cols,
               halo.idx, rnd(3, 3, cm, cm), rnd(co, cm), rnd(cm), rnd(cm),
               rnd(co), rnd(co), torch.empty((k, bs, bs, co), dtype=dtype,
                                             device="cuda")]
    return tensors, (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() for t in tensors])


def _launch(lib, ptrs, scratch, k, bs, cm, co, dtype_code):
    """One launch of ``lib``'s C entry on the current stream (the grid of
    ``_inputs``)."""
    return lib.bottleneck_tail(
        ptrs, scratch, k, bs, cm, co, 1, 8, 16, dtype_code,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))


def _launch_us(lib, name, ptrs, scratch, k, bs, cm, co, dtype_code):
    def launch():
        build.check(_launch(lib, ptrs, scratch, k, bs, cm, co, dtype_code),
                    f"bottleneck_tail ({name})")
    return device_ms(launch, samples=30) * 1e3


def row_parts(libs, cases, gen):
    """The row route's plan and parts (us per launch) at each ``(k, bs, cm,
    co)`` of ``cases``, from the ``PARTS`` builds in ``libs``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for k, bs, cm, co in cases:
        tensors, ptrs = _inputs(bs, cm, co, gen, k)
        t = {name: _launch_us(libs[name], name, ptrs, None, k, bs, cm, co, 2)
             for name in PARTS}
        products = t["full"] - t["no_3x3_products"]
        out.append({"k": k, "bs": bs, "cm": cm, "co": co,
                    "plan": BT.row_plan(k, bs, cm, co, sms),
                    "full_us": t["full"], "3x3_products_us": products,
                    "1x1_stage_us": t["full"] - t["no_1x1_stage"],
                    "staging_rest_us": t["no_1x1_stage"] - products})
        del tensors
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tail_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    libs = build_variants()
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
    parts = row_parts(libs, [(k, *sh) for k in ROW_KS for sh in ROW_SHAPES],
                      gen)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "tail_breakdown": rows, "f32_row_tiles": tiles,
                      "rows_parts": parts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
