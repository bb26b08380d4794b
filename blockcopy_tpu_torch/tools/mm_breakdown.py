"""Where the GEMM kernels' time goes, on the GPU.

    python3 -m blockcopy_tpu_torch.tools.mm_breakdown

Builds ``csrc/mm.cu`` four times, with none or some of its ablation
switches (``MM_NO_SKEW``: every k loop starts at chunk 0; ``MM_NO_PRODUCTS``:
no wgmma products; ``MM_NO_PRODUCTS`` and ``MM_NO_W``: x streams through the
ring alone), and times each build at the three shapes of ``chip_smoke.py``,
bf16 and int8, under the wrapper's launch plan, plus the full build with
single CTAs in place of the plan's 2-CTA clusters.  Device time per launch
(CUDA graph of 10 launches, median of 20 replays); int8 takes w already
transposed, so its times are the kernel's alone.  Prints one JSON line; the
outputs of the ablated builds are not checked (they are wrong by design).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from blockcopy_tpu_torch.ops.kernels import build
from blockcopy_tpu_torch.ops.kernels import mm as MM
from blockcopy_tpu_torch.tools.measure import device_ms

VARIANTS = {"full": [], "no_skew": ["-DMM_NO_SKEW"],
            "no_products": ["-DMM_NO_PRODUCTS"],
            "x_alone": ["-DMM_NO_PRODUCTS", "-DMM_NO_W"]}
SHAPES = [(16384, 2304, 256), (16384, 1152, 128), (4096, 2304, 256)]


def _build_variants():
    out = build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out / f"mm-{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [*build._compile_cmd("mm", lib), *flags],
            stdout=subprocess.DEVNULL))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {name}")
        libs[name] = ctypes.CDLL(str(lib))
        for fn in (libs[name].mm_bf16, libs[name].mm_int8):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("mm_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    libs = _build_variants()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator("cuda").manual_seed(0)
    rows_out = []
    for rows, k, n in SHAPES:
        ops = {
            "bf16": (torch.randn((rows, k), generator=gen, device="cuda")
                     .to(torch.bfloat16),
                     torch.randn((k, n), generator=gen, device="cuda")
                     .to(torch.bfloat16), torch.bfloat16, torch.float32),
            "int8": (torch.randint(-128, 128, (rows, k), generator=gen,
                                   device="cuda", dtype=torch.int8),
                     torch.randint(-128, 128, (n, k), generator=gen,
                                   device="cuda", dtype=torch.int8),
                     torch.int32, torch.int32),
        }
        for kind, (x, w, out_dtype, acc_dtype) in ops.items():
            p = MM.plan(rows, k, n, sms, x.element_size())
            y = torch.empty((rows, n), dtype=out_dtype, device="cuda")
            ws = torch.empty((p.splits, rows, n), dtype=acc_dtype,
                             device="cuda")
            name = "mm_" + kind

            def launch(lib, cluster):
                err = getattr(lib, name)(
                    x.data_ptr(), w.data_ptr(), y.data_ptr(), ws.data_ptr(),
                    rows, k, n, p.bn, cluster, p.splits,
                    torch.cuda.current_stream().cuda_stream)
                build.check(err, name)

            t = {var: device_ms(lambda lib=lib: launch(lib, p.cluster),
                                samples=20) * 1e3
                 for var, lib in libs.items()}
            t["single_ctas"] = device_ms(
                lambda: launch(libs["full"], 1), samples=20) * 1e3
            x_bytes = rows * k * x.element_size()
            rows_out.append({
                "shape": [rows, k, n], "type": kind, "plan": p._asdict(),
                **{f"{var}_us": v for var, v in t.items()},
                "x_alone_tb_per_s": x_bytes / t["x_alone"] / 1e6})
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "mm_breakdown": rows_out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
