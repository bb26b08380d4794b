#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``blockcopy_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. card and build: ``nvidia-smi`` name and power limit, then the kernels of
   ``blockcopy_tpu_torch/csrc`` built in parallel, with the build seconds;
2. halo kernel (both entry points) against its plain versions, bitwise, at
   every main-path shape, bf16 and fp32, pad 1 and 3, on a partial grid with
   padding slots; times at the main-path shapes;
3. bottleneck-tail kernel against its plain version at the RN50 layer2 and
   layer3 shapes, bf16 (3e-2) and fp32 (1e-4, TF32 off); times;
4. the main path at full width: SwiftNet-RN50 BlockCopy fixed-capacity step,
   1024x2048 bf16, fast policy, block 128, target 0.5 (64 of 128 blocks),
   REINFORCE every 4th frame; ``init_state``, ``first_step`` and 12 steps,
   each step under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
   fails the run); launch counts (zeroed just before ``init_state``), blocks
   per step, policy updates, ms/frame and peak memory;
5. modes: the step on the GPU against the same step on the CPU (plain
   versions) on a small RN50 clip, and the ``pallas`` halo mode (canvas
   entry point) against the ``strips`` mode, bitwise, on a small RN18 clip;
6. one JSON line ``{"kernels": [...]}`` and, last, the result line.

It needs one CUDA GPU and the repository around it: without either it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor core

# main-path halo launches per step (bs, C), K = 64, pad 1, bf16; see the
# exchange sites in models/swiftnet.py
HALO_SHAPES = ([(32, 48)] + [(32, 64)] * 3 + [(32, 128), (16, 256),
               (8, 512)] + [(4, 512)] * 2 + [(8, 128), (16, 128), (32, 128)])
# main-path bottleneck-tail launches per step (bs, Cm, Co)
TAIL_SHAPES = [(16, 128, 512)] * 3 + [(8, 256, 1024)] * 5
N, GH, GW, K = 1, 8, 16, 64


def log(*a):
    print(*a, flush=True)


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"[1] card: {smi}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    from blockcopy_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    logs = build.build(["halo", "bottleneck"])
    log(f"[1] kernels built in {time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", out)]
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                                out))
        log(f"[1] {name}.cu: {len(regs)} kernels, at most "
            f"{max(regs, default=0)} registers a thread, {spill} B spilled")
    return smi


def _halo_case(gen, bs, c, p, dtype, n_set):
    from blockcopy_tpu_torch.core import grid as G
    dev = "cuda"
    total = N * GH * GW
    canvas = torch.randn((total + 1, bs, bs, c), generator=gen,
                         device=dev).to(dtype)
    canvas[-1] = 0
    strips = {"rows": torch.cat([canvas[:, :p], canvas[:, -p:]], 1)
              .contiguous(),
              "cols": torch.cat([canvas[:, :, :p], canvas[:, :, -p:]], 2)
              .contiguous()}
    order = torch.randperm(total, generator=gen, device=dev)
    grid = torch.zeros(total, dtype=torch.bool, device=dev)
    grid[order[:n_set]] = True
    idx = G.exec_indices(grid.view(N, GH, GW), K)
    center = torch.randn((K, bs, bs, c), generator=gen, device=dev).to(dtype)
    return canvas, strips, idx, center


def halo_bytes(bs, c, p, itemsize):
    interior = K * bs * bs * c
    halo = K * (4 * p * bs + 4 * p * p) * c
    out = K * (bs + 2 * p) ** 2 * c
    return (interior + halo + out) * itemsize + 8 * K


def phase_halo(gen):
    from blockcopy_tpu_torch.ops.kernels import halo as H
    from blockcopy_tpu_torch.tools.measure import device_ms
    ok, err = True, 0.0
    for bs, c in sorted(set(HALO_SHAPES)):
        for dtype in (torch.bfloat16, torch.float32):
            for p in (1, 3):
                if p >= bs:
                    continue
                canvas, strips, idx, center = _halo_case(gen, bs, c, p,
                                                         dtype, K - 4)
                ref = H.halo_gather_canvas_plain(canvas, idx, p, N, GH, GW,
                                                 center)
                ref_s = H.halo_gather_strips_plain(strips, idx, p, N, GH, GW,
                                                   center)
                a = H.halo_gather_canvas(canvas, idx, p, N, GH, GW, center)
                b = H.halo_gather_strips(strips, idx, p, N, GH, GW, center)
                same = (torch.equal(a, ref) and torch.equal(b, ref)
                        and torch.equal(ref_s, ref))
                ok &= same
                err = max([err] + [(t.float() - ref.float()).abs().max()
                                   .item() for t in (a, b)])
                if not same:
                    log(f"[2] MISMATCH halo bs={bs} C={c} p={p} {dtype}")
    log(f"[2] halo kernel bitwise == plain at {len(set(HALO_SHAPES))} "
        f"shapes x bf16/fp32 x pad 1/3 (partial grid, 4 padding slots): {ok}")
    if not ok:
        raise AssertionError("halo kernel disagrees with its plain version")

    rows = {}
    for bs, c in sorted(set(HALO_SHAPES)):
        canvas, strips, idx, center = _halo_case(gen, bs, c, 1,
                                                 torch.bfloat16, K)
        args = (idx, 1, N, GH, GW, center)
        t = {
            "canvas": device_ms(
                lambda: H.halo_gather_canvas(canvas, *args)),
            "strips": device_ms(
                lambda: H.halo_gather_strips(strips, *args)),
            "canvas_plain": device_ms(
                lambda: H.halo_gather_canvas_plain(canvas, *args)),
            "strips_plain": device_ms(
                lambda: H.halo_gather_strips_plain(strips, *args)),
            "bound": halo_bytes(bs, c, 1, 2) / HBM_BYTES_PER_S * 1e3,
        }
        rows[(bs, c)] = t
        log(f"[2] halo bs={bs:2d} C={c:3d} bf16 K={K}: "
            f"strips {t['strips']:.4f} ms (plain {t['strips_plain']:.4f}), "
            f"canvas {t['canvas']:.4f} ms (plain {t['canvas_plain']:.4f}), "
            f"bound {t['bound']:.4f} ms (bytes)")
    per_step = {key: sum(rows[s][key] for s in HALO_SHAPES)
                for key in ("canvas", "strips", "canvas_plain",
                            "strips_plain", "bound")}
    log(f"[2] halo per main-path step ({len(HALO_SHAPES)} launches): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in per_step.items()))
    per_step["err"] = err
    return per_step


def _tail_case(gen, bs, cm, co, dtype):
    from blockcopy_tpu_torch.ops.kernels.bottleneck import PIECES
    dev = "cuda"

    def rnd(*shape, scale=1.0, relu=False):
        t = torch.randn(shape, generator=gen, device=dev) * scale
        return (t.clamp_min(0) if relu else t).to(dtype)

    shapes = {"top": (K, 1, bs, cm), "bottom": (K, 1, bs, cm),
              "left": (K, bs, 1, cm), "right": (K, bs, 1, cm)}
    pieces = {nm: rnd(*shapes.get(nm, (K, 1, 1, cm)), relu=True)
              for nm in PIECES}
    return (rnd(K, bs, bs, cm, relu=True), rnd(K, bs, bs, co), pieces,
            rnd(cm, cm, 3, 3, scale=(9 * cm) ** -0.5),
            1 + rnd(cm, scale=0.1), rnd(cm, scale=0.1),
            rnd(co, cm, 1, 1, scale=cm ** -0.5),
            1 + rnd(co, scale=0.1), rnd(co, scale=0.1))


def tail_cost(bs, cm, co, itemsize):
    flops = 2 * K * bs * bs * cm * (9 * cm + co)
    elems = (K * bs * bs * (cm + 2 * co) + K * (4 * bs + 4) * cm
             + 9 * cm * cm + cm * co + 2 * cm + 2 * co)
    return flops, elems * itemsize


def phase_tail(gen):
    from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
    from blockcopy_tpu_torch.tools.measure import device_ms
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, worst = {}, 0.0
    for bs, cm, co in sorted(set(TAIL_SHAPES)):
        for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
            args = _tail_case(gen, bs, cm, co, dtype)
            ref = BT.bottleneck_tail_plain(*args)
            got = BT.bottleneck_tail(*args)
            err = (got.float() - ref.float()).abs().max().item()
            close = torch.allclose(got.float(), ref.float(), rtol=tol,
                                   atol=tol)
            log(f"[3] tail bs={bs} Cm={cm} Co={co} {dtype}: max abs err "
                f"{err:.3g} (tol {tol}) ok={close}")
            if not close:
                raise AssertionError("bottleneck kernel disagrees with its "
                                     "plain version")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
                flops, nbytes = tail_cost(bs, cm, co, 2)
                t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
                t = {"kernel": device_ms(lambda: BT.bottleneck_tail(*args)),
                     "plain": device_ms(
                         lambda: BT.bottleneck_tail_plain(*args)),
                     "bound": max(t_ops, t_bytes) * 1e3,
                     "by": "operations" if t_ops > t_bytes else "bytes"}
                rows[(bs, cm, co)] = t
                log(f"[3] tail bs={bs} Cm={cm} Co={co} bf16 K={K}: kernel "
                    f"{t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, bound "
                    f"{t['bound']:.4f} ms ({t['by']}; {flops / 1e9:.2f} "
                    f"GFLOP, {nbytes / 1e6:.1f} MB)")
    per_step = {key: sum(rows[s][key] for s in TAIL_SHAPES)
                for key in ("kernel", "plain", "bound")}
    by = [rows[s]["by"] for s in TAIL_SHAPES]
    per_step["by"] = max(set(by), key=by.count)
    per_step["err"] = worst
    log(f"[3] tail per main-path step ({len(TAIL_SHAPES)} launches): "
        f"kernel {per_step['kernel']:.4f} ms, plain {per_step['plain']:.4f} "
        f"ms, bound {per_step['bound']:.4f} ms")
    return per_step


def phase_main():
    """The main path at full width; launch counts are zeroed just before
    ``init_state`` and read after the last step."""
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tools.measure import (swiftnet_stepper,
                                                   synthetic_frames)

    torch.backends.cudnn.allow_tf32 = True
    frame_shape, steps, dtype = (1, 1024, 2048, 3), 12, torch.bfloat16
    capacity = int(round(0.5 * (1024 // 128) * (2048 // 128)))
    params, stepper = swiftnet_stepper("resnet50", frame_shape, capacity,
                                       dtype, "cuda", train_interval=4)
    frames = synthetic_frames(frame_shape, steps + 1, dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    t0 = time.perf_counter()
    state = stepper.init_state(params, seed=1)
    built = dict(kernels.launches)
    state = stepper.first_step(params, state, frames[0])
    torch.cuda.synchronize()
    first = {k: v - built[k] for k, v in kernels.launches.items()}
    log(f"[4] init_state + first_step {time.perf_counter() - t0:.2f} s "
        f"(capacity {capacity} of {stepper.total}); launches: init_state "
        f"{built}, first_step {first}")
    ms, executed, heads, frame_ids = [], [], [], []
    for t in range(1, steps + 1):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = stepper.step(params, state, frames[t])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        executed.append(state["prev_grid"].sum())
        heads.append(state["policy"]["params"]["head1"]["w"].clone())
        frame_ids.append(state["frame_idx"])
    launches = dict(kernels.launches)
    out = stepper.fetch_outputs(state)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    if tuple(out.shape) != (1, 256, 512, 19):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("non-finite outputs")
    blocks = [int(e.item()) for e in executed]
    if any(b != capacity for b in blocks):
        raise AssertionError(f"executed blocks per step {blocks}")
    per_frame = {"halo_strips": len(HALO_SHAPES), "halo_canvas": 0,
                 "bottleneck_tail": len(TAIL_SHAPES)}
    want = {k: v * (steps + 1) for k, v in per_frame.items()}
    if (any(built.values()) or first != per_frame or launches != want):
        raise AssertionError(f"launch counts {launches}, expected {want}")
    trained = []
    for i in range(1, len(heads)):
        changed = not torch.equal(heads[i], heads[i - 1])
        if changed != (frame_ids[i] % 4 == 0):
            raise AssertionError(
                f"policy params changed={changed} at frame {frame_ids[i]}")
        if changed:
            trained.append(frame_ids[i])
    steady = ms[2:]
    med = statistics.median(steady)
    log(f"[4] RN50 1024x2048 bf16: {steps} steps, no host sync, "
        f"{blocks[0]} blocks/step, outputs {tuple(out.shape)} finite, "
        f"policy updated at frames {trained}")
    log(f"[4] launches over first_step + {steps} steps: {launches} "
        f"(per frame: halo {len(HALO_SHAPES)}, bottleneck tail "
        f"{len(TAIL_SHAPES)})")
    log(f"[4] ms/frame (host clock, synchronize-fenced, steps 3-{steps}): "
        f"median {med:.2f}, min {min(steady):.2f}, max {max(steady):.2f}; "
        f"all {[round(x, 2) for x in ms]}; peak memory {peak:.2f} GiB")
    return launches, med


def _small_run(backbone, device, steps=2, halo="strips", plane_stem=True):
    """A 256x512 fp32 clip (capacity 4, REINFORCE every 2nd frame) with
    injected draws; returns the outputs of every frame on the CPU."""
    from blockcopy_tpu_torch.core import blocked
    from blockcopy_tpu_torch.ops import layers
    from blockcopy_tpu_torch.tools.measure import (swiftnet_stepper,
                                                   synthetic_frames)
    old = blocked.HALO_IMPL, layers.STEM_PLANE_POOL
    blocked.HALO_IMPL, layers.STEM_PLANE_POOL = halo, plane_stem
    try:
        shape = (1, 256, 512, 3)
        params, stepper = swiftnet_stepper(backbone, shape, 4, torch.float32,
                                           device, train_interval=2)
        gen = torch.Generator().manual_seed(3)
        # made on the card, so the CPU run gets the same frames
        frames = [f.to(device) for f in synthetic_frames(shape, steps + 1,
                                                         torch.float32)]
        draws = [(torch.rand((1, 2, 4), generator=gen).to(device),
                  torch.rand((8,), generator=gen).to(device))
                 for _ in range(steps)]
        state = stepper.init_state(params, seed=1)
        state = stepper.first_step(params, state, frames[0])
        outs = [state["outputs"]]
        for t in range(steps):
            state = stepper.step(params, state, frames[t + 1],
                                 draws=draws[t])
            outs.append(state["outputs"])
        return [o.float().cpu() for o in outs]
    finally:
        blocked.HALO_IMPL, layers.STEM_PLANE_POOL = old


def rel_err(got, ref):
    """Largest abs difference over frames, relative to the largest |ref|."""
    return max((a - b).abs().max().item() / b.abs().max().item()
               for a, b in zip(got, ref))


def phase_modes():
    """The port's step on the GPU against the same step on the CPU (plain
    versions), and the ``pallas`` halo mode against ``strips``."""
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.policy import net as policy_net
    # fp32 policy convs: a bf16 probability rounded differently on the two
    # devices could land on the other side of an injected draw
    policy_net.COMPUTE_DTYPE = torch.float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True

    kernels.reset_launches()
    gpu = _small_run("resnet50", "cuda")
    used = dict(kernels.launches)
    cpu = _small_run("resnet50", "cpu")
    err = rel_err(gpu, cpu)
    log(f"[5] RN50 256x512 fp32 capacity 4, 3 frames, GPU (kernels {used}) "
        f"vs CPU (plain versions): max abs err / max |CPU output| {err:.3g} "
        f"(tol 1e-3: a 3-frame clip with one RMSprop step)")
    if err > 1e-3 or not used["halo_strips"] or not used["bottleneck_tail"]:
        raise AssertionError("GPU step disagrees with the CPU step")

    # the s2d plane stem runs under strip halos only, so both runs take the
    # dense-form stem: then only the halo assembly differs
    kernels.reset_launches()
    pallas = _small_run("resnet18", "cuda", halo="pallas", plane_stem=False)
    canvas_launches = kernels.launches["halo_canvas"]
    strips = _small_run("resnet18", "cuda", plane_stem=False)
    bitwise = all(torch.equal(a, b) for a, b in zip(pallas, strips))
    log(f"[5] 'pallas' halo mode, RN18 256x512 fp32 capacity 4, 3 frames: "
        f"{canvas_launches} canvas-entry launches; == 'strips' mode "
        f"bitwise: {bitwise}")
    if not canvas_launches or not bitwise:
        raise AssertionError("pallas halo mode disagrees")
    torch.backends.cudnn.deterministic = False
    policy_net.COMPUTE_DTYPE = torch.bfloat16
    return canvas_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "blockcopy_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "blockcopy_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    smi = phase_card()
    gen = torch.Generator("cuda").manual_seed(0)
    halo = phase_halo(gen)
    tail = phase_tail(gen)
    launches, step_ms = phase_main()
    canvas_launches = phase_modes()

    source = "blockcopy_tpu_torch/csrc/"
    common = {"route": "cuda", "library_ms": None, "matched": True}
    kern = [
        {"name": "halo_gather_strips", "source": source + "halo.cu",
         "replaces": "blockcopy_tpu/ops/pallas/halo.py:68",
         "path": "main", "launches": launches["halo_strips"],
         "max_abs_err": halo["err"], "ms": halo["strips"],
         "plain_ms": halo["strips_plain"], "bound_ms": halo["bound"],
         "bound_by": "bytes", **common},
        {"name": "halo_gather_canvas", "source": source + "halo.cu",
         "replaces": "blockcopy_tpu/ops/pallas/halo.py:68",
         "path": "pallas halo mode", "launches": canvas_launches,
         "max_abs_err": halo["err"], "ms": halo["canvas"],
         "plain_ms": halo["canvas_plain"], "bound_ms": halo["bound"],
         "bound_by": "bytes", **common},
        {"name": "bottleneck_tail", "source": source + "bottleneck.cu",
         "replaces": "blockcopy_tpu/ops/pallas/bottleneck.py:92",
         "path": "main", "launches": launches["bottleneck_tail"],
         "max_abs_err": tail["err"], "ms": tail["kernel"],
         "plain_ms": tail["plain"], "bound_ms": tail["bound"],
         "bound_by": tail["by"], **common},
    ]
    log(f"[6] times are per main-path frame (sums over its launch shapes); "
        f"library_ms null: no single PyTorch call computes either function; "
        f"main path {step_ms:.2f} ms/frame; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
