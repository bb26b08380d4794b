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
   layer3 shapes, bf16 (3e-2) and fp32 (1e-4, TF32 off); times (the weights
   are prepared by the warm-up calls, as on the main path); then the same at
   ladder mode's smallest and largest capacities, K = 8 and K = 128, with
   the time per launch beside its bound;
4. the main path at full width: SwiftNet-RN50 BlockCopy fixed-capacity step,
   1024x2048 bf16, fast policy, block 128, target 0.5 (64 of 128 blocks),
   REINFORCE every 4th frame; ``init_state``, ``first_step`` and 12 steps,
   each step under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
   fails the run); launch counts (zeroed just before ``init_state``), blocks
   per step, policy updates, ms/frame and peak memory;
5. modes: the step on the GPU against the same step on the CPU (plain
   versions) on a small RN50 clip, and the ``pallas`` halo mode (canvas
   entry point) against the ``strips`` mode, bitwise, on a small RN18 clip;
6. the probe path: the GEMM kernels ``mm_int8`` (bitwise) and ``mm_bf16``
   (one bf16 ulp, TF32 off) against their plain versions at the probe's
   default shape and the main path's two 3x3-conv GEMM shapes, with times,
   bounds, the launch plan and its CTA count, and the library call's time
   (``torch.matmul`` / ``torch._int_mm``, yardsticks the port never calls);
   then the port's probe
   (``tools/probe_int8.py``) at its defaults, launch counts zeroed just
   before it;
7. one JSON line ``{"kernels": [...]}`` and, last, the result line;
8. ladder mode, before the JSON lines: (a) ``BlockCopyModel`` built with
   ``build_policy_from_settings(default_settings())`` (block 128,
   ``rl_semseg``, target 0.5, quantum 1/16, REINFORCE every 4th frame,
   ``ref`` policy) on SwiftNet-RN50 1024x2048 bf16, 2 clips of 8 frames:
   frame 1 of a clip executes all 128 blocks, every count is on the
   capacity ladder, exactly one host sync per frame (torch's sync debug
   mode), 12 halo and 8 tail launches per executed frame (launch counts
   zeroed just before the first clip), policy updates on frames 4 and 8
   only; capacities, ms/frame and peak memory; (b) the semseg CLI
   in-process at the same width, on the ladder engine and with
   ``--speed-mode``; (c) the ladder engine on the GPU against the CPU (RN50
   256x512 fp32, 4 frames, injected draws, counts 8, 4, 6, 8) within 1e-3
   of the largest |CPU output|.

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
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor core
INT8_OPS = 1979e12              # H100 SXM dense int8 tensor core
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores

# main-path halo launches per step (bs, C), K = 64, pad 1, bf16; see the
# exchange sites in models/swiftnet.py
HALO_SHAPES = ([(32, 48)] + [(32, 64)] * 3 + [(32, 128), (16, 256),
               (8, 512)] + [(4, 512)] * 2 + [(8, 128), (16, 128), (32, 128)])
# main-path bottleneck-tail launches per step (bs, Cm, Co)
TAIL_SHAPES = [(16, 128, 512)] * 3 + [(8, 256, 1024)] * 5
N, GH, GW, K = 1, 8, 16, 64
# ladder mode's smallest and largest capacities at 1024x2048, block 128,
# quantum 1/16
LADDER_KS = (8, 128)
# (rows, k, n) of the GEMM kernels: the probe's default, then the main
# path's 3x3 convs as GEMMs (64 blocks x bs^2 rows, 9*C, C): layer2, layer3
MM_SHAPES = [(16384, 2304, 256), (16384, 1152, 128), (4096, 2304, 256)]


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
    logs = build.build(["halo", "bottleneck", "mm"])
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


def _tail_case(gen, bs, cm, co, dtype, k=K):
    from blockcopy_tpu_torch.ops.kernels.bottleneck import PIECES
    dev = "cuda"

    def rnd(*shape, scale=1.0, relu=False):
        t = torch.randn(shape, generator=gen, device=dev) * scale
        return (t.clamp_min(0) if relu else t).to(dtype)

    shapes = {"top": (k, 1, bs, cm), "bottom": (k, 1, bs, cm),
              "left": (k, bs, 1, cm), "right": (k, bs, 1, cm)}
    pieces = {nm: rnd(*shapes.get(nm, (k, 1, 1, cm)), relu=True)
              for nm in PIECES}
    return (rnd(k, bs, bs, cm, relu=True), rnd(k, bs, bs, co), pieces,
            rnd(cm, cm, 3, 3, scale=(9 * cm) ** -0.5),
            1 + rnd(cm, scale=0.1), rnd(cm, scale=0.1),
            rnd(co, cm, 1, 1, scale=cm ** -0.5),
            1 + rnd(co, scale=0.1), rnd(co, scale=0.1))


def tail_cost(bs, cm, co, itemsize, k=K):
    flops = 2 * k * bs * bs * cm * (9 * cm + co)
    elems = (k * bs * bs * (cm + 2 * co) + k * (4 * bs + 4) * cm
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
                    f"GFLOP, {nbytes / 1e6:.1f} MB); {2 * K} CTAs in "
                    f"clusters of 2")
    per_step = {key: sum(rows[s][key] for s in TAIL_SHAPES)
                for key in ("kernel", "plain", "bound")}
    by = [rows[s]["by"] for s in TAIL_SHAPES]
    per_step["by"] = max(set(by), key=by.count)
    per_step["err"] = worst
    log(f"[3] tail per main-path step ({len(TAIL_SHAPES)} launches): "
        f"kernel {per_step['kernel']:.4f} ms, plain {per_step['plain']:.4f} "
        f"ms, bound {per_step['bound']:.4f} ms")
    phase_tail_ladder(gen)
    return per_step


def phase_tail_ladder(gen):
    """K2 at ladder mode's smallest and largest capacities at 1024x2048
    (K = 8: 16 bf16 CTAs; K = 128: 256 in two waves on 132 SMs), both RN50
    shapes, bf16 and fp32: against the plain version, then the time per
    launch beside its bound (fp32 runs scalar FMA: 67 TFLOP/s)."""
    from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
    from blockcopy_tpu_torch.tools.measure import device_ms
    for k in LADDER_KS:
        for bs, cm, co in sorted(set(TAIL_SHAPES)):
            for dtype, tol, peak in ((torch.bfloat16, 3e-2, BF16_FLOPS),
                                     (torch.float32, 1e-4, FP32_FLOPS)):
                args = _tail_case(gen, bs, cm, co, dtype, k)
                ref = BT.bottleneck_tail_plain(*args)
                got = BT.bottleneck_tail(*args)
                err = (got.float() - ref.float()).abs().max().item()
                if not torch.allclose(got.float(), ref.float(), rtol=tol,
                                      atol=tol):
                    raise AssertionError(
                        f"bottleneck kernel disagrees with its plain version "
                        f"at K={k} bs={bs} {dtype}: max abs err {err:.3g}")
                flops, nbytes = tail_cost(bs, cm, co, got.element_size(), k)
                t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
                # the fp32 kernel takes tens of ms a launch: fewer samples
                reps = (50, 10) if dtype == torch.bfloat16 else (5, 1)
                ms = device_ms(lambda: BT.bottleneck_tail(*args), *reps)
                plain = device_ms(lambda: BT.bottleneck_tail_plain(*args),
                                  *reps)
                bound = max(t_ops, t_bytes) * 1e3
                ctas = 2 * k if dtype == torch.bfloat16 else k
                log(f"[3] tail K={k:3d} bs={bs} Cm={cm} Co={co} {dtype}: max "
                    f"abs err {err:.3g} (rtol and atol {tol}) ok; kernel "
                    f"{ms:.4f} ms per launch, plain {plain:.4f} ms, bound "
                    f"{bound:.4f} ms "
                    f"({'operations' if t_ops > t_bytes else 'bytes'}), "
                    f"kernel at {bound / ms:.1%} of it; {ctas} CTAs")


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
                 "bottleneck_tail": len(TAIL_SHAPES), "mm_bf16": 0,
                 "mm_int8": 0}
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


def _ladder_frame(model, frame):
    """One ``model(frame)`` with torch's sync debug mode on: returns the
    output, the number of synchronizing CUDA calls it made, and its host
    time fenced by ``synchronize``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = model(frame)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    return out, syncs, ms


def phase_ladder():
    """(a) the ladder engine at full width: ``BlockCopyModel`` with the
    CLI's default settings over 2 clips of 8 frames; launch counts are
    zeroed just before it and read just after."""
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.core.engine import BlockCopyModel
    from blockcopy_tpu_torch.core.grid import capacity_ladder
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.policy.policies import \
        build_policy_from_settings
    from blockcopy_tpu_torch.tools.measure import synthetic_frames

    torch.backends.cudnn.allow_tf32 = True
    shape, dtype, clip_len = (1, 1024, 2048, 3), torch.bfloat16, 8
    cfg = SwiftNetConfig(backbone="resnet50", num_classes=19)
    params = init_swiftnet(cfg, seed=0, dtype=dtype, device="cuda")
    # block 128, rl_semseg, target 0.5, quantum 1/16, train interval 4,
    # ref arch: the CLI's defaults
    settings = default_settings()
    model = BlockCopyModel(make_apply_fn(cfg), params, settings,
                           policy=build_policy_from_settings(settings),
                           device="cuda")
    clips = [synthetic_frames(shape, clip_len, dtype, seed=c)
             for c in range(2)]
    ladder = set(capacity_ladder(128, settings["block_quantize_number_exec"]))
    per_exec = {"halo_strips": len(HALO_SHAPES),
                "bottleneck_tail": len(TAIL_SHAPES)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    counts, ms, rows = [], [], []
    for c, clip in enumerate(clips):
        model.reset_temporal()
        for t, frame in enumerate(clip):
            before = dict(kernels.launches)
            head = model.policy.net_params["head2"]["w"].clone()
            out, syncs, frame_ms = _ladder_frame(model, frame)
            count = model.policy_meta["num_exec"]
            used = {k: kernels.launches[k] - before[k] for k in per_exec}
            trained = not torch.equal(head,
                                      model.policy.net_params["head2"]["w"])
            want = per_exec if count else {k: 0 for k in per_exec}
            rows.append((c + 1, t + 1, count, syncs, used, trained))
            counts.append(count)
            ms.append(frame_ms)
            if syncs != 1:
                raise AssertionError(f"clip {c + 1} frame {t + 1}: {syncs} "
                                     f"host syncs, expected 1")
            if used != want:
                raise AssertionError(f"clip {c + 1} frame {t + 1}: launches "
                                     f"{used}, expected {want}")
            if t == 0 and count != 128:
                raise AssertionError(f"frame 1 of clip {c + 1} executed "
                                     f"{count} of 128 blocks")
            if count and count not in ladder:
                raise AssertionError(f"count {count} is not on the ladder")
            if trained != ((t + 1) % 4 == 0):
                raise AssertionError(f"clip {c + 1} frame {t + 1}: policy "
                                     f"params changed={trained}")
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if tuple(out.shape) != (1, 256, 512, 19) or \
            not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"outputs {tuple(out.shape)} not finite")
    for row in rows:
        log(f"[8a] clip {row[0]} frame {row[1]}: {row[2]} of 128 blocks, "
            f"{row[3]} host sync, launches {row[4]}, policy trained "
            f"{row[5]}")
    steady = ms[clip_len + 2:]
    med = statistics.median(steady)
    seen = sorted(set(counts))
    log(f"[8a] RN50 1024x2048 bf16 ladder engine, 2 clips x {clip_len} "
        f"frames: capacities {seen}, launches {launches}; ms/frame (host "
        f"clock, synchronize-fenced, frames 3-{clip_len} of clip 2) median "
        f"{med:.2f}, min {min(steady):.2f}, max {max(steady):.2f}; all "
        f"{[round(x, 2) for x in ms]}; peak memory {peak:.2f} GiB")
    return launches, {"capacities": seen, "ms": med, "peak_gib": peak}


def phase_cli():
    """(b) the semseg CLI in-process at full width, on the ladder engine
    and with ``--speed-mode``; its JSON line is kept off this script's
    stdout."""
    import contextlib
    import io
    from blockcopy_tpu_torch.tasks.semseg import eval as cli

    argv = ["--synthetic", "--res", "1024", "--model-backbone", "resnet50",
            "--half", "--clip-length", "8", "--num-clips-warmup", "1",
            "--num-clips-eval", "1", "--model-checkpoint", ""]
    out = {}
    for name, extra in (("ladder", []), ("speed-mode", ["--speed-mode"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = cli.main(argv + extra)
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        ok = (line["fps"] > 0 and "Mean IoU" in line
              and line["gmacs_per_image"] > 0 and 0 < line["perc_exec"] <= 1)
        log(f"[8b] CLI {name}: {json.dumps(line)}")
        if not ok or line["fps"] != res["fps"]:
            raise AssertionError(f"CLI {name} result {line}")
        out[name] = line
    return out


def _ladder_small(device, frames, draws):
    """RN50 256x512 fp32 ladder engine (quantum 0.25: ladder {2, 4, 6, 8})
    over ``frames`` with injected draws; outputs and counts per frame."""
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.core.engine import BlockCopyModel
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    cfg = SwiftNetConfig(backbone="resnet50", num_classes=19)
    params = init_swiftnet(cfg, seed=0, device=device)
    model = BlockCopyModel(make_apply_fn(cfg), params, default_settings(
        block_quantize_number_exec=0.25), device=device)
    outs, counts = [], []
    for frame, d in zip(frames, draws):
        d = None if d is None else tuple(x.to(device) for x in d)
        outs.append(model(frame.to(device), d).float().cpu())
        counts.append(model.policy_meta["num_exec"])
    return outs, counts


def phase_ladder_modes():
    """(c) the ladder engine on the GPU against the CPU: the Bernoulli
    draws are -1 (execute) or 2 (skip), so the grids do not depend on the
    probabilities and 3, 5 and 8 blocks round to 4, 6 and 8."""
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.policy import net as policy_net
    from blockcopy_tpu_torch.tools.measure import synthetic_frames
    policy_net.COMPUTE_DTYPE = torch.float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    frames = synthetic_frames((1, 256, 512, 3), 4, torch.float32, seed=2)
    gen = torch.Generator().manual_seed(4)
    draws = [None]
    for n_exec in (3, 5, 8):
        u = torch.full((8,), 2.0)
        u[torch.randperm(8, generator=gen)[:n_exec]] = -1.0
        draws.append((u.view(1, 2, 4), torch.rand((8,), generator=gen)))
    kernels.reset_launches()
    gpu, counts = _ladder_small("cuda", frames, draws)
    used = dict(kernels.launches)
    cpu, cpu_counts = _ladder_small("cpu", frames, draws)
    err = rel_err(gpu, cpu)
    log(f"[8c] RN50 256x512 fp32 ladder engine, 4 frames, counts {counts} "
        f"(CPU {cpu_counts}), GPU (kernels {used}) vs CPU (plain "
        f"versions): max abs err / max |CPU output| {err:.3g} (tol 1e-3)")
    torch.backends.cudnn.deterministic = False
    policy_net.COMPUTE_DTYPE = torch.bfloat16
    if (err > 1e-3 or counts != cpu_counts or len(set(counts)) < 2
            or not used["halo_strips"] or not used["bottleneck_tail"]):
        raise AssertionError("GPU ladder engine disagrees with the CPU")
    return err


def mm_cost(rows, k, n, itemsize, out_itemsize, peak):
    """Operations and the bound of one GEMM launch (each input read once,
    the output written once): (ms, "bytes" or "operations")."""
    ops = 2 * rows * k * n
    nbytes = (rows * k + k * n) * itemsize + rows * n * out_itemsize
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def phase_mm(gen):
    """K3 against its plain versions at ``MM_SHAPES`` with times; returns
    each kernel's row at the probe's default shape (``MM_SHAPES[0]``)."""
    from blockcopy_tpu_torch.ops.kernels import mm as MM
    from blockcopy_tpu_torch.tools.measure import device_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows_out, err = {}, {"mm_bf16": 0.0, "mm_int8": 0.0}
    for rows, k, n in MM_SHAPES:
        xb = torch.randn((rows, k), generator=gen, device=dev).to(
            torch.bfloat16)
        wb = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        ints = dict(generator=gen, device=dev, dtype=torch.int8)
        xi = torch.randint(-128, 128, (rows, k), **ints)
        wi = torch.randint(-128, 128, (k, n), **ints)
        got, ref = MM.mm_bf16(xb, wb).float(), MM.mm_bf16_plain(xb, wb).float()
        e_bf = (got - ref).abs().max().item()
        ok_bf = torch.allclose(got, ref, rtol=2 ** -7, atol=1e-3)
        got, ref = MM.mm_int8(xi, wi), MM.mm_int8_plain(xi, wi)
        e_i8 = (got - ref).abs().max().item()
        ok_i8 = torch.equal(got, ref)
        log(f"[6] mm {rows}x{k}x{n}: bf16 max abs err {e_bf:.3g} (rtol 2^-7, "
            f"atol 1e-3) ok={ok_bf}; int8 max abs err {e_i8} (bitwise) "
            f"ok={ok_i8}")
        if not (ok_bf and ok_i8):
            raise AssertionError("GEMM kernel disagrees with its plain "
                                 "version")
        err["mm_bf16"] = max(err["mm_bf16"], e_bf)
        err["mm_int8"] = max(err["mm_int8"], e_i8)
        cases = {
            "mm_bf16": (MM.mm_bf16, MM.mm_bf16_plain, torch.matmul, xb, wb,
                        mm_cost(rows, k, n, 2, 2, BF16_FLOPS)),
            "mm_int8": (MM.mm_int8, MM.mm_int8_plain, torch._int_mm, xi, wi,
                        mm_cost(rows, k, n, 1, 4, INT8_OPS)),
        }
        for name, (fn, plain, lib, x, w, (bound, by)) in cases.items():
            t = {"ms": device_ms(lambda: fn(x, w)),
                 "plain_ms": device_ms(lambda: plain(x, w)),
                 "library_ms": device_ms(lambda: lib(x, w)),
                 "bound_ms": bound, "bound_by": by}
            p = MM.plan(rows, k, n, sms, x.element_size())
            ctas = rows // MM.ROW_TILE * -(-n // p.bn) * p.splits
            log(f"[6] {name} {rows}x{k}x{n}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
                f"bound {bound:.4f} ms ({by}); kernel at "
                f"{bound / t['ms']:.1%} of its bound; {ctas} CTAs on {sms} "
                f"SMs ({p})")
            if (rows, k, n) == MM_SHAPES[0]:
                rows_out[name] = t
    for name, t in rows_out.items():
        t["max_abs_err"] = err[name]
    return rows_out


def phase_probe():
    """The port's probe at its defaults; launch counts are zeroed just
    before it and read just after."""
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tools import probe_int8
    kernels.reset_launches()
    out = probe_int8.main([])
    launches = {k: kernels.launches[k] for k in ("mm_bf16", "mm_int8")}
    log(f"[6] probe_int8 at its defaults: {json.dumps(out)}; launches "
        f"{launches} (wrapper calls: warm-ups and graph captures)")
    if not all(launches.values()) or out["int8_over_bf16"] <= 0:
        raise AssertionError(f"probe did not run both kernels: {launches}")
    return launches


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
    mm = phase_mm(gen)
    probe_launches = phase_probe()
    ladder_launches, ladder = phase_ladder()
    cli = phase_cli()
    ladder_err = phase_ladder_modes()

    source = "blockcopy_tpu_torch/csrc/"
    common = {"route": "cuda", "library_ms": None, "matched": True}
    kern = [
        {"name": "halo_gather_strips", "source": source + "halo.cu",
         "replaces": "blockcopy_tpu/ops/pallas/halo.py:68",
         "path": "main, ladder", "launches": launches["halo_strips"],
         "ladder_launches": ladder_launches["halo_strips"],
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
         "path": "main, ladder", "launches": launches["bottleneck_tail"],
         "ladder_launches": ladder_launches["bottleneck_tail"],
         "max_abs_err": tail["err"], "ms": tail["kernel"],
         "plain_ms": tail["plain"], "bound_ms": tail["bound"],
         "bound_by": tail["by"], **common},
    ] + [
        {"name": name, "source": source + "mm.cu",
         "replaces": "tools/probe_int8.py:38", "path": "probe_int8",
         "launches": probe_launches[name], "route": "cuda", "matched": True,
         **mm[name]}
        for name in ("mm_bf16", "mm_int8")]
    log(f"[7] halo and tail times are per main-path frame (sums over its "
        f"launch shapes), their library_ms null: no single PyTorch call "
        f"computes either function; mm times are per launch at "
        f"{'x'.join(map(str, MM_SHAPES[0]))}; main path {step_ms:.2f} "
        f"ms/frame; ladder path {ladder['ms']:.2f} ms/frame at capacities "
        f"{ladder['capacities']}, peak {ladder['peak_gib']:.2f} GiB; CLI fps "
        f"ladder {cli['ladder']['fps']:.2f}, speed-mode "
        f"{cli['speed-mode']['fps']:.2f}; ladder GPU vs CPU {ladder_err:.3g}; "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
