#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``blockcopy_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. card and build: ``nvidia-smi`` name and power limit, then the kernels of
   ``blockcopy_tpu_torch/csrc`` built in parallel, with the build seconds;
2. halo kernel (both entry points) against its plain versions, bitwise, at
   every main-path shape, bf16 and fp32, pad 1 and 3, on a partial grid with
   padding slots; times at the main-path shapes;
3. bottleneck-tail kernel (bf16 3e-2, fp32 1e-4 with TF32 off) against its
   plain version at the RN50 layer2 and layer3 shapes at K = 8, 64 and 128
   (ladder mode's smallest capacity, the main path's, ladder mode's
   largest): time per launch (the weights are prepared by the warm-up
   calls, as on the main path) beside its bound and the plain version's,
   each fp32 stage's device time, and the per-frame sums at K = 64;
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
   ``--speed-mode``, in bf16 (``--half``) and in fp32 (as it ships), launch
   counts zeroed just before each run; (c) the ladder engine on the GPU
   against the CPU (RN50 256x512 fp32, 4 frames, injected draws, counts 8,
   4, 6, 8) within 1e-3 of the largest |CPU output|; (d) RN50 1024x2048
   ladder frames at block 256 in bf16 and fp32 and at block 128 in fp32,
   with K2's launches per executed frame asserted (0, 10 and 8);
9. detection, before the JSON lines: (a) ``DetectionStepper`` on CSP-R50 at
   full width and depth (``CSPConfig()``), 1024x2048 bf16, fast policy,
   block 128, target 0.3 (38 of 128 blocks), REINFORCE every 4th frame,
   random weights from seed 0 (the workload of ``bench_detection.py``)
   with the ``csp_cls`` bias at 0, so that scores straddle ``score_thr``
   and decode, NMS and the IoU gain run on live boxes: ``init_state``,
   ``first_step`` and 12 steps, each under ``set_sync_debug_mode("error")``;
   38 blocks a step, finite (100, 5) dets, at least 8 valid dets a frame,
   each inside the 1024x2048 image with its score at least ``score_thr``,
   policy updates at frames 4, 8 and 12 only, and 13 K1 and 8 K2 launches a
   frame (``DET_HALO_SHAPES``, ``DET_TAIL_SHAPES``; counts zeroed just
   before ``init_state``); ms/frame, peak memory, valid dets a frame; (b) the
   detection step on the GPU against the CPU (plain versions), CSP
   ``stage_blocks=(1, 2, 2, 1)`` 256x512 fp32, capacity 4, 3 frames,
   injected draws: grids, ``valid`` and ``labels`` equal, canvases and dets
   within 1e-3; (c) at K = 38 with 3 padding slots, K1 against its plain
   version, bitwise, at every detection shape (both entry points and
   dtypes), and K2 against its plain version at every detection shape
   (bf16 3e-2, fp32 1e-4); then K1 and K2 timed there in bf16 (per-frame
   sums beside their bounds);
10. detection in ladder mode, before the JSON lines: (a) ``CSPBlockCopy``
   built by ``build_detector`` from ``configs/csp/csp_r50_clip_blockcopy_030.py``
   (CSP-R50 at full width and depth, ``rl_objectdetection``, ``ref`` policy,
   target 0.3, quantum 1/16, verbose, REINFORCE every 4th frame), 1024x2048
   bf16, the ``csp_cls`` bias 0, 2 clips of 8 frames: frame 1 of a clip
   executes all 128 blocks, every count is on the ladder, the host syncs of
   each frame are those ``_det_frame_syncs`` names (torch's sync debug
   mode), 13 K1 and 8 K2 launches per executed frame (counts zeroed just
   before the first clip), policy updates on frames 4 and 8 only, at least
   8 boxes a frame inside the image with score >= 0.1; capacities, ms/frame,
   peak memory and the host ms of painting the masks; (b) the detection
   CLI in-process (``--synthetic --res 1024 --clip-length 8``, 1 warmup and
   1 eval clip, the 0.3 config, an npz of random weights with the bias at
   0) on the ladder and with ``--speed-mode`` in bf16 and on the ladder in
   fp32: the JSON line's keys and ranges, 13 K1 and 8 K2 launches per frame
   that ran blocks (counts zeroed just before each run), no host sync in a
   speed-mode steady frame (torch's sync debug mode); (c)
   ``CSPBlockCopy`` on the GPU against the CPU, CSP ``stage_blocks=(1, 2,
   2, 1)`` 256x512 fp32, 4 frames, injected draws: counts, ``valid`` and
   labels equal, canvases and boxes within 1e-5; (d) K1 bitwise and K2
   against their plain versions at every detection shape at K = 8 and 128,
   then both timed there in bf16.

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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor core
INT8_OPS = 1979e12              # H100 SXM dense int8 tensor core
TF32_FLOPS = 495e12             # H100 SXM dense TF32 tensor core

# main-path halo launches per step (bs, C), K = 64, pad 1, bf16; see the
# exchange sites in models/swiftnet.py
HALO_SHAPES = ([(32, 48)] + [(32, 64)] * 3 + [(32, 128), (16, 256),
               (8, 512)] + [(4, 512)] * 2 + [(8, 128), (16, 128), (32, 128)])
# main-path bottleneck-tail launches per step (bs, Cm, Co)
TAIL_SHAPES = [(16, 128, 512)] * 3 + [(8, 256, 1024)] * 5
N, GH, GW, K = 1, 8, 16, 64
# detection path (phase 9) K1 launches per step (bs, C, pad) at K = 38, bf16;
# see the exchange sites in models/csp.py: the stem's s2d planes, layer1's
# three 3x3s, the strided first blocks of layer2 and layer3, layer4's three
# dilated 3x3s (pad 2), the head's fused branch conv (768 channels) and its
# three blocked final convs
DET_HALO_SHAPES = ([(32, 48, 1)] + [(32, 64, 1)] * 3
                   + [(32, 128, 1), (16, 256, 1)] + [(8, 512, 2)] * 3
                   + [(32, 768, 1)] + [(32, 256, 1)] * 3)
# its K2 launches: layer2 blocks 1-3 and layer3 blocks 1-5 (layer1 has Cm 64,
# layer4 is dilated), the semseg path's eight
DET_TAIL_SHAPES = TAIL_SHAPES
DET_K = 38
# K2's capacities: ladder mode's smallest at 1024x2048 (block 128, quantum
# 1/16), the main path's, and ladder mode's largest
TAIL_KS = (8, K, 128)
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


def _halo_case(gen, bs, c, p, dtype, n_set, k=K):
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
    idx = G.exec_indices(grid.view(N, GH, GW), k)
    center = torch.randn((k, bs, bs, c), generator=gen, device=dev).to(dtype)
    return canvas, strips, idx, center


def halo_bytes(bs, c, p, itemsize, k=K):
    interior = k * bs * bs * c
    halo = k * (4 * p * bs + 4 * p * p) * c
    out = k * (bs + 2 * p) ** 2 * c
    return (interior + halo + out) * itemsize + 8 * k


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


def _tail_stage_ms(fn, calls=20):
    """Device ms per call of each fp32 stage (``tail_f32<BM, true>``: the
    3x3 conv into h2; ``<BM, false>``: the 1x1 into y) and the row tile BM
    it ran, from the profiler's kernel records over ``calls`` calls."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"3x3": [0.0, set()], "1x1": [0.0, set()]}
    for e in prof.events():
        found = re.search(r"tail_f32<(\d+), (true|false)>", e.name)
        if e.device_type == DeviceType.CUDA and found:
            key = "3x3" if found.group(2) == "true" else "1x1"
            out[key][0] += e.time_range.elapsed_us() / 1e3 / calls
            out[key][1].add(found.group(1))
    return {key: (ms, "/".join(sorted(bm))) for key, (ms, bm) in out.items()}


def phase_tail(gen):
    """K2 at ``TAIL_KS`` x both RN50 shapes x bf16 (3e-2) and fp32 (1e-4,
    TF32 off): against the plain version (``torch.allclose``, outputs
    finite), then the time per launch beside its bound (bf16 against 989
    TFLOP/s; fp32 against its route, 3 TF32 products per product on 495
    TFLOP/s), and the fp32 stages' device times; returns the per-frame sums
    at K = 64."""
    from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
    from blockcopy_tpu_torch.tools.measure import device_ms
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, worst = {}, {"bf16": 0.0, "f32": 0.0}
    for k in TAIL_KS:
        for bs, cm, co in sorted(set(TAIL_SHAPES)):
            for name, dtype, tol, products, peak in (
                    ("bf16", torch.bfloat16, 3e-2, 1, BF16_FLOPS),
                    ("f32", torch.float32, 1e-4, 3, TF32_FLOPS)):
                args = _tail_case(gen, bs, cm, co, dtype, k)
                ref = BT.bottleneck_tail_plain(*args).float()
                got = BT.bottleneck_tail(*args)
                diff = (got.float() - ref).abs()
                err = diff.max().item()
                # the largest error as a share of allclose's bound (log only)
                share = (diff / (tol + tol * ref.abs())).max().item()
                if not (bool(torch.isfinite(got).all()) and torch.allclose(
                        got.float(), ref, rtol=tol, atol=tol)):
                    raise AssertionError(
                        f"bottleneck kernel disagrees with its plain version "
                        f"at K={k} bs={bs} {dtype}: max abs err {err:.3g}")
                worst[name] = max(worst[name], err)
                flops, nbytes = tail_cost(bs, cm, co, got.element_size(), k)
                t_ops = products * flops / peak
                t_bytes = nbytes / HBM_BYTES_PER_S
                t = {"kernel": device_ms(lambda: BT.bottleneck_tail(*args)),
                     "plain": device_ms(
                         lambda: BT.bottleneck_tail_plain(*args)),
                     "bound": max(t_ops, t_bytes) * 1e3,
                     "by": "operations" if t_ops > t_bytes else "bytes"}
                rows[(k, bs, cm, co, name)] = t
                if name == "bf16":
                    ctas = f"{2 * k} CTAs in clusters of 2"
                else:
                    stage = _tail_stage_ms(lambda: BT.bottleneck_tail(*args))
                    ctas = ", ".join(
                        f"{key} stage {ms:.4f} ms ({bm}-row tiles)"
                        for key, (ms, bm) in stage.items())
                log(f"[3] tail K={k:3d} bs={bs} Cm={cm} Co={co} {dtype}: max "
                    f"abs err {err:.3g} (rtol and atol {tol}; {share:.1%} of "
                    f"allclose's bound) ok; kernel "
                    f"{t['kernel']:.4f} ms per launch, plain "
                    f"{t['plain']:.4f} ms, bound {t['bound']:.4f} ms "
                    f"({t['by']}; {flops / 1e9:.2f} GFLOP"
                    f"{' x 3 TF32 products' if products == 3 else ''}, "
                    f"{nbytes / 1e6:.1f} MB), kernel at "
                    f"{t['bound'] / t['kernel']:.1%} of it; {ctas}")
    out = {}
    for name in ("bf16", "f32"):
        per = [rows[(K, *s, name)] for s in TAIL_SHAPES]
        per_step = {key: sum(r[key] for r in per)
                    for key in ("kernel", "plain", "bound")}
        by = [r["by"] for r in per]
        per_step["by"] = max(set(by), key=by.count)
        per_step["err"] = worst[name]
        log(f"[3] tail {name} per main-path frame at K={K} "
            f"({len(TAIL_SHAPES)} launches): kernel "
            f"{per_step['kernel']:.4f} ms, plain {per_step['plain']:.4f} ms, "
            f"bound {per_step['bound']:.4f} ms ({per_step['by']})")
        out[name] = per_step
    return out


def _drive_stepper(tag, stepper, params, frames, per_frame, watch=None):
    """``init_state``, ``first_step`` and a ``step`` per further frame, each
    step under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
    fails the run).  Launch counts are zeroed just before ``init_state`` and
    read after the last step; it checks that ``init_state`` launches
    nothing, that every frame launches ``per_frame``, that every step runs
    ``capacity`` blocks and that the policy is updated exactly at frames
    = 0 (mod 4).  ``watch(state)`` is kept after each step.  Returns the
    last state, the launches, ms per step, the trained frames, what
    ``watch`` kept and the peak memory in GiB."""
    from blockcopy_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    t0 = time.perf_counter()
    state = stepper.init_state(params, seed=1)
    built = dict(kernels.launches)
    state = stepper.first_step(params, state, frames[0])
    torch.cuda.synchronize()
    first = {k: v - built[k] for k, v in kernels.launches.items()}
    log(f"[{tag}] init_state + first_step {time.perf_counter() - t0:.2f} s "
        f"(capacity {stepper.capacity} of {stepper.total}); launches: "
        f"init_state {built}, first_step {first}")
    ms, executed, heads, frame_ids, kept = [], [], [], [], []
    for frame in frames[1:]:
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = stepper.step(params, state, frame)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        executed.append(state["prev_grid"].sum())
        heads.append(state["policy"]["params"]["head1"]["w"].clone())
        frame_ids.append(state["frame_idx"])
        if watch is not None:
            kept.append(watch(state))
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    blocks = [int(e.item()) for e in executed]
    if any(b != stepper.capacity for b in blocks):
        raise AssertionError(f"executed blocks per step {blocks}")
    want = {k: v * len(frames) for k, v in per_frame.items()}
    if any(built.values()) or first != per_frame or launches != want:
        raise AssertionError(f"launch counts {launches} (first step "
                             f"{first}), expected {want}")
    trained = []
    for i in range(1, len(heads)):
        changed = not torch.equal(heads[i], heads[i - 1])
        if changed != (frame_ids[i] % 4 == 0):
            raise AssertionError(
                f"policy params changed={changed} at frame {frame_ids[i]}")
        if changed:
            trained.append(frame_ids[i])
    return state, launches, ms, trained, kept, peak


def _log_steps(tag, ms, launches, peak):
    steady = ms[2:]
    log(f"[{tag}] launches over first_step + {len(ms)} steps: {launches}")
    log(f"[{tag}] ms/frame (host clock, synchronize-fenced, steps "
        f"3-{len(ms)}): median {statistics.median(steady):.2f}, min "
        f"{min(steady):.2f}, max {max(steady):.2f}; all "
        f"{[round(x, 2) for x in ms]}; peak memory {peak:.2f} GiB")
    return statistics.median(steady)


def phase_main():
    """The main path at full width (``_drive_stepper``)."""
    from blockcopy_tpu_torch.tools.measure import (swiftnet_stepper,
                                                   synthetic_frames)

    torch.backends.cudnn.allow_tf32 = True
    frame_shape, steps, dtype = (1, 1024, 2048, 3), 12, torch.bfloat16
    capacity = int(round(0.5 * (1024 // 128) * (2048 // 128)))
    params, stepper = swiftnet_stepper("resnet50", frame_shape, capacity,
                                       dtype, "cuda", train_interval=4)
    frames = synthetic_frames(frame_shape, steps + 1, dtype)
    per_frame = {"halo_strips": len(HALO_SHAPES), "halo_canvas": 0,
                 "bottleneck_tail": len(TAIL_SHAPES), "mm_bf16": 0,
                 "mm_int8": 0}
    state, launches, ms, trained, _, peak = _drive_stepper(
        "4", stepper, params, frames, per_frame)
    out = stepper.fetch_outputs(state)
    if tuple(out.shape) != (1, 256, 512, 19):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("non-finite outputs")
    log(f"[4] RN50 1024x2048 bf16: {steps} steps, no host sync, "
        f"{capacity} blocks/step, outputs {tuple(out.shape)} finite, "
        f"policy updated at frames {trained} (per frame: halo "
        f"{len(HALO_SHAPES)}, bottleneck tail {len(TAIL_SHAPES)})")
    return launches, _log_steps("4", ms, launches, peak)


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


def _count_syncs(fn, *args):
    """``fn(*args)`` with torch's sync debug mode on: its result and the
    number of synchronizing CUDA calls it made."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing" in str(w.message) for w in caught)


def _ladder_frame(model, frame):
    """One ``model(frame)`` under ``_count_syncs``: the output, its host
    syncs, and its host time fenced by ``synchronize``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, syncs = _count_syncs(model, frame)
    torch.cuda.synchronize()
    return out, syncs, (time.perf_counter() - t0) * 1e3


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
    and with ``--speed-mode``, in bf16 (``--half``) and as it ships, in
    fp32; launch counts are zeroed just before each run and read just
    after.  Its JSON line is kept off this script's stdout."""
    import contextlib
    import io
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tasks.semseg import eval as cli

    torch.backends.cudnn.allow_tf32 = True
    argv = ["--synthetic", "--res", "1024", "--model-backbone", "resnet50",
            "--clip-length", "8", "--num-clips-warmup", "1",
            "--num-clips-eval", "1", "--model-checkpoint", ""]
    out = {}
    for name, extra in (("ladder", ["--half"]),
                        ("speed-mode", ["--half", "--speed-mode"]),
                        ("ladder fp32", []),
                        ("speed-mode fp32", ["--speed-mode"])):
        buf = io.StringIO()
        kernels.reset_launches()
        with contextlib.redirect_stdout(buf):
            res = cli.main(argv + extra)
        launches = dict(kernels.launches)
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        ok = (line["fps"] > 0 and "Mean IoU" in line
              and line["gmacs_per_image"] > 0 and 0 < line["perc_exec"] <= 1)
        log(f"[8b] CLI {name}: {json.dumps(line)}; launches {launches}")
        if not ok or line["fps"] != res["fps"]:
            raise AssertionError(f"CLI {name} result {line}")
        # 16 frames, each executing at least 8 blocks (quantum 1/16)
        if (launches["halo_strips"] != 16 * len(HALO_SHAPES)
                or launches["bottleneck_tail"] != 16 * len(TAIL_SHAPES)):
            raise AssertionError(f"CLI {name} launches {launches}, expected "
                                 f"{len(HALO_SHAPES)} K1 and "
                                 f"{len(TAIL_SHAPES)} K2 a frame")
        line["launches"] = launches
        out[name] = line
    return out


def phase_block_sizes():
    """(d) RN50 1024x2048 ladder frames (the CLI's default settings but the
    block size) at block 256 in bf16 and fp32 and at block 128 in fp32, 4
    frames each; launch counts are zeroed just before each run and read
    just after.  K2 launches per executed frame: none at block 256 in bf16
    (the bf16 kernel takes none of its blocks, which run unfused), 10 in
    fp32 (layers 2-4: 3 + 5 + 2), 8 at block 128 (layers 2-3)."""
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.core.engine import BlockCopyModel
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tools.measure import synthetic_frames

    torch.backends.cudnn.allow_tf32 = True
    shape = (1, 1024, 2048, 3)
    cfg = SwiftNetConfig(backbone="resnet50", num_classes=19)
    out = {}
    for block, dtype, per_frame in ((256, torch.bfloat16, 0),
                                    (256, torch.float32, 10),
                                    (128, torch.float32, 8)):
        params = init_swiftnet(cfg, seed=0, dtype=dtype, device="cuda")
        model = BlockCopyModel(make_apply_fn(cfg), params,
                               default_settings(block_size=block),
                               device="cuda")
        frames = synthetic_frames(shape, 4, dtype, seed=5)
        kernels.reset_launches()
        counts, tails, ms = [], [], []
        for frame in frames:
            before = kernels.launches["bottleneck_tail"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = model(frame)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts.append(model.policy_meta["num_exec"])
            tails.append(kernels.launches["bottleneck_tail"] - before)
        launches = dict(kernels.launches)
        log(f"[8d] RN50 1024x2048 {dtype} block {block}: {len(frames)} "
            f"frames at counts {counts}, K2 launches per frame {tails}, "
            f"launches {launches}, ms/frame {[round(x, 2) for x in ms]}")
        if tuple(y.shape) != (1, 256, 512, 19) or \
                not bool(torch.isfinite(y.float()).all()):
            raise AssertionError(f"block {block} {dtype}: outputs "
                                 f"{tuple(y.shape)} not finite")
        if tails != [per_frame if c else 0 for c in counts] or not counts[0]:
            raise AssertionError(f"block {block} {dtype}: K2 launches "
                                 f"{tails}, expected {per_frame} per "
                                 f"executed frame")
        out[(block, str(dtype))] = tails
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


def phase_detection():
    """(a) the detection step at full width (``_drive_stepper``)."""
    from blockcopy_tpu_torch.tools.measure import csp_stepper, synthetic_frames

    torch.backends.cudnn.allow_tf32 = True
    frame_shape, steps, dtype = (1, 1024, 2048, 3), 12, torch.bfloat16
    capacity = int(round(0.3 * (1024 // 128) * (2048 // 128)))
    params, stepper = csp_stepper(frame_shape, capacity, dtype, "cuda")
    # at random init every score is below score_thr: a zero bias puts them
    # near 0.5, so each frame has live boxes
    params["head"]["csp_cls"]["b"].zero_()
    frames = synthetic_frames(frame_shape, steps + 1, dtype)
    per_frame = {"halo_strips": len(DET_HALO_SHAPES), "halo_canvas": 0,
                 "bottleneck_tail": len(DET_TAIL_SHAPES), "mm_bf16": 0,
                 "mm_int8": 0}
    state, launches, ms, trained, outs, peak = _drive_stepper(
        "9a", stepper, params, frames, per_frame,
        watch=lambda st: tuple(t.clone()
                               for t in stepper.fetch_outputs(st)))
    thr = stepper.csp_cfg.score_thr
    height, width = frame_shape[1:3]
    n_valid = []
    for dets, labels, valid in outs:
        if (tuple(dets.shape) != (100, 5) or tuple(labels.shape) != (100,)
                or tuple(valid.shape) != (100,)):
            raise AssertionError(f"dets {tuple(dets.shape)}, labels "
                                 f"{tuple(labels.shape)}, valid "
                                 f"{tuple(valid.shape)}")
        if not bool(torch.isfinite(dets).all()):
            raise AssertionError("non-finite dets")
        live = dets[valid].float()
        x1, y1, x2, y2, score = live.unbind(1)
        inside = bool(((x1 >= 0) & (y1 >= 0) & (x1 <= x2) & (y1 <= y2)
                       & (x2 <= width - 1) & (y2 <= height - 1)
                       & (score >= thr)).all())
        n_valid.append(len(live))
        if len(live) < 8 or not inside:
            raise AssertionError(
                f"{len(live)} valid dets in a frame, all inside the "
                f"{height}x{width} image with score >= {thr}: {inside}")
    log(f"[9a] CSP-R50 1024x2048 bf16 detection step: {steps} steps, no host "
        f"sync, {capacity} blocks/step, dets (100, 5) finite on every "
        f"frame, policy updated at frames {trained}, valid dets per frame "
        f"{n_valid}, each inside the image with score >= {thr} (random "
        f"weights, csp_cls bias 0; per frame: halo {len(DET_HALO_SHAPES)}, "
        f"bottleneck tail {len(DET_TAIL_SHAPES)})")
    med = _log_steps("9a", ms, launches, peak)
    return launches, {"ms": med, "peak_gib": peak}


def phase_detection_modes():
    """(b) the detection step on the GPU against the CPU (plain versions)."""
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.policy import net as policy_net
    from blockcopy_tpu_torch.tools.measure import (compare_clips,
                                                   detection_clip)
    policy_net.COMPUTE_DTYPE = torch.float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    kernels.reset_launches()
    gpu = detection_clip("cuda")
    used = dict(kernels.launches)
    cpu = detection_clip("cpu")
    torch.backends.cudnn.deterministic = False
    policy_net.COMPUTE_DTYPE = torch.bfloat16
    grids, canvas_err, dets_err = compare_clips(gpu, cpu)
    n_valid = [int(f["dets"][2].sum()) for f in cpu]
    log(f"[9b] CSP (1, 2, 2, 1) 256x512 fp32 capacity 4, 3 frames, GPU "
        f"(kernels {used}) vs CPU (plain versions): grids equal {grids}; "
        f"canvases max abs err / max |CPU canvas| {canvas_err:.3g}; valid and "
        f"labels equal, dets err {dets_err} (None: valid or labels differ), "
        f"valid dets per frame {n_valid}; tol 1e-3")
    if (not grids or canvas_err > 1e-3 or None in dets_err
            or max(dets_err) > 1e-3 or not used["halo_strips"]
            or not used["bottleneck_tail"]):
        raise AssertionError("GPU detection step disagrees with the CPU")
    return canvas_err, max(dets_err)


def phase_detection_kernels(gen):
    """(c) K1 bitwise against its plain version at every detection shape
    (both entry points, bf16 and fp32), and K2 against its plain version
    at every detection shape (bf16 3e-2, fp32 1e-4 with TF32 off; outputs
    finite), all at K = 38 with 3 padding slots; then both timed there in
    bf16.  Returns the per-frame sums and K2's largest errors."""
    from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
    from blockcopy_tpu_torch.ops.kernels import halo as H
    from blockcopy_tpu_torch.tools.measure import device_ms
    for bs, c, p in sorted(set(DET_HALO_SHAPES)):
        for dtype in (torch.bfloat16, torch.float32):
            canvas, strips, idx, center = _halo_case(gen, bs, c, p, dtype,
                                                     DET_K - 3, DET_K)
            args = (idx, p, N, GH, GW, center)
            ref = H.halo_gather_canvas_plain(canvas, *args)
            same = (torch.equal(H.halo_gather_canvas(canvas, *args), ref)
                    and torch.equal(H.halo_gather_strips(strips, *args), ref)
                    and torch.equal(H.halo_gather_strips_plain(strips, *args),
                                    ref))
            log(f"[9c] halo bs={bs:2d} C={c:3d} pad {p} {dtype} K={DET_K} "
                f"(3 padding slots): both entry points bitwise == plain: "
                f"{same}")
            if not same:
                raise AssertionError("halo kernel disagrees with its plain "
                                     "version at a detection shape")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tail_err = {}
    for bs, cm, co in sorted(set(DET_TAIL_SHAPES)):
        for name, dtype, tol in (("bf16", torch.bfloat16, 3e-2),
                                 ("f32", torch.float32, 1e-4)):
            args = _tail_case(gen, bs, cm, co, dtype, DET_K)
            ref = BT.bottleneck_tail_plain(*args).float()
            got = BT.bottleneck_tail(*args)
            err = (got.float() - ref).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got.float(), ref, rtol=tol, atol=tol)
            log(f"[9c] tail bs={bs} Cm={cm} Co={co} {dtype} K={DET_K}: max "
                f"abs err {err:.3g} (rtol and atol {tol}), allclose: {ok}")
            if not ok:
                raise AssertionError("bottleneck kernel disagrees with its "
                                     "plain version at a detection shape")
            tail_err[name] = max(tail_err.get(name, 0.0), err)
    halo = {}
    for bs, c, p in sorted(set(DET_HALO_SHAPES)):
        canvas, strips, idx, center = _halo_case(gen, bs, c, p,
                                                 torch.bfloat16, DET_K, DET_K)
        args = (idx, p, N, GH, GW, center)
        halo[(bs, c, p)] = {
            "ms": device_ms(lambda: H.halo_gather_strips(strips, *args)),
            "plain_ms": device_ms(
                lambda: H.halo_gather_strips_plain(strips, *args)),
            "bound_ms": halo_bytes(bs, c, p, 2, DET_K) / HBM_BYTES_PER_S
            * 1e3}
        t = halo[(bs, c, p)]
        log(f"[9c] halo strips bs={bs:2d} C={c:3d} pad {p} bf16 K={DET_K}: "
            f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f}), bound "
            f"{t['bound_ms']:.4f} ms (bytes)")
    tail = {}
    for bs, cm, co in sorted(set(DET_TAIL_SHAPES)):
        args = _tail_case(gen, bs, cm, co, torch.bfloat16, DET_K)
        flops, nbytes = tail_cost(bs, cm, co, 2, DET_K)
        t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        tail[(bs, cm, co)] = {
            "ms": device_ms(lambda: BT.bottleneck_tail(*args)),
            "plain_ms": device_ms(lambda: BT.bottleneck_tail_plain(*args)),
            "bound_ms": max(t_ops, t_bytes) * 1e3}
        t = tail[(bs, cm, co)]
        log(f"[9c] tail bs={bs} Cm={cm} Co={co} bf16 K={DET_K}: "
            f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f}), bound "
            f"{t['bound_ms']:.4f} ms "
            f"({'operations' if t_ops > t_bytes else 'bytes'})")
    out = {}
    for name, rows, shapes in (("halo", halo, DET_HALO_SHAPES),
                               ("tail", tail, DET_TAIL_SHAPES)):
        out[name] = {key: sum(rows[s][key] for s in shapes)
                     for key in ("ms", "plain_ms", "bound_ms")}
        log(f"[9c] {name} per detection frame ({len(shapes)} launches, "
            f"K={DET_K}): " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in out[name].items()))
    out["tail"]["err"] = tail_err
    return out


DET_CONFIG = ROOT / "configs" / "csp" / "csp_r50_clip_blockcopy_030.py"
# the detection ladder's capacities at 1024x2048 (block 128, quantum 1/16):
# the smallest, and frame 1's, every block
DET_LADDER_KS = (8, 128)


def _det_frame_syncs(t, count, ran, verbose):
    """Host syncs of one ``CSPBlockCopy`` frame (frame ``t`` of its clip):
    the executed-block count (``Policy._finalize``); where the policy net
    ran, its NaN guard (verbose settings only); where blocks ran, the boxes'
    one transfer (``models/csp.py`` ``fetch_dets``); on a train frame, the
    verbose print's one read of the two probabilities.  The gain's masks go
    up without one (pinned, asynchronous)."""
    trained = ran and t % 4 == 0
    return 1 + (ran and verbose) + (count > 0) + (trained and verbose)


def _det_boxes_ok(boxes, height, width, thr, least=8):
    """At least ``least`` boxes, each inside the image, score >= ``thr``."""
    b = boxes[0]
    return len(b) >= least and bool(np.all(
        (b[:, 0] >= 0) & (b[:, 1] >= 0) & (b[:, 0] <= b[:, 2])
        & (b[:, 1] <= b[:, 3]) & (b[:, 2] <= width - 1)
        & (b[:, 3] <= height - 1) & (b[:, 4] >= thr)))


def phase_detection_ladder():
    """(10a) the detection ladder at full width: ``CSPBlockCopy`` built by
    ``build_detector`` from the shipped 0.3 config, 2 clips of 8 frames;
    launch counts are zeroed just before the first clip and read just after
    the last."""
    import contextlib
    import io
    from blockcopy_tpu_torch.core.grid import capacity_ladder
    from blockcopy_tpu_torch.models.builder import build_detector
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tasks.detection import information_gain as IG
    from blockcopy_tpu_torch.tools.measure import synthetic_frames
    from blockcopy_tpu_torch.utils.registry import load_config

    torch.backends.cudnn.allow_tf32 = True
    shape, dtype, clip_len = (1, 1024, 2048, 3), torch.bfloat16, 8
    model = build_detector(load_config(str(DET_CONFIG)), dtype=dtype,
                           device="cuda")
    # at random init every score is below score_thr: a zero bias puts them
    # near 0.5, so the boxes, the masks and the gain are live
    model.params["head"]["csp_cls"]["b"].zero_()
    settings, thr = model.settings, model.cfg.score_thr
    verbose = settings["block_policy_verbose"]
    clips = [synthetic_frames(shape, clip_len, dtype, seed=c)
             for c in range(2)]
    ladder = set(capacity_ladder(128, settings["block_quantize_number_exec"]))
    per_exec = {"halo_strips": len(DET_HALO_SHAPES),
                "bottleneck_tail": len(DET_TAIL_SHAPES)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    printed = io.StringIO()           # the verbose policy's train-frame lines
    kernels.reset_launches()
    counts, ms, rows = [], [], []
    for c, clip in enumerate(clips):
        model.reset_temporal()
        for t, frame in enumerate(clip, start=1):
            before = dict(kernels.launches)
            head = model.policy.net_params["head2"]["w"].clone()
            with contextlib.redirect_stdout(printed):
                boxes, syncs, frame_ms = _ladder_frame(model, frame)
            meta = model.policy_meta
            count, ran = meta["num_exec"], meta.get("_rl_cache") is not None
            used = {k: kernels.launches[k] - before[k] for k in per_exec}
            trained = not torch.equal(head,
                                      model.policy.net_params["head2"]["w"])
            want_syncs = _det_frame_syncs(t, count, ran, verbose)
            rows.append((c + 1, t, count, syncs, used, trained, len(boxes[0])))
            counts.append(count)
            ms.append(frame_ms)
            if syncs != want_syncs:
                raise AssertionError(f"clip {c + 1} frame {t}: {syncs} host "
                                     f"syncs, expected {want_syncs}")
            if used != (per_exec if count else {k: 0 for k in per_exec}):
                raise AssertionError(f"clip {c + 1} frame {t}: launches "
                                     f"{used}, expected {per_exec} per "
                                     f"executed frame")
            if t == 1 and count != 128:
                raise AssertionError(f"frame 1 of clip {c + 1} executed "
                                     f"{count} of 128 blocks")
            if count and count not in ladder:
                raise AssertionError(f"count {count} is not on the ladder")
            if trained != (t % 4 == 0):
                raise AssertionError(f"clip {c + 1} frame {t}: policy "
                                     f"params changed={trained}")
            if not _det_boxes_ok(boxes, *shape[1:3], thr):
                raise AssertionError(f"clip {c + 1} frame {t}: "
                                     f"{len(boxes[0])} boxes, not all inside "
                                     f"the image with score >= {thr}")
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    train_lines = printed.getvalue().count("BLOCKS/running_cost")
    if verbose and train_lines != 4:
        raise AssertionError(f"{train_lines} verbose train-frame prints, "
                             f"expected 4")
    ig = model.policy_meta
    if (ig["output_repr"].device.type != "cuda"
            or ig["output_repr"].dtype != torch.float32
            or ig["information_gain"].device.type != "cuda"):
        raise AssertionError("the detection gain's tensors are not fp32 on "
                             "the card")
    # host painting of the last frame's masks at 1024x2048
    paint = {}
    for name, fn in (
            ("output_repr", lambda: IG.build_instance_mask(
                ig["outputs"], (1, 1024, 2048, 1))),
            ("gain", lambda: IG.build_instance_mask_iou_gain(
                ig["outputs"], ig["outputs_prev"], (1, 1024, 2048, 1)))):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        paint[name] = statistics.median(times)
    for row in rows:
        log(f"[10a] clip {row[0]} frame {row[1]}: {row[2]} of 128 blocks, "
            f"{row[3]} host syncs, launches {row[4]}, policy trained "
            f"{row[5]}, {row[6]} boxes")
    steady = ms[clip_len + 2:]
    med = statistics.median(steady)
    seen = sorted(set(counts))
    syncs = {"plain": _det_frame_syncs(2, 1, True, verbose),
             "train": _det_frame_syncs(4, 1, True, verbose)}
    log(f"[10a] CSP-R50 1024x2048 bf16 detection ladder ({DET_CONFIG.name}, "
        f"csp_cls bias 0), 2 clips x {clip_len} frames: capacities {seen}, "
        f"launches {launches}, host syncs a frame {syncs} (frame 1: "
        f"{_det_frame_syncs(1, 1, False, verbose)}); ms/frame (host clock, "
        f"synchronize-fenced, frames 3-{clip_len} of clip 2) median "
        f"{med:.2f}, min {min(steady):.2f}, max {max(steady):.2f}; all "
        f"{[round(x, 2) for x in ms]}; peak memory {peak:.2f} GiB; host "
        f"painting of the last frame's masks: output repr "
        f"{paint['output_repr']:.2f} ms, gain {paint['gain']:.2f} ms")
    return launches, {"capacities": seen, "ms": med, "peak_gib": peak,
                      "syncs": syncs, "paint_ms": paint}


def phase_detection_cli():
    """(10b) the detection CLI in-process at full width from the shipped
    0.3 config and an npz of random weights with the ``csp_cls`` bias at
    0: on the ladder and with ``--speed-mode`` in bf16, and on the ladder in
    fp32.  Launch counts are zeroed just before each run and read just
    after; the frames that ran blocks are counted at the engine's decode.
    Its JSON line is kept off this script's stdout."""
    import contextlib
    import io
    import tempfile
    from blockcopy_tpu_torch.models.csp import (CSPBlockCopy, CSPConfig,
                                                init_csp)
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tasks.detection import eval as cli
    from blockcopy_tpu_torch.utils.checkpoint import save_params

    torch.backends.cudnn.allow_tf32 = True
    out = {}
    executed = [0]
    decode = CSPBlockCopy._decode
    step_only, upload = cli._StepperDetector.step_only, cli.to_device
    step_syncs = []

    def counted(self, maps):
        executed[0] += 1
        return decode(self, maps)

    def watched(self, img):
        # speed mode: a steady frame (after a clip's first) makes no sync;
        # its upload is counted with it
        if self._frame_id == 0:
            return step_only(self, img)
        step_syncs[-1] += _count_syncs(step_only, self, img)[1]

    def watched_upload(a, device):
        out, syncs = _count_syncs(upload, a, device)
        step_syncs.append(syncs)
        return out

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        params = init_csp(CSPConfig(), seed=0, device="cuda")
        params["head"]["csp_cls"]["b"].zero_()
        ckpt = str(Path(tmp) / "csp_r50_bias0.npz")
        save_params(ckpt, params)
        del params
        argv = ["--synthetic", "--res", "1024", "--clip-length", "8",
                "--num-clips-warmup", "1", "--num-clips-eval", "1",
                "--config", str(DET_CONFIG), "--checkpoint", ckpt]
        CSPBlockCopy._decode = counted
        cli._StepperDetector.step_only = watched
        try:
            for name, extra in (("ladder", ["--half"]),
                                ("speed-mode", ["--half", "--speed-mode"]),
                                ("ladder fp32", [])):
                buf = io.StringIO()
                executed[0] = 0
                speed = "--speed-mode" in extra
                cli.to_device = watched_upload if speed else upload
                kernels.reset_launches()
                with contextlib.redirect_stdout(buf):
                    res = cli.main(argv + extra)
                launches = dict(kernels.launches)
                frames = 16 if speed else executed[0]
                line = json.loads(buf.getvalue().strip().splitlines()[-1])
                mrs = [line[k] for k in line if k.startswith("MR_")]
                ok = (len(mrs) == 4 and line["fps"] > 0
                      and line["gmacs_per_image"] > 0
                      and 0 < line["perc_exec"] <= 1
                      and line["block_target"] == 0.3
                      and all(0 <= m <= 100 or m == -1 for m in mrs)
                      and line["fps"] == res["fps"])
                log(f"[10b] detection CLI {name}: {json.dumps(line)}; "
                    f"launches {launches}, frames that ran blocks {frames}")
                if not ok:
                    raise AssertionError(f"detection CLI {name} result "
                                         f"{line}")
                if (frames < 2
                        or launches["halo_strips"]
                        != frames * len(DET_HALO_SHAPES)
                        or launches["bottleneck_tail"]
                        != frames * len(DET_TAIL_SHAPES)):
                    raise AssertionError(
                        f"detection CLI {name} launches {launches} over "
                        f"{frames} frames, expected {len(DET_HALO_SHAPES)} "
                        f"K1 and {len(DET_TAIL_SHAPES)} K2 a frame")
                line["launches"] = launches
                line["frames"] = frames
                out[name] = line
        finally:
            CSPBlockCopy._decode = decode
            cli._StepperDetector.step_only = step_only
            cli.to_device = upload
    log(f"[10b] speed mode: host syncs in each of its {len(step_syncs)} "
        f"frames (upload, and step for a clip's frames 2-8) {step_syncs}")
    if len(step_syncs) != 16 or any(step_syncs):
        raise AssertionError(f"speed-mode steady frames made host syncs "
                             f"{step_syncs}")
    return out


def _det_ladder_clip(device):
    """CSP (1, 2, 2, 1) 256x512 fp32 through ``CSPBlockCopy``
    (``rl_objectdetection``, quantum 0.25: ladder {2, 4, 6, 8}, REINFORCE
    every 2nd frame, ``csp_cls`` bias 0, ``score_thr`` 0.6), 4 frames; the
    Bernoulli draws are -1 (execute) or 2 (skip), so 3, 5 and 8 blocks round
    to counts 4, 6 and 8 whatever the policy's probabilities.  Per frame on
    the CPU: the count, the box lists, copies of the canvases."""
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.models.csp import (CSPBlockCopy, CSPConfig,
                                                init_csp)
    from blockcopy_tpu_torch.policy.optim import tree_map
    from blockcopy_tpu_torch.tools.measure import synthetic_frames
    cfg = CSPConfig(stage_blocks=(1, 2, 2, 1), score_thr=0.6)
    params = init_csp(cfg, seed=0, device=device)
    params["head"]["csp_cls"]["b"].zero_()
    model = CSPBlockCopy(params, cfg, default_settings(
        block_policy="rl_objectdetection", block_num_classes=1,
        block_quantize_number_exec=0.25, block_train_interval=2),
        device=device)
    frames = synthetic_frames((1, 256, 512, 3), 4, torch.float32, seed=2,
                              device="cpu")
    gen = torch.Generator().manual_seed(4)
    draws = [None]
    for n_exec in (3, 5, 8):
        u = torch.full((8,), 2.0)
        u[torch.randperm(8, generator=gen)[:n_exec]] = -1.0
        draws.append((u.view(1, 2, 4), torch.rand((8,), generator=gen)))
    out = []
    for frame, d in zip(frames, draws):
        d = None if d is None else tuple(x.to(device) for x in d)
        boxes = model(frame.to(device), draws=d)
        out.append({"count": model.policy_meta["num_exec"], "boxes": boxes,
                    "canvases": tree_map(
                        lambda x: x.to("cpu", torch.float32, copy=True),
                        model.temporal["canvases"])})
    return out


def phase_detection_ladder_modes():
    """(10c) ``CSPBlockCopy`` on the GPU against the CPU (plain versions):
    counts and box counts per class (``valid`` and labels) equal; each GPU
    box matched to the CPU box nearest it; canvases and boxes within 1e-5
    of their largest |CPU value|."""
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.policy import net as policy_net
    policy_net.COMPUTE_DTYPE = torch.float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    kernels.reset_launches()
    gpu = _det_ladder_clip("cuda")
    used = dict(kernels.launches)
    cpu = _det_ladder_clip("cpu")
    torch.backends.cudnn.deterministic = False
    policy_net.COMPUTE_DTYPE = torch.bfloat16
    counts = [f["count"] for f in gpu]
    same = counts == [f["count"] for f in cpu]
    canvas_err = box_err = 0.0
    n_boxes = []
    for g, c in zip(gpu, cpu):
        for name, r in c["canvases"].items():
            pairs = [(g["canvases"][name][k], r[k]) for k in r] \
                if isinstance(r, dict) else [(g["canvases"][name], r)]
            for x, y in pairs:
                canvas_err = max(canvas_err, (x - y).abs().max().item()
                                 / max(y.abs().max().item(), 1e-30))
        for gb, cb in zip(g["boxes"], c["boxes"]):       # per class
            same &= gb.shape == cb.shape
            if gb.shape != cb.shape or not len(cb):
                continue
            near = np.abs(gb[:, None, :4] - cb[None, :, :4]).max(-1) \
                .argmin(1)
            same &= len(set(near.tolist())) == len(near)
            box_err = max(box_err, float(np.abs(gb - cb[near]).max()
                                         / np.abs(cb).max()))
        n_boxes.append(len(c["boxes"][0][0]))
    log(f"[10c] CSPBlockCopy CSP (1, 2, 2, 1) 256x512 fp32, 4 frames at "
        f"counts {counts}, GPU (kernels {used}) vs CPU (plain versions): "
        f"counts, valid and labels equal {same}; canvases max abs err / max "
        f"|CPU canvas| {canvas_err:.3g}; boxes {box_err:.3g}; boxes per frame "
        f"{n_boxes}; tol 1e-5")
    if (not same or canvas_err > 1e-5 or box_err > 1e-5 or min(n_boxes) < 1
            or not used["halo_strips"] or not used["bottleneck_tail"]):
        raise AssertionError("GPU detection ladder disagrees with the CPU")
    return canvas_err, box_err


def phase_detection_ladder_kernels(gen):
    """(10d) at the detection ladder's extremes, K = 8 (7 blocks and a
    padding slot) and K = 128 (every block): K1 bitwise against its plain
    version at every detection shape (both entry points, bf16 and fp32) and
    K2 against its plain version (bf16 3e-2, fp32 1e-4 with TF32 off;
    outputs finite); then both timed there in bf16, per-frame sums beside
    their bounds."""
    from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
    from blockcopy_tpu_torch.ops.kernels import halo as H
    from blockcopy_tpu_torch.tools.measure import device_ms
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tail_err = {"bf16": 0.0, "f32": 0.0}
    out = {}
    for k in DET_LADDER_KS:
        n_set = k - 1 if k < N * GH * GW else k
        for bs, c, p in sorted(set(DET_HALO_SHAPES)):
            for dtype in (torch.bfloat16, torch.float32):
                canvas, strips, idx, center = _halo_case(gen, bs, c, p, dtype,
                                                         n_set, k)
                args = (idx, p, N, GH, GW, center)
                ref = H.halo_gather_canvas_plain(canvas, *args)
                same = (torch.equal(H.halo_gather_canvas(canvas, *args), ref)
                        and torch.equal(H.halo_gather_strips(strips, *args),
                                        ref)
                        and torch.equal(H.halo_gather_strips_plain(strips,
                                                                   *args),
                                        ref))
                if not same:
                    raise AssertionError(
                        f"halo kernel disagrees with its plain version at "
                        f"K={k} bs={bs} C={c} pad {p} {dtype}")
                del canvas, strips, center, ref
        for bs, cm, co in sorted(set(DET_TAIL_SHAPES)):
            for name, dtype, tol in (("bf16", torch.bfloat16, 3e-2),
                                     ("f32", torch.float32, 1e-4)):
                args = _tail_case(gen, bs, cm, co, dtype, k)
                ref = BT.bottleneck_tail_plain(*args).float()
                got = BT.bottleneck_tail(*args)
                err = (got.float() - ref).abs().max().item()
                if not (bool(torch.isfinite(got).all()) and torch.allclose(
                        got.float(), ref, rtol=tol, atol=tol)):
                    raise AssertionError(
                        f"bottleneck kernel disagrees with its plain version "
                        f"at K={k} bs={bs} {dtype}: max abs err {err:.3g}")
                tail_err[name] = max(tail_err[name], err)
        log(f"[10d] K={k}: halo bitwise == plain at {len(set(DET_HALO_SHAPES))}"
            f" detection shapes x bf16/fp32 x both entry points; tail within "
            f"3e-2 bf16 / 1e-4 fp32 at {len(set(DET_TAIL_SHAPES))} shapes")
        halo, tail = {}, {}
        for bs, c, p in sorted(set(DET_HALO_SHAPES)):
            canvas, strips, idx, center = _halo_case(gen, bs, c, p,
                                                     torch.bfloat16, n_set, k)
            args = (idx, p, N, GH, GW, center)
            halo[(bs, c, p)] = {
                "ms": device_ms(lambda: H.halo_gather_strips(strips, *args)),
                "plain_ms": device_ms(
                    lambda: H.halo_gather_strips_plain(strips, *args)),
                "bound_ms": halo_bytes(bs, c, p, 2, k) / HBM_BYTES_PER_S
                * 1e3}
            t = halo[(bs, c, p)]
            log(f"[10d] halo strips bs={bs:2d} C={c:3d} pad {p} bf16 K={k}: "
                f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f}), bound "
                f"{t['bound_ms']:.4f} ms (bytes)")
            del canvas, strips, center
        for bs, cm, co in sorted(set(DET_TAIL_SHAPES)):
            args = _tail_case(gen, bs, cm, co, torch.bfloat16, k)
            flops, nbytes = tail_cost(bs, cm, co, 2, k)
            t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
            tail[(bs, cm, co)] = {
                "ms": device_ms(lambda: BT.bottleneck_tail(*args)),
                "plain_ms": device_ms(lambda: BT.bottleneck_tail_plain(*args)),
                "bound_ms": max(t_ops, t_bytes) * 1e3}
            t = tail[(bs, cm, co)]
            log(f"[10d] tail bs={bs} Cm={cm} Co={co} bf16 K={k}: "
                f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f}), bound "
                f"{t['bound_ms']:.4f} ms "
                f"({'operations' if t_ops > t_bytes else 'bytes'})")
        for name, rows, shapes in (("halo", halo, DET_HALO_SHAPES),
                                   ("tail", tail, DET_TAIL_SHAPES)):
            out[(name, k)] = {key: sum(rows[s][key] for s in shapes)
                              for key in ("ms", "plain_ms", "bound_ms")}
            log(f"[10d] {name} per detection ladder frame at K={k} "
                f"({len(shapes)} launches): "
                + ", ".join(f"{key} {v:.4f}"
                            for key, v in out[(name, k)].items()))
    out["tail_err"] = tail_err
    return out


def ladder_keys(kern, name):
    """The kernels line's per-frame detection-ladder times of K1 or K2."""
    return {f"detection_ladder_{key}_k{k}": kern[(name, k)][key]
            for k in DET_LADDER_KS for key in ("ms", "plain_ms", "bound_ms")}


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
    blocks = phase_block_sizes()
    det_launches, det = phase_detection()
    det_canvas_err, det_dets_err = phase_detection_modes()
    det_kern = phase_detection_kernels(gen)
    dl_launches, dl = phase_detection_ladder()
    det_cli = phase_detection_cli()
    dl_canvas_err, dl_box_err = phase_detection_ladder_modes()
    dl_kern = phase_detection_ladder_kernels(gen)

    source = "blockcopy_tpu_torch/csrc/"
    common = {"route": "cuda", "library_ms": None, "matched": True}
    kern = [
        {"name": "halo_gather_strips", "source": source + "halo.cu",
         "replaces": "blockcopy_tpu/ops/pallas/halo.py:68",
         "path": "main, ladder, detection",
         "launches": launches["halo_strips"],
         "ladder_launches": ladder_launches["halo_strips"],
         "detection_launches": det_launches["halo_strips"],
         "detection_ms": det_kern["halo"]["ms"],
         "detection_plain_ms": det_kern["halo"]["plain_ms"],
         "detection_bound_ms": det_kern["halo"]["bound_ms"],
         "detection_max_abs_err": 0.0,
         "detection_ladder_launches": dl_launches["halo_strips"],
         "detection_cli_launches": {k: v["launches"]["halo_strips"]
                                    for k, v in det_cli.items()},
         **ladder_keys(dl_kern, "halo"),
         "max_abs_err": halo["err"], "ms": halo["strips"],
         "plain_ms": halo["strips_plain"], "bound_ms": halo["bound"],
         "bound_by": "bytes", **common},
        {"name": "halo_gather_canvas", "source": source + "halo.cu",
         "replaces": "blockcopy_tpu/ops/pallas/halo.py:68",
         "path": "pallas halo mode", "launches": canvas_launches,
         "detection_ladder_launches": dl_launches["halo_canvas"],
         "max_abs_err": halo["err"], "ms": halo["canvas"],
         "plain_ms": halo["canvas_plain"], "bound_ms": halo["bound"],
         "bound_by": "bytes", **common},
        {"name": "bottleneck_tail", "source": source + "bottleneck.cu",
         "replaces": "blockcopy_tpu/ops/pallas/bottleneck.py:92",
         "path": "main, ladder, detection",
         "launches": launches["bottleneck_tail"],
         "ladder_launches": ladder_launches["bottleneck_tail"],
         "detection_launches": det_launches["bottleneck_tail"],
         "detection_ms": det_kern["tail"]["ms"],
         "detection_plain_ms": det_kern["tail"]["plain_ms"],
         "detection_bound_ms": det_kern["tail"]["bound_ms"],
         "detection_max_abs_err": det_kern["tail"]["err"]["bf16"],
         "detection_ladder_launches": dl_launches["bottleneck_tail"],
         "detection_cli_launches": {k: v["launches"]["bottleneck_tail"]
                                    for k, v in det_cli.items()
                                    if k != "ladder fp32"},
         **ladder_keys(dl_kern, "tail"),
         "detection_ladder_max_abs_err": dl_kern["tail_err"]["bf16"],
         # phase 8d: at block 256 the bf16 kernel takes no RN50 block
         "block256_launches": sum(blocks[(256, str(torch.bfloat16))]),
         "max_abs_err": tail["bf16"]["err"], "ms": tail["bf16"]["kernel"],
         "plain_ms": tail["bf16"]["plain"], "bound_ms": tail["bf16"]["bound"],
         "bound_by": tail["bf16"]["by"], **common},
        {"name": "bottleneck_tail_f32", "source": source + "bottleneck.cu",
         "replaces": "blockcopy_tpu/ops/pallas/bottleneck.py:92",
         "path": "fp32 CLI (ladder, speed-mode)",
         "launches": cli["ladder fp32"]["launches"]["bottleneck_tail"],
         "speed_mode_launches":
             cli["speed-mode fp32"]["launches"]["bottleneck_tail"],
         "block256_launches": sum(blocks[(256, str(torch.float32))]),
         "detection_max_abs_err": det_kern["tail"]["err"]["f32"],
         # the fp32 detection ladder: the CLI's fp32 ladder run (10b)
         "detection_ladder_launches": det_cli["ladder fp32"]["launches"][
             "bottleneck_tail"],
         "detection_ladder_max_abs_err": dl_kern["tail_err"]["f32"],
         "max_abs_err": tail["f32"]["err"], "ms": tail["f32"]["kernel"],
         "plain_ms": tail["f32"]["plain"], "bound_ms": tail["f32"]["bound"],
         "bound_by": tail["f32"]["by"], **common},
    ] + [
        {"name": name, "source": source + "mm.cu",
         "replaces": "tools/probe_int8.py:38", "path": "probe_int8",
         "launches": probe_launches[name],
         "detection_ladder_launches": dl_launches[name], "route": "cuda",
         "matched": True, **mm[name]}
        for name in ("mm_bf16", "mm_int8")]
    log(f"[7] halo and tail times are per main-path frame (sums over its "
        f"launch shapes), their library_ms null: no single PyTorch call "
        f"computes either function; mm times are per launch at "
        f"{'x'.join(map(str, MM_SHAPES[0]))}; main path {step_ms:.2f} "
        f"ms/frame; ladder path {ladder['ms']:.2f} ms/frame at capacities "
        f"{ladder['capacities']}, peak {ladder['peak_gib']:.2f} GiB; CLI fps "
        f"ladder {cli['ladder']['fps']:.2f}, speed-mode "
        f"{cli['speed-mode']['fps']:.2f}, fp32 ladder "
        f"{cli['ladder fp32']['fps']:.2f}, fp32 speed-mode "
        f"{cli['speed-mode fp32']['fps']:.2f}; ladder GPU vs CPU "
        f"{ladder_err:.3g}; detection path {det['ms']:.2f} ms/frame, peak "
        f"{det['peak_gib']:.2f} GiB, GPU vs CPU canvases {det_canvas_err:.3g}"
        f", dets {det_dets_err:.3g}; detection_* times are per detection "
        f"frame at K = {DET_K}; detection ladder {dl['ms']:.2f} ms/frame at "
        f"capacities {dl['capacities']}, host syncs a frame {dl['syncs']}, "
        f"peak {dl['peak_gib']:.2f} GiB, GPU vs CPU canvases "
        f"{dl_canvas_err:.3g}, boxes {dl_box_err:.3g}; detection CLI fps "
        + ", ".join(f"{k} {v['fps']:.2f}" for k, v in det_cli.items())
        + f"; detection_ladder_* times are per detection ladder frame at "
        f"K = 8 and 128; total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
