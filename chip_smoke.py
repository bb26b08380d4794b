#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``blockcopy_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. card and build: ``nvidia-smi`` name and power limit, then the kernels of
   ``blockcopy_tpu_torch/csrc`` built in parallel, with the build seconds;
2. halo kernel (both entry points) against its plain versions, bitwise, at
   every main-path shape, bf16 and fp32, pads 1-3, on a partial grid with
   padding slots; times at the main-path shapes at K = 8, 64 and 128
   (ladder mode's smallest capacity, the main path's, every block), each
   with its launch plan (``halo_plan``), the per-frame sums beside the
   bytes bound and K1's launch floor (the entry at K = 1, bs 4, C 8:
   ``halo_launch_floor``; ``halo_frames`` times every path's per-frame sums
   alone, and under other plan settings); then its ``halo_pieces``
   entry (the 8 pieces of the stem's plane pool in one launch: the fused
   tails read their halo inside K2) likewise at every (bs, C) of the
   block-128 and block-256 paths' plane pools and fused tails, timed at
   each path's plane pool and capacity beside its bytes bound;
3. bottleneck-tail kernel, its halo read in place from the strips of a
   partial grid with padding slots (the full grid at K = 128; a
   ``StripHalo``), (bf16 3e-2, fp32 1e-4 with TF32 off) against its plain
   version (the plain gather's 8 pieces, then the plain tail) at the RN50
   layer2 and layer3 shapes at K = 8, 64 and 128 (ladder mode's smallest
   capacity, the main path's, ladder mode's largest): time per launch (the
   weights are prepared by the warm-up calls, as on the main path) beside
   its bound and the plain version's, each fp32 stage's device time, the
   ``halo_pieces`` entry timed on the same strips (the gather's launch the
   tail had before it read the strips), and the per-frame sums at K = 64;
   then
   its bf16 row route (3e-2) at RN50's block-256 shapes at K = 2, 16 and 32,
   at ``wide_resnet50_2``'s block-128 shapes at K = 8, 64 and 128 and at Co
   640 (the halo likewise in strips, with ``halo_pieces`` timed beside),
   each with its launch plan (bands, cluster, pass width; one fused
   launch) timed beside its bound and plain version, its parts (3x3
   products, 1x1 stage, staging and the rest: ``tools/tail_breakdown.py``)
   at the block-256 shapes at K = 2 and 16, and forced at the wgmma route's
   shapes, timed beside it;
4. the main path at full width: SwiftNet-RN50 BlockCopy fixed-capacity step,
   1024x2048 bf16, fast policy, block 128, target 0.5 (64 of 128 blocks),
   REINFORCE every 4th frame; ``init_state``, ``first_step`` and 12 steps,
   each step under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
   fails the run); launch counts (zeroed just before ``init_state``: 12 K1
   ``halo_strips``, 1 K1 ``halo_pieces`` (the stem's plane pool) and 8 K2
   a frame), blocks per step, policy updates, ms/frame and peak memory;
   (4b) the same at block 256, capacity 16 of 32: 10 K1 launches a frame
   (``HALO_SHAPES_256``), 1 ``halo_pieces`` (``PIECE_SHAPES_256``) and 10
   K2 launches on its bf16 row route (``TAIL_SHAPES_256``), none on its
   other routes;
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
7. one JSON line ``{"kernels": [...]}`` and, last, the result line (K2's
   launches are counted by route: ``bottleneck_tail`` the bf16 wgmma route,
   ``bottleneck_tail_rows`` the bf16 row route, ``bottleneck_tail_f32``);
8. ladder mode, before the JSON lines: (a) ``BlockCopyModel`` built with
   ``build_policy_from_settings(default_settings())`` (block 128,
   ``rl_semseg``, target 0.5, quantum 1/16, REINFORCE every 4th frame,
   ``ref`` policy) on SwiftNet-RN50 1024x2048 bf16, 2 clips of 8 frames:
   frame 1 of a clip executes all 128 blocks, every count is on the
   capacity ladder, exactly one host sync per frame (torch's sync debug
   mode), 12 halo, 1 halo_pieces and 8 tail launches per executed frame
   (launch counts zeroed just before the first clip), policy updates on
   frames 4 and 8 only; capacities, ms/frame and peak memory; (b) the
   semseg CLI in-process at the same width, on the ladder engine and with
   ``--speed-mode``, in bf16 (``--half``) and in fp32 (as it ships), launch
   counts zeroed just before each run; (c) the ladder engine on the GPU
   against the CPU (RN50 256x512 fp32, 4 frames, injected draws, counts 8,
   4, 6, 8) within 1e-3 of the largest |CPU output|; (d) RN50 1024x2048
   ladder frames at block 256 in bf16 and fp32 and at block 128 in fp32,
   and ``wide_resnet50_2`` at block 128 in bf16, with K2's launches per
   executed frame asserted by route (10 on the row route, 10 and 8 on the
   fp32 route, 10 on the row route), and one ``halo_pieces`` launch (the
   plane pool);
9. detection, before the JSON lines: (a) ``DetectionStepper`` on CSP-R50 at
   full width and depth (``CSPConfig()``), 1024x2048 bf16, fast policy,
   block 128, target 0.3 (38 of 128 blocks), REINFORCE every 4th frame,
   random weights from seed 0 (the workload of ``bench_detection.py``)
   with the ``csp_cls`` bias at 0, so that scores straddle ``score_thr``
   and decode, NMS and the IoU gain run on live boxes: ``init_state``,
   ``first_step`` and 12 steps, each under ``set_sync_debug_mode("error")``;
   38 blocks a step, finite (100, 5) dets, at least 8 valid dets a frame,
   each inside the 1024x2048 image with its score at least ``score_thr``,
   policy updates at frames 4, 8 and 12 only, and 13 K1 ``halo_strips``, 1
   K1 ``halo_pieces`` and 8 K2 launches a frame (``DET_HALO_SHAPES``,
   ``PIECE_SHAPES``, ``DET_TAIL_SHAPES``; counts zeroed just
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
   mode), 13 K1 ``halo_strips``, 1 ``halo_pieces`` and 8 K2 launches per
   executed frame (counts zeroed just before the first clip), policy
   updates on frames 4 and 8 only, at least 8 boxes a frame inside the
   image with score >= 0.1; capacities, ms/frame, peak memory and the host
   ms of painting the masks; (b) the detection
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
   then both timed there in bf16, K1's per-frame sums beside its launch
   floor;
11. detection training, before the JSON lines: (a) the train step on
   CSP-R50 at full width and depth, fp32, 640x1280 crops, batch 2 (the train
   CLI's defaults; cuDNN TF32 on, matmul TF32 off, torch's defaults) as
   the CLI runs it, one CUDA graph captured at the first step: 12 steps
   timed directly, each under ``set_sync_debug_mode("error")`` (the
   capture too), no kernel launch, each step's own loss (cloned out of
   the graph's buffers); ms/step (median of steps 3-12), the capture's
   seconds and peak memory; then the train CLI in-process (``--synthetic
   --epochs 1 --steps-per-epoch 8 --workers 2 --warmup-iters 0``): one
   graph, no host sync in a train step, finite losses, ``step`` 8, the
   student, teacher and resume checkpoints written; (b) the detection CLI on that teacher checkpoint, ladder bf16
   1024x2048 from the 0.3 config: 13 K1 and 8 K2 launches per frame that
   ran blocks (counts zeroed just before); (c) two train steps of CSP (1,
   2, 2, 1) 128x256 fp32 on the GPU against the CPU, TF32 off: losses
   within 1e-4 relative, gradient leaves within 1e-4 of their largest |CPU
   value| with the GPU's ReLUs given the CPU's sign masks (disagreeing only
   within 1e-5 of the input's largest value), the update fed the same
   gradients within 1e-6; (d) ``tools/validate_detection.py`` at
   ``--train-iters 150 --warmup-clips 4 --eval-clips 4 --skip-flag-ab``:
   the loss falls at least 10x, MR and F1 against dense per mode, the exec
   rate, 13 K1 and 8 K2 launches per frame of the BlockCopy mode;
12. clip-parallel, before the JSON lines: (a) two ranks on ``cuda:0``
   (spawned processes joined on gloo: NCCL takes one rank per GPU), each
   stepping its own clip through phase 4's path (SwiftNet-RN50 1024x2048
   bf16, capacity 64, REINFORCE every 4th frame), ``first_step`` and 12
   steps, the REINFORCE gradients averaged in one all_reduce a train
   frame: 12 K1 ``halo_strips``, 1 ``halo_pieces`` and 8 K2 launches a
   frame on each rank (counts zeroed just before each rank's
   ``init_state``), updates at frames 4, 8, 12, the
   policy parameters bitwise equal across the ranks after every one, no
   host sync on a steady frame (``set_sync_debug_mode("error")``); the
   syncs each train frame reports, ms/frame per rank, the two ranks'
   aggregate frames/s after the first update (steps 4-12) against phase
   4's one rank and (b)'s, peak memory per rank;
   (b) the same step in a world of one on NCCL, every frame (train frames
   too) with no host sync; (c) the averaged gradient of (a)'s first train
   frame against the mean of the two ranks' own gradients, taken in this
   process; (d) the semseg CLI at full width with ``--speed-mode
   --num-devices 1`` under ``WORLD_SIZE=1`` (12 + 1 K1 and 8 K2 launches a
   frame), which takes the CLI's single-process path (a world of one joins
   no process group), and the detection stepper (phase 9's workload) on two gloo
   ranks on ``cuda:0``: ``first_step`` and 8 steps, 13 + 1 K1 and 8 K2 a frame
   on each rank, the parameters bitwise equal after every update;
13. native clip IO and the semseg validation tool, before the JSON lines:
   (a) the clip IO library (``blockcopy_tpu_torch/native/io.cpp``) built by
   g++ (seconds, zlib version); a Cityscapes-layout directory of 1024x2048
   PNGs written without PIL (``tools/measure.py``, every row filter), 2
   clips of 4 frames a split; decode bitwise against ``(img/255 -
   mean)/std``, gray and palette labels exact, the 20 frames decoded on 6
   threads at 1024x2048 and resized to 512x1024 (ms a frame), ``nms`` and
   ``soft_nms`` against ``ops/nms.py``; (b) the semseg CLI on that
   directory with ``--native-io --fast --speed-mode --half
   --model-backbone resnet50 --clip-length 4`` and PIL unimportable: 12 K1
   ``halo_strips``, 1 ``halo_pieces`` and 8 K2 (``wgmma``) launches in
   every frame, FPS beside 8b's, decode ms a frame beside phase 4's step;
   (c) ``tools/validate_capability.py`` at ``--warmup-clips 2 --eval-clips
   1 --clip-length 4``, 512x1024 fp32: RN18 ``ref`` (K1 only) and RN50
   ``fast`` at amp 8 (K1 and K2's fp32 route), the keys of
   ``VALIDATION.json``, rates in [0, 1], 2 frames evaluated;
14. the JAX package's off-by-default lowerings, set in-process through
   ``tools/measure.py`` ``switches`` and restored after, before the JSON
   lines: (a) phase 4's path (same parameters, frames and capacity) with
   injected draws, switch off and under each of ``SWITCH_RUNS``
   (``BORDER_CONV``; ``S2D_STEM`` with the plane-pool stem off;
   ``TALL_CONV_BS=8``; ``OUT_BLOCKS``; ``PACKED_OUT``;
   ``POLICY_SPLIT_STEM``; ``POLICY_STEM_CONV4=0``; all that combine):
   no host sync, K1 ``halo_strips`` and ``halo_pieces`` launches a frame as
   listed there and 8 K2 ``bottleneck_tail``, ms/frame, and agreement with
   the switch-off run: grids equal on every frame for the layout switches,
   outputs within 3e-2 of the largest |output| on every frame whose grids
   agree so far; the stem forms again with fp32 policy convs against the
   switch-off run so, grids equal on every frame; (b) the step on the GPU
   against the CPU under the switches (``SMALL_SWITCH_RUNS``), as phase 5,
   within 1e-3; (c) phase 9's detection step under ``TOPK='approx'``,
   ``DECODE_LEAN_POINTS=0`` and ``BORDER_CONV`` against the switch-off step
   on injected draws that fix the grids: 1 + 13 K1 and 8 K2 launches a
   frame, the kept boxes equal as sets (IoU >= 0.9 pairs, scores within
   3e-2; unpaired boxes only within 3e-2 of ``score_thr`` or of a full
   set's lowest kept score: the ``max_per_img`` cut);
15. the steps as CUDA graphs (``core/graphs.py``, the port's counterpart of
   the JAX package's ``jax.jit(..., donate_argnums=(1,))``), before the JSON
   lines; phases 4, 8a, 9a and 10a drive the steps op by op: (a) phase 4's
   path through ``StepperGraphs`` (the step both CLIs run), in lockstep with
   two eager runs over ``first_step`` and 12 steps, the same uniforms
   injected into each, under cuDNN's deterministic algorithms: after every frame the grid, canvases, outputs and
   policy parameters of the captured run are as close to the first eager
   run as the second is (bitwise where the eager runs are bitwise over the
   clip), every replay under ``set_sync_debug_mode("error")``, 12 K1
   ``halo_strips``, 1 ``halo_pieces`` and 8 K2 a frame counted around the
   captured call (each graph adds its capture's counts on a replay); the
   three graphs' capture seconds; then without draws, both on the card at
   once: the peak memory of each warm-up, ms/frame in interleaved windows
   of 8 steps (eager, captured, eager, captured) and a window of each under
   the profiler (busy ms, idle share, kernels a step); the replays keep 64
   blocks and draw grids of their own; (b) phase 9a's detection step
   likewise (13 K1 ``halo_strips``, 1 ``halo_pieces``, 8 K2 a frame); (c)
   phase 8a's and phase 10a's ladder engines, two op by op and one with a
   graph per capacity in lockstep over 2 clips of 8 frames with injected
   draws, cuDNN deterministic: the same counts, outputs as close as the eager engines', one graph
   a capacity that ran, launches a frame as 8a and 10a, ms/frame of both;
16. the JAX package's remaining compiled serving programs as CUDA graphs
   (``core/graphs.py`` ``CallGraphs``), before the JSON lines: (a) phase
   8a's semseg ladder and (b) phase 10a's detection ladder, two op by op
   and one with every graph (the policy's forward and REINFORCE update, a
   graph per capacity, the CSP decode) in lockstep over 2 clips of 8 frames
   with injected draws, cuDNN deterministic: the same counts; outputs,
   canvases and policy parameters as close as the eager engines'; launches
   a frame as 8a and 10a; host syncs a frame as 8a (1) and 10a (3 plain, 4
   train) on every frame of the eager engines and every frame on which the
   captured one replayed every graph; ms/frame of both on those frames and
   a window of 8 frames of each under the profiler (idle share); (c) the
   semseg CLI's ``--block-policy static`` dense forward and upsample as
   graphs, bitwise their op-by-op bodies, ms/frame of both; (d) the
   clip-parallel steps as graphs on the one card: an NCCL world of one
   (the ``all_reduce`` inside the train graph) and two gloo ranks (the
   split train step), each rank in lockstep with the eager parallel step
   (policy and outputs bitwise), the policy bitwise across the ranks, 12
   captured steps with 12 + 1 K1 and 8 K2 a frame and no host sync on a
   steady frame, aggregate frames/s against phase 12's;
17. the detection train step as a CUDA graph (``tasks/detection/train.py``
   ``make_train_step``, JAX's ``jax.jit(make_train_step(...),
   donate_argnums=(0,))``), before the JSON lines: (a) phase 11a's
   workload, two eager train states (``graphs=False``) and one captured in
   lockstep from one init over its 12 batches, cuDNN deterministic: after
   every step the captured state's ``params``, ``ema_params``, ``m``,
   ``v`` and loss terms as close to the first eager run's as the second
   eager run's are (bitwise where those are bitwise over the steps), the
   host steps equal, every captured step (the capture too) under
   ``set_sync_debug_mode("error")``, no kernel launch; the capture's seconds, ms/step of each (a step at a
   time, eager, eager, captured, fenced; median of steps 3-12), peak
   memory allocated above what each step found held, the process's peak
   reserved memory while each run stepped, and what the graph's memory
   pool keeps reserved; (b) the train CLI in-process at phase 11's arguments through
   its graph, checked as in 11a, and its teacher checkpoint through the
   detection CLI's loader (``models/builder.py`` ``load_csp_params``),
   every tensor finite (11b serves phase 11's teacher, also trained
   through the graph).

It needs one CUDA GPU and the repository around it: without either it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
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
# main-path halo_pieces launches per step (bs, C), pad 1: the stem's plane
# pool (its s2d planes, 4 x 64 channels at bs / 4); the fused tails read
# their h1 halo from the strips inside K2; the detection path makes the same
PIECE_SHAPES = [(32, 256)]
# the fused tails' halos (bs, Cm), where phase 3 times halo_pieces beside K2
TAIL_PIECE_SHAPES = [(bs, cm) for bs, cm, _ in TAIL_SHAPES]
N, GH, GW, K = 1, 8, 16, 64
# the block-256 path (phase 4b): K1 launches per step (bs, C): the stem's
# s2d planes, layer1's three 3x3s, the strided first blocks of layers 2-4
# and the three upsample blends; K2 (all on the bf16 row route): layer2
# blocks 1-3, layer3 blocks 1-5 and layer4 blocks 1-2 (3 + 5 + 2)
HALO_SHAPES_256 = ([(64, 48)] + [(64, 64)] * 3 + [(64, 128), (32, 256),
                   (16, 512), (16, 128), (32, 128), (64, 128)])
TAIL_SHAPES_256 = [(32, 128, 512)] * 3 + [(16, 256, 1024)] * 5 \
    + [(8, 512, 2048)] * 2
PIECE_SHAPES_256 = [(64, 256)]
TAIL_PIECE_SHAPES_256 = [(bs, cm) for bs, cm, _ in TAIL_SHAPES_256]
# block 256's capacities: ladder mode's smallest (quantum 1/16 of 32
# blocks), the stepper's (target 0.5), every block
K_256, TAIL_KS_256 = 16, (2, 16, 32)
# wide_resnet50_2's fused blocks at block 128: layer1 blocks 1-2, layer2
# blocks 1-3, layer3 blocks 1-5 (row route; timed at TAIL_KS)
WIDE_TAIL_SHAPES = [(32, 128, 256)] * 2 + [(16, 256, 512)] * 3 \
    + [(8, 512, 1024)] * 5
# the wgmma route's blocks, where phase 3 also times the row route
WGMMA_SHAPES = [(16, 128, 512), (8, 256, 1024), (8, 128, 512)]
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
# K1's capacities phase 2 times: ladder mode's smallest, the main path's,
# every block
HALO_KS = (8, K, 128)
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
    logs = build.build(["halo", "bottleneck", "mm", "mark"])
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


def pieces_bytes(bs, c, p, itemsize, k=K):
    """Bytes ``halo_pieces`` must move: each piece read once from its
    neighbour's strip and written once, and the block indices."""
    return 2 * k * (4 * p * bs + 4 * p * p) * c * itemsize + 8 * k


def _pieces_case(gen, bs, c, p, dtype, n_set, k):
    """Strip storage of the 1024x2048 block-128 grid (random strips, zero
    sentinel) and ``k`` block indices, ``n_set`` executed and the rest
    padding slots."""
    from blockcopy_tpu_torch.core import grid as G
    total = N * GH * GW
    strips = {"rows": torch.randn((total + 1, 2 * p, bs, c), generator=gen,
                                  device="cuda").to(dtype),
              "cols": torch.randn((total + 1, bs, 2 * p, c), generator=gen,
                                  device="cuda").to(dtype)}
    for t in strips.values():
        t[-1] = 0
    order = torch.randperm(total, generator=gen, device="cuda")
    grid = torch.zeros(total, dtype=torch.bool, device="cuda")
    grid[order[:n_set]] = True
    return strips, G.exec_indices(grid.view(N, GH, GW), k)


def phase_pieces(gen):
    """K1's ``halo_pieces`` entry bitwise against its plain version at
    every plane-pool and fused-tail shape of the block-128 and block-256
    paths, bf16 and fp32, pad 1 and 3, on a partial grid with padding
    slots; then timed at each path's ``halo_pieces`` shapes (its plane pool)
    and capacity beside its bytes bound.  Returns the per-step sums of the
    block-128 and the block-256 path."""
    from blockcopy_tpu_torch.ops.kernels import halo as H
    from blockcopy_tpu_torch.tools.measure import device_ms
    shapes = sorted(set(PIECE_SHAPES + PIECE_SHAPES_256 + TAIL_PIECE_SHAPES
                        + TAIL_PIECE_SHAPES_256))
    err = 0.0
    for bs, c in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            for p in (1, 3):
                strips, idx = _pieces_case(gen, bs, c, p, dtype, K - 4, K)
                got = H.halo_pieces(strips, idx, p, N, GH, GW)
                ref = H.gather_halo_strips_plain(strips, idx, p, N, GH, GW)
                err = max([err] + [(got[n].float() - ref[n].float()).abs()
                                   .max().item() for n in H.PIECES])
                if not all(torch.equal(got[n], ref[n]) for n in H.PIECES):
                    raise AssertionError(f"halo_pieces disagrees with its "
                                         f"plain version at bs={bs} C={c} "
                                         f"p={p} {dtype}")
    log(f"[2] halo_pieces bitwise == plain at {len(shapes)} shapes x "
        f"bf16/fp32 x pad 1/3 (partial grid, 4 padding slots): True")
    out = {}
    for name, path, k in (("block128", PIECE_SHAPES, K),
                          ("block256", PIECE_SHAPES_256, K_256)):
        rows = {}
        for bs, c in sorted(set(path)):
            strips, idx = _pieces_case(gen, bs, c, 1, torch.bfloat16, k, k)
            args = (strips, idx, 1, N, GH, GW)
            t = {"kernel": device_ms(lambda: H.halo_pieces(*args)),
                 "plain": device_ms(
                     lambda: H.gather_halo_strips_plain(*args)),
                 "bound": pieces_bytes(bs, c, 1, 2, k) / HBM_BYTES_PER_S
                 * 1e3}
            rows[(bs, c)] = t
            log(f"[2] halo_pieces bs={bs:2d} C={c:3d} bf16 K={k}: kernel "
                f"{t['kernel']:.4f} ms (one launch), plain "
                f"{t['plain']:.4f} ms, bound {t['bound']:.5f} ms (bytes, "
                f"{pieces_bytes(bs, c, 1, 2, k) / 1e6:.3f} MB)")
        out[name] = {key: sum(rows[sh][key] for sh in path)
                     for key in ("kernel", "plain", "bound")}
        log(f"[2] halo_pieces per {name} step at K={k} ({len(path)} "
            f"launches): " + ", ".join(f"{key} {v:.4f} ms"
                                       for key, v in out[name].items()))
    out["err"] = err
    return out


def phase_halo(gen):
    from blockcopy_tpu_torch.ops.kernels import halo as H
    from blockcopy_tpu_torch.tools.measure import device_ms
    ok, err = True, 0.0
    for bs, c in sorted(set(HALO_SHAPES)):
        for dtype in (torch.bfloat16, torch.float32):
            for p in (1, 2, 3):
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
        f"shapes x bf16/fp32 x pad 1-3 (partial grid, 4 padding slots): "
        f"{ok}")
    if not ok:
        raise AssertionError("halo kernel disagrees with its plain version")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor = halo_launch_floor(gen)
    log(f"[2] halo launch floor (halo_gather_strips at K=1, bs=4, C=8 bf16): "
        f"{floor:.4f} ms a launch")
    out = {}
    for k in HALO_KS:
        rows = {}
        for bs, c in sorted(set(HALO_SHAPES)):
            canvas, strips, idx, center = _halo_case(
                gen, bs, c, 1, torch.bfloat16, halo_n_set(k), k)
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
                "bound": halo_bytes(bs, c, 1, 2, k) / HBM_BYTES_PER_S * 1e3,
            }
            ref = H.halo_gather_canvas_plain(canvas, *args)
            if not (torch.equal(H.halo_gather_canvas(canvas, *args), ref)
                    and torch.equal(H.halo_gather_strips(strips, *args),
                                    ref)):
                raise AssertionError(f"halo kernel disagrees with its plain "
                                     f"version at K={k} bs={bs} C={c}")
            rows[(bs, c)] = t
            plan = H.halo_plan(k, bs, 2 * c, 1, sms)
            log(f"[2] halo bs={bs:2d} C={c:3d} bf16 K={k}: "
                f"strips {t['strips']:.4f} ms (plain "
                f"{t['strips_plain']:.4f}), canvas {t['canvas']:.4f} ms "
                f"(plain {t['canvas_plain']:.4f}), bound {t['bound']:.4f} ms "
                f"(bytes); plan {plan['ctas']} CTAs x {plan['share']} "
                f"pieces of {plan['piece']} B, ring {plan['depth']}")
        per_step = {key: sum(rows[s][key] for s in HALO_SHAPES)
                    for key in ("canvas", "strips", "canvas_plain",
                                "strips_plain", "bound")}
        log(f"[2] halo per main-path frame at K={k} ({len(HALO_SHAPES)} "
            f"launches): " + ", ".join(f"{key} {v:.4f} ms"
                                       for key, v in per_step.items())
            + f"; launch floor {floor:.4f} ms, x{len(HALO_SHAPES)} = "
            f"{floor * len(HALO_SHAPES):.4f} ms")
        out[k] = per_step
    # the main path's capacity at the top level, the ladder's beside it
    out = {**out[K], "ladder": {k: out[k] for k in HALO_KS if k != K},
           "floor": floor, "err": err}
    return out


def halo_n_set(k):
    """Executed blocks of K1's timed cases at capacity ``k``: ladder mode's
    smallest (8) holds 7 and a padding slot, as phase 10d; every other
    capacity is full."""
    return k - 1 if k == 8 else k


def halo_launch_floor(gen):
    """K1's launch floor: ``halo_gather_strips`` at K = 1, bs 4, C 8 bf16,
    pad 1 (1.5 KB out) in the ``device_ms`` harness: what any K1 launch
    costs, the floor under a per-frame sum of its launches."""
    from blockcopy_tpu_torch.ops.kernels import halo as H
    from blockcopy_tpu_torch.tools.measure import device_ms
    _, strips, idx, center = _halo_case(gen, 4, 8, 1, torch.bfloat16, 1, 1)
    return device_ms(lambda: H.halo_gather_strips(strips, idx, 1, N, GH, GW,
                                                  center))


# K1's per-frame readings of ``halo_frames``: (path, capacity)
HALO_FRAMES = (("semseg", 8), ("semseg", K), ("semseg", 128),
               ("detection", 8), ("detection", DET_K), ("detection", 128))
# settings of halo_plan's (PIECE_MAX, CTAS_PER_SM, RING_BYTES) that
# ``halo_frames`` times besides the shipped one when asked
HALO_PLAN_SWEEP = ((8192, 2, 65536), (8192, 4, 32768), (4096, 4, 32768),
                   (2048, 4, 32768), (4096, 8, 16384))


def halo_frames(gen, sweep=()):
    """K1's ``halo_gather_strips`` summed over each path's launches a frame
    (semseg ``HALO_SHAPES`` at pad 1, detection ``DET_HALO_SHAPES``) at
    each of ``HALO_FRAMES``' capacities (``halo_n_set`` executed), bf16,
    beside the bytes bound, each shape's time (keyed bs x C x pad x K), the
    launch floor and, beside it, a one-element ``zero_`` (a launch of any
    kernel in the harness); then the per-frame sums under each (PIECE_MAX,
    CTAS_PER_SM, RING_BYTES) of ``sweep``.  It calls only the wrappers'
    signatures, so it also times an older tree's kernel (that tree's package
    first on ``sys.path``; no sweep there).  Logs and returns one dict."""
    from blockcopy_tpu_torch.ops.kernels import halo as H
    from blockcopy_tpu_torch.tools.measure import device_ms
    paths = {"semseg": [(bs, c, 1) for bs, c in HALO_SHAPES],
             "detection": DET_HALO_SHAPES}
    cases = {}
    for name, k in HALO_FRAMES:
        for bs, c, p in sorted(set(paths[name])):
            cases.setdefault((bs, c, p, k), _halo_case(
                gen, bs, c, p, torch.bfloat16, halo_n_set(k), k)[1:])

    def shapes():
        ms = {}
        for key in sorted(set((bs, c, p, k) for name, k in HALO_FRAMES
                              for bs, c, p in paths[name])):
            strips, idx, center = cases[key]
            bs, c, p, k = key
            ms[key] = device_ms(lambda: H.halo_gather_strips(
                strips, idx, p, N, GH, GW, center))
        return ms

    def frames(ms):
        return {f"{name}_k{k}": sum(ms[(bs, c, p, k)]
                                    for bs, c, p in paths[name])
                for name, k in HALO_FRAMES}

    ms = shapes()
    one = torch.zeros(1, device="cuda")
    out = {"launch_floor_ms": halo_launch_floor(gen),
           "fill_floor_ms": device_ms(one.zero_), "ms": frames(ms),
           "bound_ms": {f"{name}_k{k}": sum(
               halo_bytes(bs, c, p, 2, k) for bs, c, p in paths[name])
               / HBM_BYTES_PER_S * 1e3 for name, k in HALO_FRAMES},
           "shape_ms": {"x".join(map(str, key)): v
                        for key, v in ms.items()}}
    if sweep:
        shipped = (H.PIECE_MAX, H.CTAS_PER_SM, H.RING_BYTES)
        out["sweep"] = []
        try:
            for setting in sweep:
                H.PIECE_MAX, H.CTAS_PER_SM, H.RING_BYTES = setting
                out["sweep"].append({"setting": setting,
                                     "ms": frames(shapes())})
        finally:
            H.PIECE_MAX, H.CTAS_PER_SM, H.RING_BYTES = shipped
    log("[2] halo frames " + json.dumps(out))
    return out


def _tail_case(gen, bs, cm, co, dtype, k=K, n_set=None):
    """K2's inputs at K blocks: h1, x, the halo in strip form (a
    ``StripHalo`` of post-ReLU strips of the 1024x2048 block-128 grid:
    ``n_set`` blocks drawn at random and padding slots after them; by
    default 2 padding slots, none at K = 128, the full grid) and the
    weights."""
    from blockcopy_tpu_torch.tools.measure import strip_halo
    dev = "cuda"

    def rnd(*shape, scale=1.0, relu=False):
        t = torch.randn(shape, generator=gen, device=dev) * scale
        return (t.clamp_min(0) if relu else t).to(dtype)

    if n_set is None:
        n_set = k if k >= N * GH * GW else max(1, k - 2)
    halo = strip_halo(gen, k, bs, cm, dtype, n_set, relu=True)
    return (rnd(k, bs, bs, cm, relu=True), rnd(k, bs, bs, co), halo,
            rnd(cm, cm, 3, 3, scale=(9 * cm) ** -0.5),
            1 + rnd(cm, scale=0.1), rnd(cm, scale=0.1),
            rnd(co, cm, 1, 1, scale=cm ** -0.5),
            1 + rnd(co, scale=0.1), rnd(co, scale=0.1))


def tail_cost(bs, cm, co, itemsize, k=K):
    """K2's operations and the bytes it must move: h1, x, y, each block's
    halo (4 bs + 4 pixels of its neighbours' strips), the weights and the
    block indices, each once."""
    flops = 2 * k * bs * bs * cm * (9 * cm + co)
    elems = (k * bs * bs * (cm + 2 * co) + k * (4 * bs + 4) * cm
             + 9 * cm * cm + cm * co + 2 * cm + 2 * co)
    return flops, elems * itemsize + 8 * k


def phase_tail(gen):
    """K2, its halo read from the strips, at ``TAIL_KS`` x both RN50 shapes
    x bf16 (3e-2) and fp32 (1e-4, TF32 off): against the plain version
    (``torch.allclose``, outputs finite), then the time per launch beside
    its bound (bf16 against 989 TFLOP/s; fp32 against its route, 3 TF32
    products per product on 495 TFLOP/s) and ``halo_pieces`` timed on the
    same strips (K2 + ``halo_pieces``: the two launches the tail took when
    it read gathered pieces), and the fp32 stages' device times; returns
    the per-frame sums at K = 64."""
    from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
    from blockcopy_tpu_torch.tools.measure import device_ms, tail_stage_ms
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, worst = {}, {"bf16": 0.0, "f32": 0.0}
    for k in TAIL_KS:
        for bs, cm, co in sorted(set(TAIL_SHAPES)):
            for name, dtype, tol, products, peak in (
                    ("bf16", torch.bfloat16, 3e-2, 1, BF16_FLOPS),
                    ("f32", torch.float32, 1e-4, 3, TF32_FLOPS)):
                args = _tail_case(gen, bs, cm, co, dtype, k)
                ref = BT.bottleneck_tail_strips_plain(*args).float()
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
                         lambda: BT.bottleneck_tail_strips_plain(*args)),
                     "bound": max(t_ops, t_bytes) * 1e3,
                     "by": "operations" if t_ops > t_bytes else "bytes",
                     "pieces": device_ms(lambda: args[2].pieces())}
                t["two_launch"] = t["kernel"] + t["pieces"]
                rows[(k, bs, cm, co, name)] = t
                if name == "bf16":
                    ctas = f"{2 * k} CTAs in clusters of 2"
                else:
                    stage = tail_stage_ms(lambda: BT.bottleneck_tail(*args))
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
                    f"{t['bound'] / t['kernel']:.1%} of it; {ctas}; "
                    f"halo_pieces on its strips {t['pieces']:.4f} ms, K2 + "
                    f"halo_pieces {t['two_launch']:.4f} ms")
    out = {}
    for name in ("bf16", "f32"):
        per = [rows[(K, *s, name)] for s in TAIL_SHAPES]
        per_step = {key: sum(r[key] for r in per)
                    for key in ("kernel", "plain", "bound", "pieces",
                                "two_launch")}
        by = [r["by"] for r in per]
        per_step["by"] = max(set(by), key=by.count)
        per_step["err"] = worst[name]
        log(f"[3] tail {name} per main-path frame at K={K} "
            f"({len(TAIL_SHAPES)} launches): kernel "
            f"{per_step['kernel']:.4f} ms (the halo gather inside), plain "
            f"{per_step['plain']:.4f} ms, bound {per_step['bound']:.4f} ms "
            f"({per_step['by']}); halo_pieces at the {len(TAIL_SHAPES)} tail "
            f"shapes {per_step['pieces']:.4f} ms, K2 + halo_pieces "
            f"{per_step['two_launch']:.4f} ms")
        out[name] = per_step
    return out


def _rows_case(gen, k, bs, cm, co, entry):
    """One bf16 row-route case: ``entry`` (the wrapper, or the private entry
    that forces the row route) against the plain version (3e-2,
    ``torch.allclose``, finite); returns the inputs and the max abs err."""
    from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
    args = _tail_case(gen, bs, cm, co, torch.bfloat16, k)
    ref = BT.bottleneck_tail_strips_plain(*args).float()
    got = entry(*args)
    err = (got.float() - ref).abs().max().item()
    if not (bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), ref, rtol=3e-2, atol=3e-2)):
        raise AssertionError(f"bottleneck row route disagrees with its plain "
                             f"version at K={k} bs={bs} Cm={cm} Co={co}: max "
                             f"abs err {err:.3g}")
    return args, err


def phase_tail_rows(gen):
    """K2's bf16 row route against its plain version (3e-2,
    ``torch.allclose``, outputs finite) at RN50's block-256 shapes at
    ``TAIL_KS_256``, ``wide_resnet50_2``'s block-128 shapes at ``TAIL_KS``
    and a Co that is no multiple of 256 (16, 128, 640), its halo read from
    the strips: its launch plan, time per launch beside its bound (989
    TFLOP/s, 3.35 TB/s), the plain version's and ``halo_pieces`` on the same
    strips (K2 + ``halo_pieces``: the tail's two launches when it read
    gathered pieces); its parts at the block-256 shapes at K = 2 and 16
    (``tools/tail_breakdown.py``: two more builds with its ablation
    switches); then the row route forced at the wgmma route's blocks, timed
    beside the wgmma route at ``TAIL_KS`` (a reading; no route choice rests
    on it).  Returns the per-frame sums at block 256, K = 16, and at the
    wide shapes, K = 64, and the largest error."""
    from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
    from blockcopy_tpu_torch.tools import tail_breakdown as TBD
    from blockcopy_tpu_torch.tools.measure import device_ms
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = ([(k, sh) for k in TAIL_KS_256
              for sh in sorted(set(TAIL_SHAPES_256))]
             + [(k, sh) for k in TAIL_KS for sh in sorted(set(WIDE_TAIL_SHAPES))]
             + [(K_256, (16, 128, 640))])
    rows, worst = {}, 0.0
    for k, (bs, cm, co) in cases:
        if BT.route(torch.bfloat16, bs, cm, co) != "bottleneck_tail_rows":
            raise AssertionError(f"({bs}, {cm}, {co}) is not a row-route "
                                 f"block")
        args, err = _rows_case(gen, k, bs, cm, co, BT.bottleneck_tail)
        worst = max(worst, err)
        flops, nbytes = tail_cost(bs, cm, co, 2, k)
        t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        t = {"kernel": device_ms(lambda: BT.bottleneck_tail(*args)),
             "plain": device_ms(
                 lambda: BT.bottleneck_tail_strips_plain(*args), samples=20),
             "bound": max(t_ops, t_bytes) * 1e3,
             "by": "operations" if t_ops > t_bytes else "bytes",
             "pieces": device_ms(lambda: args[2].pieces())}
        t["two_launch"] = t["kernel"] + t["pieces"]
        rows[(k, bs, cm, co)] = t
        plan = BT.row_plan(k, bs, cm, co, sms)
        log(f"[3] tail rows K={k:3d} bs={bs} Cm={cm} Co={co} bf16: max abs "
            f"err {err:.3g} (rtol and atol 3e-2) ok; kernel {t['kernel']:.4f} ms "
            f"per launch, plain {t['plain']:.4f} ms, bound {t['bound']:.4f} "
            f"ms ({t['by']}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
            f"kernel at {t['bound'] / t['kernel']:.1%} of it, "
            f"{flops / t['kernel'] / 1e9:.0f} TFLOP/s; one fused launch of "
            f"{k * plan['bands'] * plan['cs']} CTAs: bands of "
            f"{plan['rows']} rows ({plan['bands']} a block, "
            f"{64 * plan['mt']} product rows), clusters of {plan['cs']}, "
            f"{plan['np']}-channel 3x3 passes, {plan['nt']}-channel 1x1 "
            f"tiles, {plan['stages']} ring "
            f"stages, {plan['xbuf']} x/y buffers, {plan['smem']} B shared; "
            f"halo_pieces on its strips {t['pieces']:.4f} ms")
        del args
    out = {}
    for name, shapes, k in (("block256", TAIL_SHAPES_256, K_256),
                            ("wide", WIDE_TAIL_SHAPES, K)):
        per = [rows[(k, *sh)] for sh in shapes]
        out[name] = {key: sum(r[key] for r in per)
                     for key in ("kernel", "plain", "bound", "pieces",
                                 "two_launch")}
        by = [r["by"] for r in per]
        out[name]["by"] = max(set(by), key=by.count)
        log(f"[3] tail rows per {name} frame at K={k} ({len(shapes)} "
            f"launches): kernel {out[name]['kernel']:.4f} ms (the halo "
            f"gather inside), plain {out[name]['plain']:.4f} ms, bound "
            f"{out[name]['bound']:.4f} ms ({out[name]['by']}); halo_pieces "
            f"at the {len(shapes)} tail shapes {out[name]['pieces']:.4f} ms, "
            f"K2 + halo_pieces {out[name]['two_launch']:.4f} ms")
    libs = TBD.build_variants(TBD.PARTS)
    for part in TBD.row_parts(libs, [(k, *sh) for k in (2, K_256)
                                     for sh in sorted(set(TAIL_SHAPES_256))],
                              gen):
        log(f"[3] tail rows parts K={part['k']:3d} bs={part['bs']} "
            f"Cm={part['cm']} Co={part['co']} (tools/tail_breakdown.py): "
            f"full {part['full_us']:.2f} us, 3x3 products "
            f"{part['3x3_products_us']:.2f} us, 1x1 stage "
            f"{part['1x1_stage_us']:.2f} us, staging and the rest "
            f"{part['staging_rest_us']:.2f} us")
    for k in TAIL_KS:
        for bs, cm, co in WGMMA_SHAPES:
            args, err = _rows_case(gen, k, bs, cm, co,
                                   BT._bottleneck_tail_rows)
            worst = max(worst, err)
            forced = device_ms(lambda: BT._bottleneck_tail_rows(*args))
            wgmma = device_ms(lambda: BT.bottleneck_tail(*args))
            log(f"[3] tail bs={bs} Cm={cm} Co={co} bf16 K={k:3d}: row route "
                f"{forced:.4f} ms per launch (max abs err {err:.3g}) against "
                f"the wgmma route's {wgmma:.4f} ms ({forced / wgmma:.2f}x)")
            del args
    out["err"] = worst
    return out


def _drive_stepper(tag, stepper, params, frames, per_frame, watch=None,
                   draws=None):
    """``init_state``, ``first_step`` and a ``step`` per further frame, each
    step under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
    fails the run).  Launch counts are zeroed just before ``init_state`` and
    read after the last step; it checks that ``init_state`` launches
    nothing, that every frame launches ``per_frame``, that every step runs
    ``capacity`` blocks and that the policy is updated exactly at frames
    = 0 (mod 4); a kernel ``per_frame`` does not name launches nothing.
    ``watch(state)`` is kept after each step, and after the first step too
    where ``draws`` is given: ``draws[t]`` is injected into step t (the
    ``draws`` of ``step``).  Returns the last state, the
    launches, ms per step, the trained frames, what ``watch`` kept and the
    peak memory in GiB."""
    from blockcopy_tpu_torch.ops import kernels
    per_frame = {k: per_frame.get(k, 0) for k in kernels.launches}
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
    if watch is not None and draws is not None:
        kept.append(watch(state))
    for t, frame in enumerate(frames[1:]):
        kw = {} if draws is None else {"draws": draws[t]}
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = stepper.step(params, state, frame, **kw)
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
                 "halo_pieces": len(PIECE_SHAPES),
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
        f"{len(HALO_SHAPES)}, halo_pieces {len(PIECE_SHAPES)}, bottleneck "
        f"tail {len(TAIL_SHAPES)})")
    return launches, _log_steps("4", ms, launches, peak), ms


def phase_main_256():
    """(4b) the block-256 path at full width (``_drive_stepper``):
    SwiftNet-RN50 bf16 at block 256, capacity 16 of 32, every fused tail
    on K2's bf16 row route."""
    from blockcopy_tpu_torch.tools.measure import (swiftnet_stepper,
                                                   synthetic_frames)

    torch.backends.cudnn.allow_tf32 = True
    frame_shape, steps, dtype = (1, 1024, 2048, 3), 12, torch.bfloat16
    params, stepper = swiftnet_stepper("resnet50", frame_shape, None, dtype,
                                       "cuda", train_interval=4,
                                       block_size=256)
    if stepper.capacity != 16:
        raise AssertionError(f"block-256 capacity {stepper.capacity}")
    frames = synthetic_frames(frame_shape, steps + 1, dtype)
    per_frame = {"halo_strips": len(HALO_SHAPES_256),
                 "halo_pieces": len(PIECE_SHAPES_256),
                 "bottleneck_tail_rows": len(TAIL_SHAPES_256)}
    state, launches, ms, trained, _, peak = _drive_stepper(
        "4b", stepper, params, frames, per_frame)
    out = stepper.fetch_outputs(state)
    if tuple(out.shape) != (1, 256, 512, 19):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("non-finite outputs")
    log(f"[4b] RN50 1024x2048 bf16 block 256: {steps} steps, no host sync, "
        f"{stepper.capacity} blocks/step, outputs {tuple(out.shape)} finite, "
        f"policy updated at frames {trained} (per frame: halo "
        f"{len(HALO_SHAPES_256)}, halo_pieces {len(PIECE_SHAPES_256)}, "
        f"bottleneck tail rows {len(TAIL_SHAPES_256)})")
    med = _log_steps("4b", ms, launches, peak)
    return launches, {"ms": med, "peak_gib": peak}


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
        # the dense outputs whatever the carried layout
        outs = [stepper.fetch_outputs(state).float().cpu()]
        for t in range(steps):
            state = stepper.step(params, state, frames[t + 1],
                                 draws=draws[t])
            outs.append(stepper.fetch_outputs(state).float().cpu())
        return outs
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
    if (err > 1e-3 or not used["halo_strips"]
            or not used["bottleneck_tail_f32"]):
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
    """One ``model(frame)`` under ``count_syncs``: the output, its host
    syncs, and its host time fenced by ``synchronize``."""
    from blockcopy_tpu_torch.tools.measure import count_syncs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, syncs = count_syncs(model, frame)
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
    # op by op: phase 15c holds the captured engine against it
    model = BlockCopyModel(make_apply_fn(cfg), params, settings,
                           policy=build_policy_from_settings(settings),
                           device="cuda", graphs=False)
    clips = [synthetic_frames(shape, clip_len, dtype, seed=c)
             for c in range(2)]
    ladder = set(capacity_ladder(128, settings["block_quantize_number_exec"]))
    per_exec = {"halo_strips": len(HALO_SHAPES),
                "halo_pieces": len(PIECE_SHAPES),
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
        key = "bottleneck_tail" if "--half" in extra else \
            "bottleneck_tail_f32"
        if (launches["halo_strips"] != 16 * len(HALO_SHAPES)
                or launches["halo_pieces"] != 16 * len(PIECE_SHAPES)
                or launches[key] != 16 * len(TAIL_SHAPES)):
            raise AssertionError(f"CLI {name} launches {launches}, expected "
                                 f"{len(HALO_SHAPES)} K1 strips, "
                                 f"{len(PIECE_SHAPES)} K1 pieces and "
                                 f"{len(TAIL_SHAPES)} K2 a frame")
        line["launches"] = launches
        out[name] = line
    return out


def phase_block_sizes():
    """(d) 1024x2048 ladder frames (the CLI's default settings but the
    block size and the backbone), 4 frames a run: RN50 at block 256 in bf16
    and fp32 and at block 128 in fp32, and ``wide_resnet50_2`` at block 128
    in bf16; launch counts are zeroed just before each run and read just
    after.  K2 launches per executed frame, by route: at block 256 layers
    2-4 (3 + 5 + 2), on the bf16 row route and on the fp32 route; RN50 at
    block 128 layers 2-3 (3 + 5); wide RN50 at block 128 layers 1-3 (2 + 3
    + 5) on the row route.  Every other K2 route launches nothing."""
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.core.engine import BlockCopyModel
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tools.measure import synthetic_frames

    torch.backends.cudnn.allow_tf32 = True
    shape = (1, 1024, 2048, 3)
    # and the halo_pieces launches: one, the stem's plane pool
    k2 = ("halo_pieces", "bottleneck_tail", "bottleneck_tail_rows",
          "bottleneck_tail_f32")
    out = {}
    for backbone, block, dtype, key, per_frame in (
            ("resnet50", 256, torch.bfloat16, "bottleneck_tail_rows", 10),
            ("resnet50", 256, torch.float32, "bottleneck_tail_f32", 10),
            ("resnet50", 128, torch.float32, "bottleneck_tail_f32", 8),
            ("wide_resnet50_2", 128, torch.bfloat16, "bottleneck_tail_rows",
             10)):
        cfg = SwiftNetConfig(backbone=backbone, num_classes=19)
        params = init_swiftnet(cfg, seed=0, dtype=dtype, device="cuda")
        model = BlockCopyModel(make_apply_fn(cfg), params,
                               default_settings(block_size=block),
                               device="cuda")
        frames = synthetic_frames(shape, 4, dtype, seed=5)
        kernels.reset_launches()
        counts, tails, ms = [], [], []
        for frame in frames:
            before = dict(kernels.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = model(frame)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts.append(model.policy_meta["num_exec"])
            tails.append({k: kernels.launches[k] - before[k] for k in k2})
        launches = dict(kernels.launches)
        log(f"[8d] {backbone} 1024x2048 {dtype} block {block}: "
            f"{len(frames)} frames at counts {counts}, K2 launches per frame "
            f"{[t[key] for t in tails]} ({key}), launches {launches}, "
            f"ms/frame {[round(x, 2) for x in ms]}")
        if tuple(y.shape) != (1, 256, 512, 19) or \
                not bool(torch.isfinite(y.float()).all()):
            raise AssertionError(f"{backbone} block {block} {dtype}: outputs "
                                 f"{tuple(y.shape)} not finite")
        want = [{k: 0 if not c else per_frame if k == key
                 else 1 if k == "halo_pieces" else 0 for k in k2}
                for c in counts]
        if tails != want or not counts[0]:
            raise AssertionError(f"{backbone} block {block} {dtype}: K2 "
                                 f"launches {tails}, expected {per_frame} "
                                 f"{key} and 1 halo_pieces per executed "
                                 f"frame")
        out[(backbone, block, str(dtype))] = launches
        del model, params
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
            or not used["halo_strips"] or not used["bottleneck_tail_f32"]):
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
                 "halo_pieces": len(PIECE_SHAPES),
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
            or not used["bottleneck_tail_f32"]):
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
            args = _tail_case(gen, bs, cm, co, dtype, DET_K, DET_K - 3)
            ref = BT.bottleneck_tail_strips_plain(*args).float()
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
            "plain_ms": device_ms(
                lambda: BT.bottleneck_tail_strips_plain(*args)),
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
    model.graphs = False        # op by op, as phase 8a
    settings, thr = model.settings, model.cfg.score_thr
    verbose = settings["block_policy_verbose"]
    clips = [synthetic_frames(shape, clip_len, dtype, seed=c)
             for c in range(2)]
    ladder = set(capacity_ladder(128, settings["block_quantize_number_exec"]))
    per_exec = {"halo_strips": len(DET_HALO_SHAPES),
                "halo_pieces": len(PIECE_SHAPES),
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
    from blockcopy_tpu_torch.tools.measure import count_syncs
    from blockcopy_tpu_torch.utils.checkpoint import save_params

    torch.backends.cudnn.allow_tf32 = True
    out = {}
    executed = [0]
    decode = CSPBlockCopy._decode
    step_only, upload = cli._StepperDetector.step_only, cli.to_device
    step_syncs, capture_syncs = [], []

    def counted(self, maps):
        executed[0] += 1
        return decode(self, maps)

    def watched(self, img):
        # speed mode: a steady frame (after a clip's first) makes no sync;
        # its upload is counted with it.  A step that captures its graph
        # (the first plain and the first train step) is no steady frame:
        # its syncs are kept apart
        if self._frame_id == 0:
            return step_only(self, img)
        kinds = len(self.graphs.graphs)
        syncs = count_syncs(step_only, self, img)[1]
        if len(self.graphs.graphs) > kinds:
            capture_syncs.append(syncs)
        else:
            step_syncs[-1] += syncs

    def watched_upload(a, device):
        out, syncs = count_syncs(upload, a, device)
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
                key = "bottleneck_tail" if "--half" in extra else \
                    "bottleneck_tail_f32"
                if (frames < 2
                        or launches["halo_strips"]
                        != frames * len(DET_HALO_SHAPES)
                        or launches[key] != frames * len(DET_TAIL_SHAPES)):
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
        f"frames (upload, and step for a clip's frames 2-8 that replayed "
        f"their graph) {step_syncs}; in the {len(capture_syncs)} steps "
        f"that captured one {capture_syncs}")
    if len(step_syncs) != 16 or any(step_syncs) or len(capture_syncs) != 2:
        raise AssertionError(f"speed-mode steady frames made host syncs "
                             f"{step_syncs} (captures {capture_syncs})")
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
            or not used["halo_strips"] or not used["bottleneck_tail_f32"]):
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
    floor = halo_launch_floor(gen)
    log(f"[10d] halo launch floor (halo_gather_strips at K=1, bs=4, C=8 "
        f"bf16): {floor:.4f} ms a launch")
    out = {"floor": floor}
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
                args = _tail_case(gen, bs, cm, co, dtype, k, n_set)
                ref = BT.bottleneck_tail_strips_plain(*args).float()
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
                "plain_ms": device_ms(
                    lambda: BT.bottleneck_tail_strips_plain(*args)),
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
                            for key, v in out[(name, k)].items())
                + (f"; launch floor {floor:.4f}, x{len(shapes)} = "
                   f"{floor * len(shapes):.4f}" if name == "halo" else ""))
    out["tail_err"] = tail_err
    return out


# phase 11's full-width training: the train CLI's defaults (CSP-R50, fp32,
# 640x1280 crops, batch 2)
TRAIN_CROP, TRAIN_BATCH, TRAIN_STEPS = (640, 1280), 2, 12


def _train_setup():
    """Phase 11a's workload: CSP-R50 at ``CSPConfig()``, the CLI's
    schedule, its ``TRAIN_STEPS`` synthetic batches on the card, and the
    initial parameters (seed 0).  cuDNN's TF32 on, matmul's off: torch's
    defaults, as the train CLI runs."""
    from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
    from blockcopy_tpu_torch.tasks.detection import train as T
    from blockcopy_tpu_torch.tasks.detection.train_dataset import \
        SyntheticDetTrainDataset

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = CSPConfig()
    tcfg = T.TrainConfig(iters_per_epoch=32)      # the CLI's lr and warm-up
    ds = SyntheticDetTrainDataset(TRAIN_STEPS * TRAIN_BATCH, *TRAIN_CROP,
                                  seed=0)
    batches = []
    for i in range(TRAIN_STEPS):
        items = [ds[TRAIN_BATCH * i + j] for j in range(TRAIN_BATCH)]
        batches.append([torch.from_numpy(np.stack([it[k] for it in items]))
                        .cuda() for k in range(4)])
    return cfg, tcfg, batches, init_csp(cfg, seed=0, device="cuda")


def phase_train():
    """(11a) the detection train step at full width as the CLI runs it (one
    CUDA graph, captured at the first step), timed directly: 12 steps, each
    under ``set_sync_debug_mode("error")`` (the losses, cloned out of the
    graph's buffers, are read after the last), launch counts zeroed just
    before the first; ms/step (median of steps 3-12, synchronize-fenced),
    the capture's seconds and peak memory."""
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tasks.detection import train as T

    cfg, tcfg, batches, params = _train_setup()
    state = T.init_train_state(params, tcfg)
    step = T.make_train_step(cfg, tcfg, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    ms, totals = [], []
    for imgs, *maps in batches:
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, losses = step(state, imgs, tuple(maps))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        totals.append(losses["loss_total"].clone())
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    totals = torch.stack(totals).tolist()
    med = statistics.median(ms[2:])
    capture_s = [g.capture_s for g in step.calls.graphs.values()]
    log(f"[11a] train step CSP-R50 fp32 {TRAIN_CROP[0]}x{TRAIN_CROP[1]} "
        f"batch {TRAIN_BATCH} (cuDNN TF32 on, matmul TF32 off), "
        f"{TRAIN_STEPS} steps as one CUDA graph (captured at step 1 in "
        f"{capture_s} s, its eager run included), no host sync: "
        f"ms/step (host clock, synchronize-fenced, steps 3-{TRAIN_STEPS}) "
        f"median {med:.2f}, min {min(ms[2:]):.2f}, max {max(ms[2:]):.2f}; "
        f"all {[round(x, 2) for x in ms]}; peak memory {peak:.2f} GiB; "
        f"loss_total {[round(x, 4) for x in totals]}; launches {launches}")
    if (any(launches.values()) or not np.isfinite(totals).all()
            or int(state["step"]) != TRAIN_STEPS or len(capture_s) != 1
            or len(set(totals)) < TRAIN_STEPS):
        raise AssertionError(f"train step: launches {launches}, losses "
                             f"{totals}, step {int(state['step'])}, graphs "
                             f"{len(capture_s)}")
    return launches, {"ms": med, "peak_gib": peak, "syncs": 0,
                      "capture_s": capture_s[0]}


def phase_train_cli(tmp, tag="11a"):
    """(11a) the train CLI in-process at phase 11's arguments (``--synthetic
    --epochs 1 --steps-per-epoch 8 --workers 2 --warmup-iters 0``), each
    train step counted for host syncs (log steps read the losses after
    theirs): no host sync in a train step (the capture's too), finite
    losses, ``step`` 8, one graph, the three checkpoints written.  Returns the teacher checkpoint's path, the
    launches and the capture's seconds."""
    import contextlib
    import io
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tasks.detection import train_cli
    from blockcopy_tpu_torch.tools.measure import count_syncs

    make = train_cli.make_train_step
    syncs, made = [], []

    def watched_make(*a, **kw):
        step = make(*a, **kw)
        made.append(step)

        def watched(*args):
            out, n = count_syncs(step, *args)
            syncs.append(n)
            return out
        return watched

    argv = ["--synthetic", "--epochs", "1", "--steps-per-epoch", "8",
            "--workers", "2", "--warmup-iters", "0", "--out", str(tmp)]
    buf = io.StringIO()
    train_cli.make_train_step = watched_make
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = train_cli.main(argv)
    finally:
        train_cli.make_train_step = make
    launches = dict(kernels.launches)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    files = {f: (Path(tmp) / f).is_file() for f in (
        "epoch_1.npz", "epoch_1_teacher.npz", "latest_state.npz")}
    graphs = [g.capture_s for s in made for g in s.calls.graphs.values()]
    log(f"[{tag}] train CLI {' '.join(argv[:-2])}: {json.dumps(line)}; "
        f"{time.perf_counter() - t0:.1f} s with checkpoints {files}; graphs "
        f"captured {len(graphs)} in {graphs} s (step 1, its eager run "
        f"included); host syncs per train step {syncs}; "
        f"launches {launches}")
    losses = list(line["first_losses"].values()) \
        + list(line["final_losses"].values())
    if (line != res or res["step"] != 8 or not all(files.values())
            or not np.isfinite(losses).all() or any(syncs)
            or len(syncs) != 8 or any(launches.values())
            or len(graphs) != 1):
        raise AssertionError(f"train CLI: {line}, files {files}, syncs "
                             f"{syncs}, launches {launches}, graphs "
                             f"{graphs}")
    return str(Path(tmp) / "epoch_1_teacher.npz"), launches, graphs[0]


def phase_trained_detection_cli(teacher):
    """(11b) the detection CLI on the trained teacher checkpoint, ladder
    bf16 at 1024x2048 from the shipped 0.3 config: 13 K1 and 8 K2 launches
    per frame that ran blocks, counts zeroed just before the run."""
    import contextlib
    import io
    from blockcopy_tpu_torch.models.csp import CSPBlockCopy
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tasks.detection import eval as cli

    torch.backends.cudnn.allow_tf32 = True
    decode = CSPBlockCopy._decode
    executed = [0]

    def counted(self, maps):
        executed[0] += 1
        return decode(self, maps)

    argv = ["--synthetic", "--res", "1024", "--clip-length", "8",
            "--num-clips-warmup", "1", "--num-clips-eval", "1", "--config",
            str(DET_CONFIG), "--checkpoint", teacher, "--half"]
    buf = io.StringIO()
    CSPBlockCopy._decode = counted
    kernels.reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            res = cli.main(argv)
    finally:
        CSPBlockCopy._decode = decode
    launches = dict(kernels.launches)
    frames = executed[0]
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"[11b] detection CLI ladder bf16 on the trained teacher "
        f"checkpoint: {json.dumps(line)}; launches {launches}, frames that "
        f"ran blocks {frames}")
    if (line["fps"] != res["fps"] or frames < 2
            or launches["halo_strips"] != frames * len(DET_HALO_SHAPES)
            or launches["bottleneck_tail"] != frames * len(DET_TAIL_SHAPES)):
        raise AssertionError(
            f"trained-checkpoint CLI launches {launches} over {frames} "
            f"frames, expected {len(DET_HALO_SHAPES)} K1 and "
            f"{len(DET_TAIL_SHAPES)} K2 a frame")
    return {"launches": launches, "frames": frames, "fps": line["fps"]}


def phase_train_modes():
    """(11c) two train steps of CSP (1, 2, 2, 1) at 128x256 fp32 on the GPU
    against the CPU, TF32 off in cuDNN and matmul
    (``tools/measure.py`` ``train_parity``): losses within 1e-4 relative,
    every gradient leaf within 1e-4 of its largest |CPU value| with the
    GPU's ReLUs given the CPU's masks (which may disagree only within 1e-5
    of the input's largest value), the same key sets, and the Adam + EMA
    update fed the CPU's gradients within 1e-6."""
    from blockcopy_tpu_torch.tools.measure import train_parity

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report = train_parity(steps=2)
    torch.backends.cudnn.allow_tf32 = True
    for r in report:
        log(f"[11c] train step {r['step']} GPU vs CPU (TF32 off): "
            f"{json.dumps(r)}")
    if any(r["loss_err"] > 1e-4 or r["grad_err"] > 1e-4
           or not r["grad_keys_equal"] or r["flip_max_rel_input"] > 1e-5
           or r["update_err"] > 1e-6 for r in report):
        raise AssertionError("GPU train step disagrees with the CPU")
    return report


def phase_validation():
    """(11d) the validation tool at reduced counts (``--train-iters 150
    --warmup-clips 4 --eval-clips 4 --skip-flag-ab``): the loss falls at
    least 10x, and the BlockCopy mode launches 13 K1 and 8 K2 per frame
    (every frame runs blocks; counts zeroed just before the mode)."""
    import contextlib
    import io
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tools import validate_detection as V

    torch.backends.cudnn.allow_tf32 = True
    run_mode = V.run_blockcopy_mode
    seen = {}

    def counted(*a, **kw):
        kernels.reset_launches()
        out = run_mode(*a, **kw)
        seen.update(kernels.launches)
        return out

    argv = ["--train-iters", "150", "--warmup-clips", "4", "--eval-clips",
            "4", "--skip-flag-ab"]
    buf = io.StringIO()
    V.run_blockcopy_mode = counted
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = V.main(argv)
    finally:
        V.run_blockcopy_mode = run_mode
    frames = (4 + 4) * V.CLIP_LEN
    train = res["train"]
    log(f"[11d] validation tool {' '.join(argv)} "
        f"({time.perf_counter() - t0:.1f} s): train {json.dumps(train)}; "
        + "; ".join(f"{k}: MR {json.dumps(v['mr'])}, F1 vs dense "
                    f"{v['agreement_f1_vs_dense']:.4f}"
                    + (f", exec rate {v['exec_rate_eval']:.4f}"
                       if "exec_rate_eval" in v else "")
                    for k, v in res["modes"].items())
        + f"; BlockCopy mode launches {seen} over {frames} frames")
    if (not train["loss_first"] >= 10 * train["loss_last"]
            or seen.get("halo_strips") != frames * len(DET_HALO_SHAPES)
            or seen.get("bottleneck_tail")
            != frames * len(DET_TAIL_SHAPES)):
        raise AssertionError(f"validation tool: train {train}, launches "
                             f"{seen}")
    return {"launches": seen, "frames": frames, "result": res}


def _check_ranks(tag, ranks, per_frame, frames):
    """The ranks of one clip-parallel run: each rank launched ``per_frame``
    kernels a frame over ``frames`` frames and nothing else, its outputs
    are finite, it trained at frames 4, 8, ... only, and after every
    update the policy parameters are bitwise equal across the ranks and
    moved.  Returns per rank: the launches, the median ms/frame of steps
    3 on, the train frames' syncs and the peak memory."""
    want = {k: per_frame.get(k, 0) * frames for k in ranks[0]["launches"]}
    train = [f for f in range(2, frames + 1) if f % 4 == 0]
    for r, res in enumerate(ranks):
        if res["launches"] != want or not res["finite"]:
            raise AssertionError(f"[{tag}] rank {r}: launches "
                                 f"{res['launches']} (expected {want}), "
                                 f"finite outputs {res['finite']}")
        if [f for f, _ in res["trained"]] != train:
            raise AssertionError(f"[{tag}] rank {r} trained at "
                                 f"{res['trained']}, expected {train}")
    digests = [res["digests"] for res in ranks]
    if any(d != digests[0] for d in digests) or \
            len(set(digests[0])) != len(digests[0]):
        raise AssertionError(f"[{tag}] policy digests per train frame "
                             f"{digests}")
    out = []
    for r, res in enumerate(ranks):
        med = statistics.median(res["ms"][2:])
        out.append({"launches": res["launches"], "ms": med,
                    "syncs": [n for _, n in res["trained"]],
                    "peak_gib": res["peak_gib"]})
        log(f"[{tag}] rank {r}: launches {res['launches']}, ms/frame median "
            f"{med:.2f} (steps 3-{len(res['ms'])}; all "
            f"{[round(x, 2) for x in res['ms']]}), train frames (frame, host "
            f"syncs) "
            f"{res['trained']}, peak memory {res['peak_gib']:.2f} GiB")
    log(f"[{tag}] policy parameters bitwise equal across {len(ranks)} "
        f"ranks after the updates at frames {train}")
    return out


def _steady_fps(ranks):
    """Frames a second of steps 4 on (after the first update, whose first
    backward pass warms up for ~0.5 s) of every rank together: their
    frames over the window from the first rank's start of step 4 to the
    last rank's end (one host clock)."""
    window = max(r["stamps"][-1][1] for r in ranks) \
        - min(r["stamps"][3][0] for r in ranks)
    return sum(len(r["stamps"]) - 3 for r in ranks) / window


def phase_parallel(main_ms):
    """Phase 12 (module docstring); ``main_ms`` are phase 4's step times."""
    import contextlib
    import io
    import os
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.parallel import clip_parallel
    from blockcopy_tpu_torch.tasks.semseg import eval as cli
    from blockcopy_tpu_torch.tools.measure import parallel_stepper_rank

    steps = 12
    per_frame = {"halo_strips": len(HALO_SHAPES),
                 "halo_pieces": len(PIECE_SHAPES),
                 "bottleneck_tail": len(TAIL_SHAPES)}
    two = clip_parallel.make_group(2, ["cuda:0", "cuda:0"], backend="gloo")
    t0 = time.perf_counter()
    ranks = clip_parallel.spawn(two, parallel_stepper_rank, "swiftnet",
                                steps, timeout=600)
    log(f"[12a] two gloo ranks on cuda:0: spawned, built and stepped in "
        f"{time.perf_counter() - t0:.1f} s")
    a = _check_ranks("12a", ranks, per_frame, steps + 1)
    agg = _steady_fps(ranks)
    one = (len(main_ms) - 3) / (sum(main_ms[3:]) / 1e3)
    log(f"[12a] aggregate {agg:.2f} frames/s over steps 4-{steps} of both "
        f"ranks against {one:.2f} for phase 4's one rank ({agg / one:.3f}x); "
        f"syncs a train frame per rank {[r['syncs'] for r in a]}")

    own = [r["grad_own"] for r in ranks]
    mean = ranks[0]["grad_mean"]
    if not torch.equal(mean, ranks[1]["grad_mean"]):
        raise AssertionError("[12c] the ranks' averaged gradients differ")
    want = (own[0] + own[1]) / 2
    grad_err = (mean - want).abs().max().item()
    scale = want.abs().max().item()
    if grad_err > 1e-7 * scale:
        raise AssertionError(f"[12c] averaged gradient {grad_err:.3g} from "
                             f"the mean of the ranks' own (scale {scale:.3g})")
    log(f"[12c] averaged gradient ({mean.numel()} values) against the mean "
        f"of the two ranks' own gradients: max abs err {grad_err:.3g} "
        f"(largest |value| {scale:.3g}), bitwise equal on both ranks")

    t0 = time.perf_counter()
    nccl = clip_parallel.spawn(clip_parallel.make_group(1, ["cuda:0"],
                                                        backend="nccl"),
                               parallel_stepper_rank, "swiftnet", steps,
                               timeout=600)
    b = _check_ranks("12b", nccl, per_frame, steps + 1)
    one_nccl = _steady_fps(nccl)
    log(f"[12b] NCCL world of one: every frame without a host sync, "
        f"{b[0]['ms']:.2f} ms/frame, {one_nccl:.2f} frames/s over steps "
        f"4-{steps} (12a's two ranks: {agg / one_nccl:.3f}x) "
        f"({time.perf_counter() - t0:.1f} s)")

    argv = ["--synthetic", "--res", "1024", "--model-backbone", "resnet50",
            "--half", "--speed-mode", "--num-devices", "1", "--clip-length",
            "4", "--num-clips-warmup", "1", "--num-clips-eval", "1",
            "--model-checkpoint", ""]
    buf = io.StringIO()
    before = os.environ.get("WORLD_SIZE")
    os.environ["WORLD_SIZE"] = "1"
    kernels.reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            res = cli.main(argv)
    finally:
        if before is None:
            del os.environ["WORLD_SIZE"]
        else:
            os.environ["WORLD_SIZE"] = before
    cli_launches = dict(kernels.launches)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if (torch.distributed.is_initialized() or line["fps"] != res["fps"]
            or cli_launches["halo_strips"] != 8 * len(HALO_SHAPES)
            or cli_launches["halo_pieces"] != 8 * len(PIECE_SHAPES)
            or cli_launches["bottleneck_tail"] != 8 * len(TAIL_SHAPES)):
        raise AssertionError(f"[12d] CLI under WORLD_SIZE=1: {line}, "
                             f"launches {cli_launches}")
    log(f"[12d] semseg CLI --num-devices 1 under WORLD_SIZE=1: "
        f"{json.dumps(line)}; launches {cli_launches}")

    det_per_frame = {"halo_strips": len(DET_HALO_SHAPES),
                     "halo_pieces": len(PIECE_SHAPES),
                     "bottleneck_tail": len(DET_TAIL_SHAPES)}
    det = clip_parallel.spawn(two, parallel_stepper_rank, "csp", 8,
                              timeout=600)
    d = _check_ranks("12d", det, det_per_frame, 9)
    return {"two_ranks": a, "aggregate_fps": agg, "single_fps": one,
            "nccl_fps": one_nccl,
            "grad_err": grad_err, "nccl": b, "cli": line,
            "cli_launches": cli_launches, "detection": d}


# phase 13's Cityscapes-layout directory: 2 clips of 4 frames a split,
# 1024x2048 (20 files: 16 sequence frames and 4 annotated ones)
NATIVE_CLIPS, NATIVE_FRAMES = 2, 4
# the validation tool at reduced counts (13c)
CAPABILITY_ARGV = ["--warmup-clips", "2", "--eval-clips", "1",
                   "--clip-length", "4"]


def _median_ms(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_native_io(root):
    """(13a) the clip IO library: build seconds and the zlib finding; a
    Cityscapes-layout directory of 1024x2048 PNGs written without PIL
    (``tools/measure.py``: every row filter); same-size decode bitwise
    against ``(img/255 - mean)/std``; gray and palette labels; the 20-frame
    clip decoded on 6 threads at 1024x2048 and resized to 512x1024 (median
    of 3); ``nms``/``soft_nms`` against ``ops/nms.py``."""
    import ctypes
    from blockcopy_tpu_torch import native
    from blockcopy_tpu_torch.data.cityscapes_vid import CityscapesVid
    from blockcopy_tpu_torch.ops.kernels import build
    from blockcopy_tpu_torch.ops.nms import nms_mask, soft_nms_numpy
    from blockcopy_tpu_torch.tools import measure

    t0 = time.perf_counter()
    build.build(["io"])
    build_s = time.perf_counter() - t0
    zlib = ctypes.CDLL("libz.so.1")
    zlib.zlibVersion.restype = ctypes.c_char_p
    zver = zlib.zlibVersion().decode()
    t0 = time.perf_counter()
    files = measure.cityscapes_layout(root, 1024, 2048, clips=NATIVE_CLIPS,
                                      frames=NATIVE_FRAMES, labels=False)
    write_s = time.perf_counter() - t0
    paths = sorted(str(p) for p in Path(root).rglob("*_leftImg8bit.png"))
    if len(paths) != files or files != 2 * NATIVE_CLIPS * (NATIVE_FRAMES + 1):
        raise AssertionError(f"13a wrote {files} files: {paths}")

    mean = np.asarray(CityscapesVid.mean, np.float32)
    std = np.asarray(CityscapesVid.std, np.float32)
    # the first annotated frame: split 0, clip 0, its last frame
    first = Path(root) / "leftImg8bit" / "train" / "synth" / \
        "synth_000000_000019_leftImg8bit.png"
    img = measure.street_frame(1024, 2048, 0, NATIVE_FRAMES - 1)
    got = native.decode_image(str(first), 2048, 1024, mean, std)
    if not np.array_equal(got, (img.astype(np.float32) / 255.0 - mean)
                          / std):
        raise AssertionError(f"13a decode of {first} is not bitwise "
                             "(img/255 - mean)/std")
    rs = np.random.RandomState(0)
    lab = rs.randint(0, 34, (256, 512)).astype(np.uint8)
    for name, palette in (("gray", None),
                          ("palette", rs.randint(0, 256, (256, 3)))):
        path = Path(root) / f"label_{name}.png"
        measure.write_png(path, lab, palette)
        if not np.array_equal(native.decode_label(str(path)), lab):
            raise AssertionError(f"13a {name} label decode")

    clip = {}
    for h, w in ((1024, 2048), (512, 1024)):
        out = native.decode_clip(paths, w, h, mean, std, num_threads=6)
        if out.shape != (len(paths), h, w, 3) or not np.isfinite(out).all():
            raise AssertionError(f"13a clip decode {out.shape}")
        clip[h] = _median_ms(lambda: native.decode_clip(
            paths, w, h, mean, std, num_threads=6)) / len(paths)

    nms_ok = 0
    for seed in range(4):
        rs = np.random.RandomState(seed)
        xy = rs.rand(200, 2) * 400
        dets = np.concatenate([xy, xy + rs.rand(200, 2) * 60 + 5,
                               rs.rand(200, 1)], 1).astype(np.float32)
        order = np.argsort(-dets[:, 4], kind="mergesort")
        keep = native.nms(dets, 0.5)
        mask = nms_mask(torch.from_numpy(dets[order, :4]),
                        torch.from_numpy(dets[order, 4]), 0.5).numpy()
        rows, kept = native.soft_nms(dets, 0.3, "linear", min_score=0.05)
        nrows, nkept = soft_nms_numpy(dets, 0.3, "linear", min_score=0.05)
        if (set(keep.tolist()) != set(order[mask].tolist())
                or not np.array_equal(kept, nkept)
                or not np.allclose(rows, nrows, rtol=1e-5, atol=1e-6)):
            raise AssertionError(f"13a NMS disagrees with ops/nms.py "
                                 f"(seed {seed})")
        nms_ok += 1
    log(f"[13a] clip IO library built in {build_s:.2f} s (g++ "
        f"{' '.join(build.GXX_FLAGS)}; zlib: <zlib.h> found, libz "
        f"{zver} linked); {files} 1024x2048 PNGs written without PIL in "
        f"{write_s:.1f} s; decode bitwise against (img/255 - mean)/std, "
        f"gray and palette labels exact; {len(paths)}-frame clip on 6 "
        f"threads: {clip[1024]:.2f} ms a frame at 1024x2048, "
        f"{clip[512]:.2f} ms a frame resized to 512x1024 (median of 3); "
        f"nms and soft_nms agree with ops/nms.py on {nms_ok} sets")
    return {"build_s": build_s, "zlib": zver, "decode_ms": clip[1024],
            "decode_512_ms": clip[512]}


def phase_native_cli(root, synthetic_fps, step_ms):
    """(13b) the semseg CLI in-process on the 13a directory with
    ``--native-io --fast --speed-mode --half --model-backbone resnet50
    --clip-length 4`` and PIL unimportable: 2 + 2 clips of 4 frames, 12 K1
    ``halo_strips``, 1 ``halo_pieces`` and 8 K2 (``wgmma`` route) launches
    a frame (counts zeroed just before); FPS beside phase 8b's synthetic
    CLI, and the decode's ms a frame (the dataset's ``decode_clip`` calls,
    on the loader's threads) beside phase 4's step."""
    import contextlib
    import io
    from blockcopy_tpu_torch import native
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tasks.semseg import eval as cli

    torch.backends.cudnn.allow_tf32 = True
    argv = ["--cityscapes-dir", str(root), "--native-io", "--fast",
            "--speed-mode", "--half", "--model-backbone", "resnet50",
            "--clip-length", str(NATIVE_FRAMES), "--model-checkpoint", ""]
    decode = native.decode_clip
    spent = []

    def timed(paths, *a, **kw):
        t0 = time.perf_counter()
        out = decode(paths, *a, **kw)
        spent.append(((time.perf_counter() - t0) * 1e3, len(paths)))
        return out

    blocked = {k: sys.modules.get(k) for k in ("PIL", "PIL.Image")}
    buf = io.StringIO()
    native.decode_clip = timed
    sys.modules.update({k: None for k in blocked})
    kernels.reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            res = cli.main(argv)
    finally:
        native.decode_clip = decode
        for k, v in blocked.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    launches = dict(kernels.launches)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    frames = 2 * NATIVE_CLIPS * NATIVE_FRAMES
    per_frame = {"halo_strips": len(HALO_SHAPES),
                 "halo_pieces": len(PIECE_SHAPES),
                 "bottleneck_tail": len(TAIL_SHAPES),
                 "bottleneck_tail_rows": 0, "bottleneck_tail_f32": 0}
    decode_ms = sum(ms for ms, _ in spent) / sum(n for _, n in spent)
    log(f"[13b] CLI {' '.join(argv[2:])} on a Cityscapes-layout directory, "
        f"PIL unimportable: {json.dumps(line)}; launches {launches} over "
        f"{frames} frames; FPS {line['fps']:.2f} against phase 8b's "
        f"synthetic speed-mode {synthetic_fps:.2f}; decode "
        f"{decode_ms:.2f} ms a frame ({len(spent)} clips on the loader's "
        f"threads) against phase 4's step {step_ms:.2f} ms a frame")
    if (line["fps"] != res["fps"] or not line["fps"] > 0
            or "Mean IoU" in line or len(spent) != 2 * NATIVE_CLIPS
            or any(launches[k] != frames * n for k, n in per_frame.items())):
        raise AssertionError(f"13b CLI {line}, launches {launches}, "
                             f"decodes {spent}")
    return {"fps": line["fps"], "decode_ms": decode_ms,
            "launches": launches}


def phase_capability():
    """(13c) the semseg validation tool at reduced counts (2 warmup clips,
    1 eval clip, 4 frames), 512x1024 fp32, launch counts zeroed just before
    each run: RN18 ``ref`` launches K1 only; RN50 ``fast`` at amp 8 K1 and
    K2 on its fp32 route.  The JSON has the keys of ``VALIDATION.json``,
    every rate lies in [0, 1], 2 frames are evaluated."""
    import contextlib
    import io
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tools import validate_capability as V

    torch.backends.cudnn.allow_tf32 = True
    keys = list(json.loads((ROOT / "VALIDATION.json").read_text()))
    out = {}
    for name, extra in (("resnet18", []),
                        ("resnet50", ["--backbone", "resnet50",
                                      "--policy-arch", "fast",
                                      "--object-amp", "8.0"])):
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = V.main(CAPABILITY_ARGV + extra)
        secs = time.perf_counter() - t0
        launches = dict(kernels.launches)
        log(f"[13c] validate_capability {' '.join(CAPABILITY_ARGV + extra)}"
            f" ({secs:.1f} s): {json.dumps(res)}; launches {launches}")
        k2 = {k: launches[k] for k in ("bottleneck_tail",
                                       "bottleneck_tail_rows",
                                       "bottleneck_tail_f32")}
        k2_ok = (not any(k2.values()) if name == "resnet18" else
                 k2["bottleneck_tail_f32"] > 0
                 and k2["bottleneck_tail"] == k2["bottleneck_tail_rows"] == 0)
        rates_ok = all(0 <= res[k] <= 1 for k in (
            "exec_rate_final_mean", "running_cost", "agreement_vs_dense",
            "agreement_frozen_baseline", "moving_block_exec_rate"))
        if (list(res) != keys or not rates_ok
                or res["frames_evaluated"] != 2
                or not launches["halo_strips"] > 0 or not k2_ok):
            raise AssertionError(f"13c {name}: {res}, launches {launches}")
        out[name] = {"result": res, "launches": launches, "seconds": secs}
    return out


# phase 14: the off-by-default lowerings on the main path, each with its K1
# launches a frame by entry (bs, C); K2 stays at TAIL_SHAPES under every one.
# BORDER_CONV takes every 3x3 conv and the pool through halo_pieces (only
# the stem's s2d cells stay on halo_strips); S2D_STEM (plane pool off) adds
# the stem pool's exchange at bs 64 and drops the plane pool's pieces
SWITCH_RUNS = [
    ("BORDER_CONV", {"BORDER_CONV": True}, HALO_SHAPES[:1],
     PIECE_SHAPES + HALO_SHAPES[1:]),
    ("S2D_STEM", {"S2D_STEM": True, "STEM_PLANE_POOL": False},
     HALO_SHAPES + [(64, 64)], PIECE_SHAPES[1:]),
    ("TALL_CONV_BS=8", {"TALL_CONV_BS": 8}, HALO_SHAPES, PIECE_SHAPES),
    ("OUT_BLOCKS", {"OUT_BLOCKS": True}, HALO_SHAPES, PIECE_SHAPES),
    ("PACKED_OUT", {"PACKED_OUT": True}, HALO_SHAPES, PIECE_SHAPES),
    ("POLICY_SPLIT_STEM", {"POLICY_SPLIT_STEM": True}, HALO_SHAPES,
     PIECE_SHAPES),
    ("POLICY_STEM_CONV4=0", {"POLICY_STEM_CONV4": False}, HALO_SHAPES,
     PIECE_SHAPES),
    # every switch that combines (PACKED_OUT yields to OUT_BLOCKS, the split
    # stem needs the conv4 stem, TALL_CONV_BS finds no conv BORDER_CONV
    # leaves it)
    ("all", {"BORDER_CONV": True, "S2D_STEM": True, "STEM_PLANE_POOL": False,
             "TALL_CONV_BS": 8, "OUT_BLOCKS": True, "POLICY_SPLIT_STEM": True},
     HALO_SHAPES[:1], PIECE_SHAPES[1:] + [(64, 64)] + HALO_SHAPES[1:]),
]
# equal grids in the bf16 run: the same numbers in another layout
LAYOUT_SWITCHES = ("OUT_BLOCKS", "PACKED_OUT")
# equal grids with fp32 policy convs (bf16 ones round the two forms apart)
STEM_FORMS = ("POLICY_SPLIT_STEM", "POLICY_STEM_CONV4=0")
SWITCH_TOL = 3e-2
# 14c: the share of each frame's kept boxes that must pair, and the unpaired
# boxes (both sides, all at a cut) allowed a frame over the clip; bf16
# rounding swaps a few boxes at the 100th kept score (98-99 of 100 paired,
# 22 unpaired over 9 frames on the H100)
BOX_PAIRED, BOX_UNPAIRED = 0.95, 4


def _clip_agreement(ref, got):
    """Frames (from the first) whose grids equal the reference run's, and
    the largest output error over those frames relative to the largest
    |reference output| (later frames ran other blocks)."""
    same = 0
    for a, b in zip(ref["grids"], got["grids"]):
        if not torch.equal(a, b):
            break
        same += 1
    err = max((o - r).abs().max().item() / r.abs().max().item()
              for o, r in zip(got["outs"][:same], ref["outs"][:same]))
    return same, err


def phase_switches():
    """(14a) the main path (phase 4's parameters, frames, capacity) with
    injected draws, switch off and under each lowering of ``SWITCH_RUNS``,
    set in-process (``tools/measure.py`` ``switches``): no host sync, the
    K1 and K2 launches a frame, ms/frame, and agreement with the switch-off
    run; then the switch-off run and the two stem forms again with fp32
    policy convs."""
    from blockcopy_tpu_torch.tools.measure import (swiftnet_stepper,
                                                   switches,
                                                   synthetic_frames)

    torch.backends.cudnn.allow_tf32 = True
    frame_shape, steps, dtype = (1, 1024, 2048, 3), 12, torch.bfloat16
    params, stepper = swiftnet_stepper("resnet50", frame_shape, K, dtype,
                                       "cuda", train_interval=4)
    frames = synthetic_frames(frame_shape, steps + 1, dtype)
    gen = torch.Generator().manual_seed(14)
    draws = [(torch.rand((N, GH, GW), generator=gen).cuda(),
              torch.rand((N * GH * GW,), generator=gen).cuda())
             for _ in range(steps)]

    def run(tag, sw, strips, pieces):
        per_frame = {"halo_strips": len(strips),
                     "halo_pieces": len(pieces),
                     "bottleneck_tail": len(TAIL_SHAPES)}
        with switches(**sw):
            _, launches, ms, trained, kept, peak = _drive_stepper(
                f"14a {tag}", stepper, params, frames, per_frame,
                watch=lambda st: (st["prev_grid"].clone(),
                                  stepper.fetch_outputs(st).clone()),
                draws=draws)
        outs = [o for _, o in kept]
        if not all(bool(torch.isfinite(o.float()).all()) for o in outs):
            raise AssertionError(f"14a {tag}: non-finite outputs")
        return {"ms": statistics.median(ms[2:]), "peak_gib": peak,
                "per_frame": per_frame, "launches": launches,
                "trained": trained, "grids": [g for g, _ in kept],
                "outs": [o.float() for o in outs]}

    ref = run("off", {}, HALO_SHAPES, PIECE_SHAPES)
    log(f"[14a] off: {ref['ms']:.2f} ms/frame, 0 host syncs, per frame "
        f"{ref['per_frame']}, policy updated at frames {ref['trained']}")
    out = {"off": {"ms": ref["ms"], "per_frame": ref["per_frame"],
                   "launches": ref["launches"]}}
    for tag, sw, strips, pieces in SWITCH_RUNS:
        got = run(tag, sw, strips, pieces)
        same, err = _clip_agreement(ref, got)
        frames_n = len(ref["grids"])
        log(f"[14a] {tag}: {got['ms']:.2f} ms/frame (off "
            f"{ref['ms']:.2f}), 0 host syncs, per frame "
            f"{got['per_frame']}, peak {got['peak_gib']:.2f} GiB; grids "
            f"equal to off's on frames 1-{same} of {frames_n}, outputs "
            f"there within {err:.3g} of the largest |off output| (tol "
            f"{SWITCH_TOL})")
        if err > SWITCH_TOL or (tag in LAYOUT_SWITCHES and same < frames_n):
            raise AssertionError(f"14a {tag} disagrees with the switch-off "
                                 f"run: {same} equal grids, err {err:.3g}")
        out[tag] = {"ms": got["ms"], "per_frame": got["per_frame"],
                    "launches": got["launches"], "equal_grids": same,
                    "max_rel_err": err}
        del got
    del ref

    # the stem forms' grids, with fp32 policy convs (TF32 off)
    torch.backends.cudnn.allow_tf32 = False
    with switches(POLICY_COMPUTE=torch.float32):
        ref32 = run("off, fp32 policy", {}, HALO_SHAPES, PIECE_SHAPES)
        for tag, sw, strips, pieces in SWITCH_RUNS:
            if tag not in STEM_FORMS:
                continue
            got = run(f"{tag}, fp32 policy", sw, strips, pieces)
            same, err = _clip_agreement(ref32, got)
            log(f"[14a] {tag} with fp32 policy convs: grids equal to off's "
                f"on frames 1-{same} of {len(ref32['grids'])}, outputs "
                f"within {err:.3g}")
            if same < len(ref32["grids"]) or err > SWITCH_TOL:
                raise AssertionError(f"14a {tag}: the stem form changes "
                                     f"the grids ({same} equal)")
            out[tag]["fp32_policy_equal_grids"] = same
            out[tag]["fp32_policy_max_rel_err"] = err
    torch.backends.cudnn.allow_tf32 = True
    return out


# (14b) GPU against CPU: every switch BORDER_CONV leaves something to do,
# then those it preempts or that exclude the first set
SMALL_SWITCH_RUNS = [
    ("all", {"BORDER_CONV": True, "S2D_STEM": True, "STEM_PLANE_POOL": False,
             "TALL_CONV_BS": 8, "OUT_BLOCKS": True,
             "POLICY_SPLIT_STEM": True}),
    ("rest", {"TALL_CONV_BS": 8, "PACKED_OUT": True,
              "POLICY_STEM_CONV4": False}),
]


def phase_switches_modes():
    """(14b) the step on the GPU against the CPU (plain versions) under the
    switches, as phase 5: RN50 256x512 fp32, capacity 4, 3 frames.  Each
    run counts its calls of the s2d stem conv, which must run on both
    devices under ``S2D_STEM`` (the plane-pool stem preempts it)."""
    from blockcopy_tpu_torch.ops import kernels, layers
    from blockcopy_tpu_torch.tools.measure import switches

    real_s2d = layers._s2d_stem_conv
    s2d_calls = []

    def counted_s2d(*args, **kwargs):
        s2d_calls[-1] += 1
        return real_s2d(*args, **kwargs)

    def run(device, plane_stem):
        s2d_calls.append(0)
        return _small_run("resnet50", device, plane_stem=plane_stem)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = {}
    layers._s2d_stem_conv = counted_s2d
    try:
        with switches(POLICY_COMPUTE=torch.float32):
            for tag, sw in SMALL_SWITCH_RUNS:
                # _small_run sets the plane pool: hand it the run's own
                plane_stem = sw.get("STEM_PLANE_POOL", True)
                with switches(**sw):
                    kernels.reset_launches()
                    gpu = run("cuda", plane_stem)
                    used = dict(kernels.launches)
                    cpu = run("cpu", plane_stem)
                err = rel_err(gpu, cpu)
                s2d = s2d_calls[-2:]
                log(f"[14b] {tag} {sw}: RN50 256x512 fp32 capacity 4, 3 "
                    f"frames, GPU (kernels {used}) vs CPU: {err:.3g} of the "
                    f"largest |CPU output| (tol 1e-3); s2d stem conv calls "
                    f"GPU, CPU {s2d}")
                want_pieces = sw.get("BORDER_CONV", False)
                want_s2d = sw.get("S2D_STEM", False) and not plane_stem
                if (err > 1e-3 or not used["bottleneck_tail_f32"]
                        or not used["halo_strips"]
                        or want_pieces and not used["halo_pieces"]
                        or (min(s2d) == 0 if want_s2d else max(s2d) > 0)):
                    raise AssertionError(f"14b {tag}: GPU step disagrees "
                                         f"or took another stem ({s2d})")
                out[tag] = {"max_rel_err": err, "launches": used,
                            "s2d_stem_calls": s2d}
    finally:
        layers._s2d_stem_conv = real_s2d
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    return out


def _box_sets(ref, got, thr, tol=SWITCH_TOL):
    """Two frames' (dets, labels, valid): each kept box of one paired with
    a kept box of the other (IoU >= 0.9, same label, one to one), scores
    within ``tol``; a box without a partner is allowed only at a cut that
    bf16 may put it on either side of: its score within ``tol`` of ``thr``,
    or, where a set is full (every slot valid), of that set's lowest kept
    score.  Returns (pairs, unpaired marginal boxes, largest score
    difference, the smaller kept set, the reference's kept boxes within
    ``tol`` of a cut: those the band would let go unpaired)."""
    def kept(d):
        dets, labels, valid = (t.cpu() for t in d)
        return dets[valid].float(), labels[valid]

    cuts = [thr] + [float(d[0][d[2]][:, 4].min()) for d in (ref, got)
                    if bool(d[2].all())]

    def area(d):
        return (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])

    (rd, rl), (gd, gl) = kept(ref), kept(got)
    lt = torch.maximum(rd[:, None, :2], gd[None, :, :2])
    rb = torch.minimum(rd[:, None, 2:4], gd[None, :, 2:4])
    inter = (rb - lt).clamp_min(0).prod(-1)
    iou = inter / (area(rd)[:, None] + area(gd)[None, :] - inter)
    iou[rl[:, None] != gl[None, :]] = 0
    pairs, score_err, used, unpaired = 0, 0.0, set(), []
    for i in range(len(rd)):
        free = iou[i].clone()
        free[list(used)] = 0
        j = int(free.argmax()) if len(gd) else -1
        if j >= 0 and free[j] >= 0.9:
            used.add(j)
            pairs += 1
            score_err = max(score_err, abs(float(rd[i, 4] - gd[j, 4])))
        else:
            unpaired.append(float(rd[i, 4]))
    unpaired += [float(gd[j, 4]) for j in range(len(gd)) if j not in used]
    band = sum(min(abs(float(s) - c) for c in cuts) <= tol for s in rd[:, 4])
    if score_err > tol or any(min(abs(s - c) for c in cuts) > tol
                              for s in unpaired):
        raise AssertionError(f"kept boxes differ: {pairs} paired, unpaired "
                             f"scores {unpaired}, score err {score_err:.3g}")
    return pairs, len(unpaired), score_err, min(len(rd), len(gd)), band


def phase_switches_detection():
    """(14c) phase 9's detection step (CSP-R50 ``CSPConfig()``, 1024x2048
    bf16, K = 38) under ``TOPK='approx'``, ``DECODE_LEAN_POINTS=0`` and
    ``BORDER_CONV``, against the switch-off step on the same frames and
    draws.  The draws execute a random set of exactly K blocks, so both
    runs take the same grids: 8 steps, the kept boxes held as sets."""
    from blockcopy_tpu_torch.tools.measure import (csp_stepper, switches,
                                                   synthetic_frames)

    torch.backends.cudnn.allow_tf32 = True
    frame_shape, steps, dtype = (1, 1024, 2048, 3), 8, torch.bfloat16
    params, stepper = csp_stepper(frame_shape, DET_K, dtype, "cuda")
    params["head"]["csp_cls"]["b"].zero_()
    frames = synthetic_frames(frame_shape, steps + 1, dtype)
    gen = torch.Generator().manual_seed(15)
    total = N * GH * GW
    draws = []
    for _ in range(steps):
        u = torch.full((total,), 2.0)
        u[torch.randperm(total, generator=gen)[:DET_K]] = -1.0
        draws.append((u.view(N, GH, GW).cuda(),
                      torch.rand((total,), generator=gen).cuda()))
    sw = {"TOPK": "approx", "DECODE_LEAN_POINTS": False, "BORDER_CONV": True}
    runs = {}
    for tag, cfg, strips, pieces in (
            ("off", {}, DET_HALO_SHAPES, PIECE_SHAPES),
            ("on", sw, DET_HALO_SHAPES[:1],
             PIECE_SHAPES + DET_HALO_SHAPES[1:])):
        per_frame = {"halo_strips": len(strips), "halo_pieces": len(pieces),
                     "bottleneck_tail": len(DET_TAIL_SHAPES)}
        with switches(**cfg):
            _, launches, ms, _, kept, _ = _drive_stepper(
                f"14c {tag}", stepper, params, frames, per_frame,
                watch=lambda st: tuple(t.clone()
                                       for t in stepper.fetch_outputs(st)),
                draws=draws)
        runs[tag] = {"ms": statistics.median(ms[2:]), "per_frame": per_frame,
                     "launches": launches, "dets": kept}
    thr = stepper.csp_cfg.score_thr
    paired, kept_n, band, marginal, score_err = [], [], [], 0, 0.0
    for a, b in zip(runs["off"]["dets"], runs["on"]["dets"]):
        p, m, e, n_kept, n_band = _box_sets(a, b, thr)
        paired.append(p)
        kept_n.append(n_kept)
        band.append(n_band)
        marginal += m
        score_err = max(score_err, e)
    log(f"[14c] CSP-R50 1024x2048 bf16, K {DET_K}, {steps} steps, switches "
        f"{sw}: {runs['on']['ms']:.2f} ms/frame (off "
        f"{runs['off']['ms']:.2f}), 0 host syncs, per frame "
        f"{runs['on']['per_frame']}; kept boxes paired per frame {paired} "
        f"of {kept_n}, {marginal} unpaired within {SWITCH_TOL} of score_thr "
        f"{thr} or of a full set's lowest kept score (off's kept boxes in "
        f"that band per frame {band}; at least {BOX_PAIRED:.0%} paired a "
        f"frame, at most {BOX_UNPAIRED} unpaired a frame over the clip), "
        f"scores within {score_err:.3g}")
    if (min(kept_n) < 8
            or any(p < BOX_PAIRED * n for p, n in zip(paired, kept_n))
            or marginal > BOX_UNPAIRED * len(paired)):
        raise AssertionError(f"14c: kept boxes differ: {paired} paired of "
                             f"{kept_n}, {marginal} unpaired")
    return {"ms": runs["on"]["ms"], "off_ms": runs["off"]["ms"],
            "per_frame": runs["on"]["per_frame"],
            "launches": runs["on"]["launches"], "paired": paired,
            "kept": kept_n, "in_band": band,
            "unpaired_marginal": marginal, "score_err": score_err}


GRAPH_STEPS = 12         # steps of 15a and 15b after the first
GRAPH_WINDOW = 8         # frames a timed window (two train frames)


def _state_gaps(a, b):
    """Largest |a - b| of two stepper states by part: the grid, the
    canvases, the task outputs (with their ``*_prev``) and the policy's
    parameters."""
    from blockcopy_tpu_torch.policy.optim import tree_leaves

    def gap(x, y):
        return max(((u.float() - v.float()).abs().max().item()
                    for u, v in zip(tree_leaves(x), tree_leaves(y))),
                   default=0.0)

    outs = [k for k in a if k not in ("canvases", "prev_grid", "frame_idx",
                                      "policy")]
    return {"grid": gap(a["prev_grid"], b["prev_grid"]),
            "canvases": gap(a["canvases"], b["canvases"]),
            "outputs": gap([a[k] for k in outs], [b[k] for k in outs]),
            "policy": gap(a["policy"]["params"], b["policy"]["params"])}


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms for a lockstep comparison, so that
    two eager runs, and the captured one, do not hang on which algorithm
    cuDNN picks: a floor taken from one nondeterministic pair does not
    bound the next pair's gaps."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def _hold_to_floor(tag, floor, got):
    """Each part's gaps over the frames (``got``, captured against eager)
    against two eager runs' (``floor``): bitwise on every frame where the
    eager runs are bitwise over the clip, else within their largest gap."""
    for part in floor[0]:
        most = max(f[part] for f in floor)
        worst = max(g[part] for g in got)
        if (worst > 0 if most == 0 else worst > most):
            raise AssertionError(
                f"[{tag}] captured against eager, {part}: largest gap "
                f"{worst:.3g} over the frames, eager against eager {most:.3g}"
                f" ({[g[part] for g in got]})")


def _replays(graphs, state, draws) -> bool:
    """Whether ``graphs.step`` on ``state`` replays a captured graph."""
    train = graphs.stepper.is_train_frame(state["frame_idx"] + 1)
    return ("train" if train else "plain",
            draws is not None) in graphs.graphs


def _graphs_lockstep(tag, stepper, params, frames, draws, per_frame):
    """Two eager runs and a captured run (``StepperGraphs``) of one clip in
    lockstep, the same ``draws`` injected into each step.  After every
    frame each part of the captured state is held to the eager one
    (``_hold_to_floor``), every replay runs under
    ``set_sync_debug_mode("error")`` and launches ``per_frame`` (counted
    around the captured call only).  Returns the per-frame gaps."""
    from blockcopy_tpu_torch.core.graphs import StepperGraphs
    from blockcopy_tpu_torch.ops import kernels
    per_frame = {k: per_frame.get(k, 0) for k in kernels.launches}
    a, b, c = (stepper.init_state(params, seed=1) for _ in range(3))
    graphs = StepperGraphs(stepper)
    floor, got, replayed = [], [], []
    for t, frame in enumerate(frames):
        kw = {} if t == 0 else {"draws": draws[t - 1]}
        if t == 0:
            a = stepper.first_step(params, a, frame)
            b = stepper.first_step(params, b, frame)
        else:
            a = stepper.step(params, a, frame, **kw)
            b = stepper.step(params, b, frame, **kw)
        replay = t > 0 and _replays(graphs, c, kw["draws"])
        before = dict(kernels.launches)
        if replay:
            torch.cuda.set_sync_debug_mode("error")
        try:
            c = graphs.first_step(params, c, frame) if t == 0 \
                else graphs.step(params, c, frame, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        used = {k: kernels.launches[k] - before[k] for k in per_frame}
        if used != per_frame:
            raise AssertionError(f"[{tag}] frame {t + 1}: launches {used}, "
                                 f"expected {per_frame}")
        floor.append(_state_gaps(a, b))
        got.append(_state_gaps(a, c))
        replayed.append(replay)
        if t and int(c["prev_grid"].sum().item()) != stepper.capacity:
            raise AssertionError(f"[{tag}] frame {t + 1}: not "
                                 f"{stepper.capacity} blocks")
    _hold_to_floor(tag, floor, got)
    capture_s = {"/".join(map(str, k)): round(g.capture_s, 3)
                 for k, g in graphs.graphs.items()}
    log(f"[{tag}] {len(frames)} frames in lockstep, eager, eager and "
        f"captured, injected draws: {sum(replayed)} replays (each under "
        f"set_sync_debug_mode('error'), no host sync), graphs captured "
        f"{sorted(capture_s)} in {capture_s} s (their eager run included); "
        f"launches a frame {per_frame}; largest gap per part, eager against "
        f"eager {_parts_max(floor)}, captured against eager "
        f"{_parts_max(got)}")
    return {"floor": _parts_max(floor), "gap": _parts_max(got),
            "replays": sum(replayed), "capture_s": capture_s,
            "per_frame": per_frame,
            "launches": {k: v * len(frames) for k, v in per_frame.items()}}


def _parts_max(gaps):
    return {part: max(g[part] for g in gaps) for part in gaps[0]}


def _graphs_timing(tag, stepper, params, frames):
    """Eager against captured without injected draws, both on the card at
    once: each warmed up over ``first_step`` and 4 steps (the captured one
    captures its three graphs there; peak memory of each warm-up above
    what was held before it), then timed in interleaved windows of
    ``GRAPH_WINDOW`` steps (eager, captured, eager, captured; host clock,
    fenced), then one window of each under the profiler (idle share).  The
    captured run's replays must keep ``capacity`` blocks and draw
    different grids."""
    from blockcopy_tpu_torch.core.graphs import StepperGraphs
    from blockcopy_tpu_torch.tools.measure import device_idle
    graphs = StepperGraphs(stepper)
    runs = {"eager": (stepper.first_step, stepper.step),
            "captured": (graphs.first_step, graphs.step)}
    states, peak = {}, {}
    for name, (first, step) in runs.items():
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        st = first(params, stepper.init_state(params, seed=1), frames[0])
        for t in range(1, 5):
            st = step(params, st, frames[t])
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        states[name] = st
    grids, ms = [], {"eager": [], "captured": []}
    frame_at = lambda i: frames[5 + i % (len(frames) - 5)]
    for w in range(4):
        name = ("eager", "captured")[w % 2]
        step = runs[name][1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(GRAPH_WINDOW):
            states[name] = step(params, states[name], frame_at(i))
            if name == "captured":
                grids.append(states[name]["prev_grid"].clone())
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / GRAPH_WINDOW)
    idle = {}
    for name in runs:
        step = runs[name][1]

        def one(i, name=name, step=step):
            states[name] = step(params, states[name], frame_at(i))

        idle[name] = device_idle(one, GRAPH_WINDOW)
    blocks = {int(g.sum().item()) for g in grids}
    distinct = len({tuple(g.flatten().tolist()) for g in grids})
    log(f"[{tag}] without draws: ms/frame (host clock, synchronize-fenced, "
        f"windows of {GRAPH_WINDOW} steps, eager, captured, eager, "
        f"captured): eager {[round(x, 3) for x in ms['eager']]}, captured "
        f"{[round(x, 3) for x in ms['captured']]}; under the profiler "
        f"eager {idle['eager']}, captured {idle['captured']}; peak memory "
        f"of the warm-up (GiB above what was held) eager "
        f"{peak['eager']:.3f}, captured {peak['captured']:.3f}; "
        f"{distinct} distinct grids in {len(grids)} replays, blocks "
        f"{sorted(blocks)}")
    if blocks != {stepper.capacity} or distinct < 2:
        raise AssertionError(f"[{tag}] replays without draws: blocks "
                             f"{blocks}, {distinct} distinct grids")
    return {"ms": {k: statistics.median(v) for k, v in ms.items()},
            "windows_ms": ms, "idle": idle, "peak_gib": peak,
            "distinct_grids": distinct}


def _uniform_draws(steps, total, geom, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    return [(torch.rand(geom, generator=gen, device="cuda"),
             torch.rand((total,), generator=gen, device="cuda"))
            for _ in range(steps)]


def phase_graphs_main():
    """(15a) phase 4's step as CUDA graphs (``core/graphs.py``
    ``StepperGraphs``, the step both CLIs run): ``_graphs_lockstep`` with
    injected draws, then ``_graphs_timing``."""
    from blockcopy_tpu_torch.tools.measure import (swiftnet_stepper,
                                                   synthetic_frames)
    torch.backends.cudnn.allow_tf32 = True
    frame_shape, dtype = (1, 1024, 2048, 3), torch.bfloat16
    params, stepper = swiftnet_stepper("resnet50", frame_shape, K, dtype,
                                       "cuda", train_interval=4)
    frames = synthetic_frames(frame_shape, GRAPH_STEPS + 1, dtype)
    draws = _uniform_draws(GRAPH_STEPS, N * GH * GW, (N, GH, GW), 15)
    per_frame = {"halo_strips": len(HALO_SHAPES),
                 "halo_pieces": len(PIECE_SHAPES),
                 "bottleneck_tail": len(TAIL_SHAPES)}
    with _deterministic_cudnn():
        res = _graphs_lockstep("15a", stepper, params, frames, draws,
                               per_frame)
    res.update(_graphs_timing("15a", stepper, params, frames))
    return res


def phase_graphs_detection():
    """(15b) phase 9a's detection step (the ``csp_cls`` bias 0) as CUDA
    graphs, as 15a: decode, NMS and the IoU gain inside them."""
    from blockcopy_tpu_torch.tools.measure import (csp_stepper,
                                                   synthetic_frames)
    torch.backends.cudnn.allow_tf32 = True
    frame_shape, dtype = (1, 1024, 2048, 3), torch.bfloat16
    params, stepper = csp_stepper(frame_shape, DET_K, dtype, "cuda")
    params["head"]["csp_cls"]["b"].zero_()
    frames = synthetic_frames(frame_shape, GRAPH_STEPS + 1, dtype)
    draws = _uniform_draws(GRAPH_STEPS, N * GH * GW, (N, GH, GW), 16)
    per_frame = {"halo_strips": len(DET_HALO_SHAPES),
                 "halo_pieces": len(PIECE_SHAPES),
                 "bottleneck_tail": len(DET_TAIL_SHAPES)}
    with _deterministic_cudnn():
        res = _graphs_lockstep("15b", stepper, params, frames, draws,
                               per_frame)
    res.update(_graphs_timing("15b", stepper, params, frames))
    return res


def _out_gap(a, b):
    """Largest |a - b| of two ladder frames' outputs: tensors, or per-class
    box arrays (inf where their shapes differ)."""
    if isinstance(a, torch.Tensor):
        return (a.float() - b.float()).abs().max().item()
    gaps = [float(np.abs(x - y).max(initial=0.0)) if x.shape == y.shape
            else float("inf") for x, y in zip(a, b)]
    return max(gaps, default=0.0) if len(a) == len(b) else float("inf")


def _graphs_ladder(tag, build, per_exec, clip_len=8):
    """Two op-by-op engines and one with graphs (``build(graphs)``) over 2
    clips of ``clip_len`` frames in lockstep, the same draws injected: the
    captured engine's outputs held to the eager ones as
    ``_hold_to_floor`` holds a stepper's, the same counts, ``per_exec``
    launches a frame that ran blocks, one graph captured per capacity.
    ms/frame of an eager engine and of the captured one (host clock,
    fenced), over all frames and over the frames that replayed."""
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tools.measure import synthetic_frames
    a, b, c = build(False), build(False), build(True)
    clips = [synthetic_frames((1, 1024, 2048, 3), clip_len, torch.bfloat16,
                              seed=c) for c in range(2)]
    draws = _uniform_draws(2 * clip_len, N * GH * GW, (N, GH, GW), 17)
    floor, got, counts, ms, replay_ms = [], [], [], [], []
    launches = {k: 0 for k in kernels.launches}
    for clip in clips:
        for m in (a, b, c):
            m.reset_temporal()
        for frame in clip:
            d = draws[len(counts)]
            outs = []
            for m in (a, b, c):
                captured = len(m._steps)
                before = dict(kernels.launches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(m(frame, draws=d))
                torch.cuda.synchronize()
                frame_ms = (time.perf_counter() - t0) * 1e3
                if m is a:
                    ms.append(frame_ms)
                if m is c:
                    for k in launches:
                        launches[k] += kernels.launches[k] - before[k]
                    used = {k: kernels.launches[k] - before[k]
                            for k in per_exec}
                    count = c.policy_meta["num_exec"]
                    if used != (per_exec if count else
                                {k: 0 for k in per_exec}):
                        raise AssertionError(f"[{tag}] launches {used} at "
                                             f"count {count}")
                    if len(c._steps) == captured and count:
                        replay_ms.append((frame_ms, ms[-1]))
            counts.append([m.policy_meta["num_exec"] for m in (a, b, c)])
            floor.append({"outputs": _out_gap(outs[0], outs[1])})
            got.append({"outputs": _out_gap(outs[0], outs[2])})
    if any(len(set(n)) != 1 for n in counts):
        raise AssertionError(f"[{tag}] counts differ: {counts}")
    _hold_to_floor(tag, floor, got)
    caps = sorted(c._steps)
    if caps != sorted({n[0] for n in counts if n[0]}):
        raise AssertionError(f"[{tag}] graphs {caps}, counts {counts}")
    eager_ms = statistics.median(ms[clip_len:])
    cap_ms = statistics.median(x for x, _ in replay_ms) if replay_ms \
        else None
    log(f"[{tag}] 2 clips x {clip_len} frames in lockstep (eager, eager, "
        f"graphs; injected draws): counts {[n[0] for n in counts]}, "
        f"{len(caps)} capacities captured {caps}, outputs' largest gap "
        f"captured against eager {_parts_max(got)['outputs']:.3g}, eager "
        f"against eager {_parts_max(floor)['outputs']:.3g}; ms/frame "
        f"(host clock, fenced) eager median {eager_ms:.2f} (clip 2), "
        f"captured on its {len(replay_ms)} replay frames "
        f"{[round(x, 2) for x, _ in replay_ms]} (eager on those frames "
        f"{[round(y, 2) for _, y in replay_ms]})")
    return {"capacities": caps, "eager_ms": eager_ms, "replay_ms": cap_ms,
            "replay_frames": len(replay_ms), "launches": launches,
            "gap": _parts_max(got)["outputs"],
            "floor": _parts_max(floor)["outputs"]}


def phase_graphs_ladder():
    """(15c) the ladder engines with a graph per capacity: phase 8a's RN50
    ``BlockCopyModel`` and phase 10a's ``CSPBlockCopy`` (``_graphs_ladder``,
    under cuDNN's deterministic algorithms)."""
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.core.engine import BlockCopyModel
    from blockcopy_tpu_torch.models.builder import build_detector
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    from blockcopy_tpu_torch.utils.registry import load_config
    torch.backends.cudnn.allow_tf32 = True
    cfg = SwiftNetConfig(backbone="resnet50", num_classes=19)
    params = init_swiftnet(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    def detector(g):
        model = build_detector(load_config(str(DET_CONFIG)),
                               dtype=torch.bfloat16, device="cuda")
        model.params["head"]["csp_cls"]["b"].zero_()
        model.graphs = g
        return model

    with _deterministic_cudnn():
        out = {"semseg": _graphs_ladder(
            "15c semseg", lambda g: BlockCopyModel(
                make_apply_fn(cfg), params, default_settings(),
                device="cuda", graphs=g),
            {"halo_strips": len(HALO_SHAPES),
             "halo_pieces": len(PIECE_SHAPES),
             "bottleneck_tail": len(TAIL_SHAPES)})}
        del params
        out["detection"] = _graphs_ladder(
            "15c detection", detector,
            {"halo_strips": len(DET_HALO_SHAPES),
             "halo_pieces": len(PIECE_SHAPES),
             "bottleneck_tail": len(DET_TAIL_SHAPES)})
    return out


SERVING_CLIP = 8         # frames a clip of 16a and 16b (2 clips)
IDLE_WINDOWS = 4         # profiled windows at most (16a, 16b)


def _tree_gap(a, b):
    from blockcopy_tpu_torch.policy.optim import tree_leaves
    return max(((u.float() - v.float()).abs().max().item()
                for u, v in zip(tree_leaves(a), tree_leaves(b))),
               default=0.0)


def _engine_gaps(a, b, out_a, out_b):
    """Largest gaps of two ladder engines after a frame: its outputs, their
    canvases and their policy parameters."""
    return {"outputs": _out_gap(out_a, out_b),
            "canvases": _tree_gap(a.temporal["canvases"],
                                  b.temporal["canvases"]),
            "policy": _tree_gap(a.policy.net_params, b.policy.net_params)}


def _graph_count(model):
    """The graphs a ladder engine has captured: one a capacity, and the
    policy's and the decode's."""
    return len(model._steps) + len(model._calls.graphs)


def _serving_ladder(tag, build, per_exec, syncs_of, clip_len=SERVING_CLIP):
    """(16a, 16b) Two op-by-op engines (``build(False)``) and one with
    every graph (``build(True)``: the policy's forward and update, each
    capacity's model step, the decode) over 2 clips of ``clip_len`` frames
    in lockstep, the same draws injected, each frame counted for host syncs
    (``count_syncs``) and timed (host clock, fenced).  The captured
    engine's outputs, canvases and policy parameters are held to the two
    eager engines' gaps (``_hold_to_floor``); the counts must be equal;
    ``per_exec`` launches a frame that ran blocks; on every frame that
    captured nothing new the captured engine makes ``syncs_of(engine, t,
    count, ran)`` host syncs, as the eager engines do on every frame after
    the first (which sets an engine up).  Then both go on over windows of
    ``GRAPH_WINDOW`` frames (clip 2's frames again, new draws), the first
    unprofiled, each later one profiled on both (idle share), until the
    captured engine meets no new capacity in a window (at most
    ``IDLE_WINDOWS``: a capture inside a window is not a replay's idle
    time)."""
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tools.measure import (count_syncs, device_idle,
                                                   synthetic_frames)
    a, b, c = build(False), build(False), build(True)
    shape = (1, 1024, 2048, 3)
    clips = [synthetic_frames(shape, clip_len + i * 2 * GRAPH_WINDOW,
                              torch.bfloat16, seed=i) for i in range(2)]
    draws = _uniform_draws(2 * clip_len + (IDLE_WINDOWS + 1) * GRAPH_WINDOW,
                           N * GH * GW, (N, GH, GW), 18)
    floor, got, counts, rows, replays = [], [], [], [], []
    launches = {k: 0 for k in kernels.launches}
    for ci, clip in enumerate(clips):
        for m in (a, b, c):
            m.reset_temporal()
        for t, frame in enumerate(clip[:clip_len], 1):
            d = draws[len(counts)]
            outs, syncs, ms = [], [], []
            for m in (a, b, c):
                graphs = _graph_count(m)
                before = dict(kernels.launches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, n = count_syncs(lambda: m(frame, draws=d))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                outs.append(out)
                syncs.append(n)
            for k in launches:
                launches[k] += kernels.launches[k] - before[k]
            used = {k: kernels.launches[k] - before[k] for k in per_exec}
            count = c.policy_meta["num_exec"]
            ran = c.policy_meta.get("_rl_cache") is not None
            want = syncs_of(c, t, count, ran)
            replayed = _graph_count(c) == graphs
            if used != (per_exec if count else {k: 0 for k in per_exec}):
                raise AssertionError(f"[{tag}] launches {used} at count "
                                     f"{count}")
            # an engine's first frame sets it up (kernel loads in a fresh
            # process), so frame 1 of clip 1 is not held
            first = ci == 0 and t == 1
            if not first and (syncs[:2] != [want, want]
                              or (replayed and syncs[2] != want)):
                raise AssertionError(
                    f"[{tag}] clip {ci + 1} frame {t}: host syncs (eager, "
                    f"eager, captured) {syncs}, expected {want} (captured "
                    f"frame replayed every graph: {replayed})")
            counts.append([m.policy_meta["num_exec"] for m in (a, b, c)])
            floor.append(_engine_gaps(a, b, outs[0], outs[1]))
            got.append(_engine_gaps(a, c, outs[0], outs[2]))
            rows.append((ci + 1, t, count, syncs[2], replayed,
                         round(ms[0], 2), round(ms[2], 2)))
            if replayed and count:
                replays.append((ms[2], ms[0]))
    if any(len(set(n)) != 1 for n in counts):
        raise AssertionError(f"[{tag}] counts differ: {counts}")
    _hold_to_floor(tag, floor, got)
    rest, extra = clips[1][clip_len:], draws[2 * clip_len:]
    for w in range(IDLE_WINDOWS + 1):
        idle = {"window": w}
        for name, m in (("eager", a), ("captured", c)):
            graphs = _graph_count(m)

            def frame(i, m=m, w=w):
                k = w * GRAPH_WINDOW + i
                m(rest[k % len(rest)], draws=extra[k])

            if w == 0:
                for i in range(GRAPH_WINDOW):
                    frame(i)
            else:
                idle[name] = device_idle(frame, GRAPH_WINDOW)
            idle["captures"] = _graph_count(m) - graphs
        if w and not idle["captures"]:
            break
    keys = sorted(str(k[0]) for k in c._calls.graphs)
    eager_ms = statistics.median(y for _, y in replays) if replays else None
    cap_ms = statistics.median(x for x, _ in replays) if replays else None
    for row in rows:
        log(f"[{tag}] clip {row[0]} frame {row[1]}: {row[2]} of 128 blocks, "
            f"captured engine {row[3]} host syncs (replayed every graph: "
            f"{row[4]}), ms eager {row[5]}, captured {row[6]}")
    log(f"[{tag}] 2 clips x {clip_len} frames in lockstep (eager, eager, "
        f"every graph; injected draws, cuDNN deterministic): capacities "
        f"{sorted(c._steps)}, policy and decode graphs {keys}; largest gap "
        f"per part, eager against eager {_parts_max(floor)}, captured "
        f"against eager {_parts_max(got)}; ms/frame on the {len(replays)} "
        f"frames that replayed every graph (host clock, fenced) eager "
        f"median {eager_ms}, captured median {cap_ms}; window "
        f"{idle['window']} of {GRAPH_WINDOW} frames under the profiler "
        f"(graphs captured in it: {idle['captures']}) eager "
        f"{idle['eager']}, captured {idle['captured']}")
    return {"capacities": sorted(c._steps), "graphs": keys,
            "eager_ms": eager_ms, "replay_ms": cap_ms,
            "replay_frames": len(replays), "frames": rows,
            "launches": launches, "gap": _parts_max(got),
            "floor": _parts_max(floor), "idle": idle}


def phase_serving_ladder():
    """(16a) phase 8a's semseg ladder (RN50, the CLI's defaults:
    ``rl_semseg``, ``ref`` policy, block 128, bf16) and (16b) phase 10a's
    detection ladder (``CSPBlockCopy`` from the 0.3 config, ``csp_cls``
    bias 0) with every graph, through ``_serving_ladder``: 1 host sync a
    semseg frame, ``_det_frame_syncs`` a detection frame."""
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.core.engine import BlockCopyModel
    from blockcopy_tpu_torch.models.builder import build_detector
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    from blockcopy_tpu_torch.utils.registry import load_config
    torch.backends.cudnn.allow_tf32 = True
    cfg = SwiftNetConfig(backbone="resnet50", num_classes=19)
    params = init_swiftnet(cfg, seed=0, dtype=torch.bfloat16, device="cuda")

    def detector(g):
        model = build_detector(load_config(str(DET_CONFIG)),
                               dtype=torch.bfloat16, device="cuda")
        model.params["head"]["csp_cls"]["b"].zero_()
        model.graphs = g
        return model

    with _deterministic_cudnn():
        out = {"semseg": _serving_ladder(
            "16a", lambda g: BlockCopyModel(
                make_apply_fn(cfg), params, default_settings(),
                device="cuda", graphs=g),
            {"halo_strips": len(HALO_SHAPES),
             "halo_pieces": len(PIECE_SHAPES),
             "bottleneck_tail": len(TAIL_SHAPES)},
            lambda m, t, count, ran: 1)}
        del params
        out["detection"] = _serving_ladder(
            "16b", detector,
            {"halo_strips": len(DET_HALO_SHAPES),
             "halo_pieces": len(PIECE_SHAPES),
             "bottleneck_tail": len(DET_TAIL_SHAPES)},
            lambda m, t, count, ran: _det_frame_syncs(
                t, count, ran, m.settings["block_policy_verbose"]))
    return out


def phase_serving_dense():
    """(16c) the semseg CLI's dense forward (``--block-policy static``)
    and its upsample to 1024x2048 as graphs (``tasks/semseg/eval.py``
    ``DenseGraphs``) against their bodies run op by op: RN50 1024x2048
    bf16, 9 frames, logits and predictions bitwise (cuDNN deterministic);
    then ms/frame in interleaved windows of ``GRAPH_WINDOW`` frames (eager,
    captured, eager, captured; host clock, fenced; the captured frame
    clones its predictions, as the CLI does), and the launches of the
    captured frames."""
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet)
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.tasks.semseg.eval import DenseGraphs, _upsample
    from blockcopy_tpu_torch.tools.measure import synthetic_frames
    torch.backends.cudnn.allow_tf32 = True
    cfg = SwiftNetConfig(backbone="resnet50", num_classes=19)
    params = init_swiftnet(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    frames = synthetic_frames((1, 1024, 2048, 3), GRAPH_WINDOW + 1,
                              torch.bfloat16)
    hw = (1024, 2048)
    graphs = DenseGraphs(cfg, "cuda")

    def eager(x):
        logits = graphs._dense(params, x)
        return logits, _upsample(hw, (), logits)

    def captured(x):
        logits = graphs.dense_fwd(params, x)
        return logits, graphs.upsample(logits, hw).clone()

    gaps = []
    launches = {k: 0 for k in kernels.launches}
    with _deterministic_cudnn():
        for t, x in enumerate(frames):
            le, pe = eager(x)
            before = dict(kernels.launches)
            lc, pc = captured(x)
            if t:
                for k in launches:
                    launches[k] += kernels.launches[k] - before[k]
            gaps.append((_out_gap(le, lc), int((pe != pc).sum().item())))
    if any(g != (0.0, 0) for g in gaps):
        raise AssertionError(f"[16c] captured against eager (logits gap, "
                             f"predictions that differ) {gaps}")
    ms = {"eager": [], "captured": []}
    for w in range(4):
        name = ("eager", "captured")[w % 2]
        fn = eager if name == "eager" else captured
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in frames[1:]:
            fn(x)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / GRAPH_WINDOW)
    keys = sorted(str(k[0]) for k in graphs.calls.graphs)
    log(f"[16c] dense forward and upsample, RN50 1024x2048 bf16, "
        f"{len(frames)} frames: captured bitwise eager (logits and "
        f"predictions), graphs {keys}; launches over {len(frames) - 1} "
        f"replayed frames {launches}; ms/frame (windows of {GRAPH_WINDOW}, "
        f"eager, captured, eager, captured) eager "
        f"{[round(x, 3) for x in ms['eager']]}, captured "
        f"{[round(x, 3) for x in ms['captured']]}")
    return {"ms": {k: statistics.median(v) for k, v in ms.items()},
            "windows_ms": ms, "launches": launches, "graphs": keys}


def _window_fps(ranks):
    """Frames a second of every rank's timed steps together: their frames
    over the window from the first start to the last end (one host
    clock)."""
    window = max(r["stamps"][-1][1] for r in ranks) \
        - min(r["stamps"][0][0] for r in ranks)
    return sum(len(r["stamps"]) for r in ranks) / window


def phase_serving_parallel(par):
    """(16d) the clip-parallel steps as graphs (``build_parallel_steps``)
    on the one card, through ``tools/measure.py`` ``parallel_graphs_rank``
    (phase 4's stepper, REINFORCE every 4th frame): an NCCL world of one,
    whose train graph holds the ``all_reduce``, and two gloo ranks on
    ``cuda:0`` with the split train step.  Each rank steps the eager
    parallel step and the captured one in lockstep over 8 frames on
    injected draws (cuDNN deterministic): the policy bitwise after every
    update, the outputs after the clip, the policy bitwise across the
    ranks; then 12 captured steps timed (12 + 1 K1 and 8 K2 a frame, no
    host sync on a steady frame), aggregate frames/s against phase 12's
    (``par``)."""
    from blockcopy_tpu_torch.parallel import clip_parallel
    from blockcopy_tpu_torch.tools.measure import parallel_graphs_rank
    per_frame = {"halo_strips": len(HALO_SHAPES),
                 "halo_pieces": len(PIECE_SHAPES),
                 "bottleneck_tail": len(TAIL_SHAPES)}
    timed = 12
    out = {}
    for tag, spec in (
            ("nccl", clip_parallel.make_group(1, ["cuda:0"],
                                              backend="nccl")),
            ("gloo", clip_parallel.make_group(2, ["cuda:0", "cuda:0"],
                                              backend="gloo"))):
        t0 = time.perf_counter()
        ranks = clip_parallel.spawn(spec, parallel_graphs_rank, "resnet50",
                                    (1, 1024, 2048, 3), 64, "bfloat16", 128,
                                    4, 8, timed, timeout=600)
        want = {k: per_frame.get(k, 0) * timed for k in ranks[0]["launches"]}
        for r, res in enumerate(ranks):
            if (not res["outputs_equal"] or not res["finite"]
                    or res["launches"] != want
                    or len(res["digests"]) != 2
                    or any(e != c for e, c in res["digests"])):
                raise AssertionError(
                    f"[16d {tag}] rank {r}: outputs bitwise eager "
                    f"{res['outputs_equal']}, finite {res['finite']}, "
                    f"launches {res['launches']} (expected {want}), policy "
                    f"digests (eager, captured) {res['digests']}")
        if any(res["digests"] != ranks[0]["digests"] for res in ranks) or \
                len({c for _, c in ranks[0]["digests"]}) != 2:
            raise AssertionError(f"[16d {tag}] policy digests per rank "
                                 f"{[res['digests'] for res in ranks]}")
        fps = _window_fps(ranks)
        out[tag] = {"ranks": [{"launches": res["launches"],
                               "ms": statistics.median(res["ms"]),
                               "trained": res["trained"]} for res in ranks],
                    "fps": fps}
        log(f"[16d {tag}] {spec.size} rank(s): eager and captured parallel "
            f"steps bitwise in lockstep (policy after the updates at frames "
            f"4 and 8, the outputs after frame 8), the policy bitwise "
            f"across the ranks; {timed} captured steps a rank: ms/frame "
            f"median {[round(r['ms'], 2) for r in out[tag]['ranks']]}, "
            f"train frames (frame, host syncs) "
            f"{[r['trained'] for r in out[tag]['ranks']]}, aggregate "
            f"{fps:.2f} frames/s ({time.perf_counter() - t0:.1f} s)")
    log(f"[16d] aggregate frames/s, captured against phase 12's eager: two "
        f"gloo ranks {out['gloo']['fps']:.2f} against "
        f"{par['aggregate_fps']:.2f} (12a), NCCL world of one "
        f"{out['nccl']['fps']:.2f} against {par['nccl_fps']:.2f} (12b)")
    return out


def phase_serving(par):
    """Phase 16 (module docstring); ``par`` is phase 12's result."""
    out = phase_serving_ladder()
    out["dense"] = phase_serving_dense()
    out["parallel"] = phase_serving_parallel(par)
    return out


def _train_gaps(a, b, losses_a, losses_b):
    """Largest |a - b| of two train states by part, and of their loss
    terms; the host steps must agree.  One host read."""
    from blockcopy_tpu_torch.policy.optim import tree_leaves
    if int(a["step"]) != int(b["step"]):
        raise AssertionError(f"host steps {int(a['step'])} and "
                             f"{int(b['step'])}")
    parts = ("params", "ema_params", "m", "v")
    gaps = [torch.stack(torch._foreach_norm(torch._foreach_sub(
        tree_leaves(a[k]), tree_leaves(b[k])), float("inf"))).max()
        for k in parts]
    gaps.append((torch.stack(list(losses_a.values()))
                 - torch.stack(list(losses_b.values()))).abs().max())
    return dict(zip(parts + ("losses",), torch.stack(gaps).tolist()))


def phase_train_graphs(tmp):
    """Phase 17 (module docstring): (a) phase 11a's train step, two eager
    runs and one captured in lockstep from one init, under cuDNN's
    deterministic algorithms; (b) the train CLI through the graph and its
    teacher through the detection CLI's loader."""
    from blockcopy_tpu_torch.models.builder import load_csp_params
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.policy.optim import tree_leaves, tree_map
    from blockcopy_tpu_torch.tasks.detection import train as T

    cfg, tcfg, batches, params = _train_setup()
    names = ("eager", "eager2", "captured")
    steps = {n: T.make_train_step(cfg, tcfg, "cuda",
                                  graphs=n == "captured") for n in names}
    states = {n: T.init_train_state(tree_map(torch.clone, params), tcfg)
              for n in names}
    del params
    ms = {n: [] for n in names}
    peak = {n: 0.0 for n in names}
    reserved = {n: 0.0 for n in names}
    floor, got, totals = [], [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    with _deterministic_cudnn():
        for imgs, *maps in batches:
            losses = {}
            for n in names:
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                if n == "captured":
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    states[n], losses[n] = steps[n](states[n], imgs,
                                                    tuple(maps))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                ms[n].append((time.perf_counter() - t0) * 1e3)
                peak[n] = max(peak[n], (torch.cuda.max_memory_allocated()
                                        - held) / 2 ** 30)
                reserved[n] = max(reserved[n],
                                  torch.cuda.max_memory_reserved() / 2 ** 30)
            floor.append(_train_gaps(states["eager"], states["eager2"],
                                     losses["eager"], losses["eager2"]))
            got.append(_train_gaps(states["eager"], states["captured"],
                                   losses["eager"], losses["captured"]))
            totals.append(losses["captured"]["loss_total"].item())
    launches = dict(kernels.launches)
    _hold_to_floor("17a", floor, got)
    capture_s = [g.capture_s
                 for g in steps["captured"].calls.graphs.values()]
    med = {n: statistics.median(v[2:]) for n, v in ms.items()}
    # the graph's private pool: what it keeps reserved between replays
    pool = steps["captured"].calls.pool
    pool_gib = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if seg["segment_pool_id"] == pool) / 2 ** 30
    log(f"[17a] train step CSP-R50 fp32 {TRAIN_CROP[0]}x{TRAIN_CROP[1]} "
        f"batch {TRAIN_BATCH} (cuDNN TF32 on and deterministic, matmul TF32 "
        f"off), {TRAIN_STEPS} steps in lockstep from one init, eager, eager "
        f"and captured (one graph, captured at step 1 in {capture_s} s, its "
        f"eager run included, then {TRAIN_STEPS - 1} replays; each step "
        f"under set_sync_debug_mode('error'), no host sync); host steps "
        f"{int(states['captured']['step'])} each; largest gap per part, "
        f"eager against eager {_parts_max(floor)}, captured against eager "
        f"{_parts_max(got)}; launches {launches}")
    log(f"[17a] ms/step (host clock, synchronize-fenced, interleaved a step "
        f"at a time: eager, eager, captured), median of steps "
        f"3-{TRAIN_STEPS}: eager {med['eager']:.2f}, eager2 "
        f"{med['eager2']:.2f}, captured {med['captured']:.2f}; all eager "
        f"{[round(x, 2) for x in ms['eager']]}, captured "
        f"{[round(x, 2) for x in ms['captured']]}; peak memory allocated "
        f"above what was held before a step (GiB, largest over the steps; "
        f"the captured run's at its capture) "
        + ", ".join(f"{n} {peak[n]:.3f}" for n in names)
        + "; peak memory reserved by the process during a run's steps (GiB) "
        + ", ".join(f"{n} {reserved[n]:.3f}" for n in names)
        + f"; the graph's memory pool reserves {pool_gib:.3f} GiB; "
        f"loss_total {[round(x, 4) for x in totals]}")
    if (any(launches.values()) or len(capture_s) != 1
            or not np.isfinite(totals).all() or len(set(totals)) < 2):
        raise AssertionError(f"[17a] launches {launches}, graphs "
                             f"{capture_s}, losses {totals}")
    out = {"ms": med, "peak_gib": peak, "reserved_gib": reserved,
           "pool_gib": pool_gib, "capture_s": capture_s[0],
           "floor": _parts_max(floor), "gap": _parts_max(got),
           "launches": launches}
    del states, steps
    torch.cuda.empty_cache()

    teacher, cli_launches, cli_capture_s = phase_train_cli(tmp, "17b")
    loaded = load_csp_params(teacher, cfg, torch.float32, "cuda")
    leaves = tree_leaves(loaded)
    finite = bool(torch.stack([torch.isfinite(t).all()
                               for t in leaves]).all())
    log(f"[17b] the teacher checkpoint {Path(teacher).name} through the "
        f"detection CLI's loader (models/builder.py load_csp_params): "
        f"{len(leaves)} tensors, all finite {finite}")
    if not finite:
        raise AssertionError("[17b] the teacher checkpoint is not finite")
    out.update({"cli_launches": cli_launches,
                "cli_capture_s": cli_capture_s})
    return out


def train_graph_keys(tg, name):
    """The kernels line's phase-17 launches of kernel ``name``: over 17a's
    three runs and 17b's CLI run."""
    return {"train_graph_launches": tg["launches"][name],
            "train_graph_cli_launches": tg["cli_launches"][name]}


def serving_keys(serving, name):
    """The kernels line's phase-16 launches of kernel ``name``: over 16a's
    and 16b's captured engines, 16c's replayed frames, and 16d's timed
    captured steps (NCCL; each gloo rank)."""
    par = serving["parallel"]
    return {"serving_ladder_launches":
                serving["semseg"]["launches"][name],
            "serving_detection_ladder_launches":
                serving["detection"]["launches"][name],
            "serving_dense_launches": serving["dense"]["launches"][name],
            "serving_parallel_nccl_launches":
                par["nccl"]["ranks"][0]["launches"][name],
            "serving_parallel_gloo_launches":
                [r["launches"][name] for r in par["gloo"]["ranks"]]}


def graph_keys(graphs, name):
    """The kernels line's phase-15 launches of kernel ``name``: over the
    captured runs of 15a and 15b (every frame) and of 15c's two captured
    engines."""
    return {"graphs_launches": graphs["main"]["launches"][name],
            "graphs_detection_launches":
                graphs["detection"]["launches"][name],
            "graphs_ladder_launches":
                graphs["ladder"]["semseg"]["launches"][name],
            "graphs_detection_ladder_launches":
                graphs["ladder"]["detection"]["launches"][name]}


def switch_keys(sw_main, sw_modes, sw_det, name):
    """The kernels line's phase-14 launches of kernel ``name``: per frame
    under each 14a run, over each 14b GPU run, and per frame of 14c's
    switch-on detection run."""
    return {"switch_launches_per_frame": {
                k: v["per_frame"].get(name, 0) for k, v in sw_main.items()},
            "switch_gpu_cpu_launches": {
                k: v["launches"][name] for k, v in sw_modes.items()},
            "switch_detection_launches_per_frame":
                sw_det["per_frame"].get(name, 0)}


def native_keys(native_cli, capability, name):
    """The kernels line's phase-13 launches of kernel ``name``."""
    return {"native_cli_launches": native_cli["launches"][name],
            "capability_launches": {k: v["launches"][name]
                                    for k, v in capability.items()}}


def parallel_keys(par, name):
    """The kernels line's phase-12 launches of kernel ``name``."""
    return {"parallel_launches": [r["launches"][name]
                                  for r in par["two_ranks"]],
            "parallel_nccl_launches": par["nccl"][0]["launches"][name],
            "parallel_cli_launches": par["cli_launches"][name],
            "parallel_detection_launches": [r["launches"][name]
                                            for r in par["detection"]]}


def ladder_keys(kern, name):
    """The kernels line's per-frame detection-ladder times of K1 or K2."""
    return {f"detection_ladder_{key}_k{k}": kern[(name, k)][key]
            for k in DET_LADDER_KS for key in ("ms", "plain_ms", "bound_ms")}


def halo_ladder_keys(halo, entry):
    """The kernels line's per-frame semseg times of a K1 entry at the
    ladder's capacities (phase 2), and K1's launch floor."""
    out = {"launch_floor_ms": halo["floor"]}
    for k, t in halo["ladder"].items():
        out.update({f"ladder_{key}_k{k}": t[entry + suffix]
                    for key, suffix in (("ms", ""), ("plain_ms", "_plain"))})
        out[f"ladder_bound_ms_k{k}"] = t["bound"]
    return out


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
    pieces = phase_pieces(gen)
    tail = phase_tail(gen)
    rows = phase_tail_rows(gen)
    launches, step_ms, main_ms = phase_main()
    launches_256, main_256 = phase_main_256()
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
    train_launches, train = phase_train()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        teacher, train_cli_launches, _ = phase_train_cli(tmp)
        trained_cli = phase_trained_detection_cli(teacher)
    train_err = phase_train_modes()
    valid = phase_validation()
    par = phase_parallel(main_ms)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        nio = phase_native_io(tmp)
        native_cli = phase_native_cli(tmp, cli["speed-mode"]["fps"], step_ms)
    capability = phase_capability()
    sw_main = phase_switches()
    sw_modes = phase_switches_modes()
    sw_det = phase_switches_detection()
    graphs = {"main": phase_graphs_main(),
              "detection": phase_graphs_detection(),
              "ladder": phase_graphs_ladder()}
    serving = phase_serving(par)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tg = phase_train_graphs(tmp)

    def phase11_keys(name):
        return {"train_launches": train_launches[name],
                "train_cli_launches": train_cli_launches[name],
                "trained_checkpoint_cli_launches":
                    trained_cli["launches"][name],
                "validation_blockcopy_launches": valid["launches"][name]}

    source = "blockcopy_tpu_torch/csrc/"
    common = {"route": "cuda", "library_ms": None, "matched": True}
    kern = [
        {"name": "halo_gather_strips", "source": source + "halo.cu",
         "replaces": "blockcopy_tpu/ops/pallas/halo.py:69",
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
         **phase11_keys("halo_strips"),
         **parallel_keys(par, "halo_strips"),
         **native_keys(native_cli, capability, "halo_strips"),
         **switch_keys(sw_main, sw_modes, sw_det, "halo_strips"),
         **graph_keys(graphs, "halo_strips"),
         **serving_keys(serving, "halo_strips"),
         **train_graph_keys(tg, "halo_strips"),
         **halo_ladder_keys(halo, "strips"),
         "max_abs_err": halo["err"], "ms": halo["strips"],
         "plain_ms": halo["strips_plain"], "bound_ms": halo["bound"],
         "bound_by": "bytes", **common},
        {"name": "halo_pieces", "source": source + "halo.cu",
         "replaces": "blockcopy_tpu/ops/pallas/halo.py:69",
         "path": "the stem's plane pool (main, block 256, ladder, "
                 "detection); BORDER_CONV's convs and pool (14)",
         "launches": launches["halo_pieces"],
         "block256_launches": launches_256["halo_pieces"],
         "ladder_launches": ladder_launches["halo_pieces"],
         "detection_launches": det_launches["halo_pieces"],
         "detection_ladder_launches": dl_launches["halo_pieces"],
         **parallel_keys(par, "halo_pieces"),
         **native_keys(native_cli, capability, "halo_pieces"),
         **switch_keys(sw_main, sw_modes, sw_det, "halo_pieces"),
         **graph_keys(graphs, "halo_pieces"),
         **serving_keys(serving, "halo_pieces"),
         **train_graph_keys(tg, "halo_pieces"),
         "block256_ms": pieces["block256"]["kernel"],
         "block256_plain_ms": pieces["block256"]["plain"],
         "block256_bound_ms": pieces["block256"]["bound"],
         "max_abs_err": pieces["err"], "ms": pieces["block128"]["kernel"],
         "plain_ms": pieces["block128"]["plain"],
         "bound_ms": pieces["block128"]["bound"], "bound_by": "bytes",
         **common},
        {"name": "halo_gather_canvas", "source": source + "halo.cu",
         "replaces": "blockcopy_tpu/ops/pallas/halo.py:69",
         "path": "pallas halo mode", "launches": canvas_launches,
         "detection_ladder_launches": dl_launches["halo_canvas"],
         **parallel_keys(par, "halo_canvas"),
         **graph_keys(graphs, "halo_canvas"),
         **serving_keys(serving, "halo_canvas"),
         **train_graph_keys(tg, "halo_canvas"),
         **halo_ladder_keys(halo, "canvas"),
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
         **phase11_keys("bottleneck_tail"),
         **parallel_keys(par, "bottleneck_tail"),
         **native_keys(native_cli, capability, "bottleneck_tail"),
         **switch_keys(sw_main, sw_modes, sw_det, "bottleneck_tail"),
         **graph_keys(graphs, "bottleneck_tail"),
         **serving_keys(serving, "bottleneck_tail"),
         **train_graph_keys(tg, "bottleneck_tail"),
         "tail_pieces_ms": tail["bf16"]["pieces"],
         "two_launch_ms": tail["bf16"]["two_launch"],
         "max_abs_err": tail["bf16"]["err"], "ms": tail["bf16"]["kernel"],
         "plain_ms": tail["bf16"]["plain"], "bound_ms": tail["bf16"]["bound"],
         "bound_by": tail["bf16"]["by"], **common},
        {"name": "bottleneck_tail_rows", "source": source + "bottleneck.cu",
         "replaces": "blockcopy_tpu/ops/pallas/bottleneck.py:92",
         "path": "block-256 stepper (4b), block-256 and wide ladders (8d)",
         "launches": launches_256["bottleneck_tail_rows"],
         "main_launches": launches["bottleneck_tail_rows"],
         "block256_launches": blocks[("resnet50", 256, str(torch.bfloat16))][
             "bottleneck_tail_rows"],
         "wide_resnet50_2_launches": blocks[
             ("wide_resnet50_2", 128, str(torch.bfloat16))][
             "bottleneck_tail_rows"],
         **parallel_keys(par, "bottleneck_tail_rows"),
         **graph_keys(graphs, "bottleneck_tail_rows"),
         **serving_keys(serving, "bottleneck_tail_rows"),
         **train_graph_keys(tg, "bottleneck_tail_rows"),
         "wide_ms": rows["wide"]["kernel"],
         "wide_plain_ms": rows["wide"]["plain"],
         "wide_bound_ms": rows["wide"]["bound"],
         "wide_two_launch_ms": rows["wide"]["two_launch"],
         "tail_pieces_ms": rows["block256"]["pieces"],
         "two_launch_ms": rows["block256"]["two_launch"],
         "max_abs_err": rows["err"], "ms": rows["block256"]["kernel"],
         "plain_ms": rows["block256"]["plain"],
         "bound_ms": rows["block256"]["bound"],
         "bound_by": rows["block256"]["by"], **common},
        {"name": "bottleneck_tail_f32", "source": source + "bottleneck.cu",
         "replaces": "blockcopy_tpu/ops/pallas/bottleneck.py:92",
         "path": "fp32 CLI (ladder, speed-mode)",
         "launches": cli["ladder fp32"]["launches"]["bottleneck_tail_f32"],
         "speed_mode_launches":
             cli["speed-mode fp32"]["launches"]["bottleneck_tail_f32"],
         "block256_launches": blocks[("resnet50", 256, str(torch.float32))][
             "bottleneck_tail_f32"],
         "detection_max_abs_err": det_kern["tail"]["err"]["f32"],
         # the fp32 detection ladder: the CLI's fp32 ladder run (10b)
         "detection_ladder_launches": det_cli["ladder fp32"]["launches"][
             "bottleneck_tail_f32"],
         "detection_ladder_max_abs_err": dl_kern["tail_err"]["f32"],
         **parallel_keys(par, "bottleneck_tail_f32"),
         **native_keys(native_cli, capability, "bottleneck_tail_f32"),
         **switch_keys(sw_main, sw_modes, sw_det, "bottleneck_tail_f32"),
         **graph_keys(graphs, "bottleneck_tail_f32"),
         **serving_keys(serving, "bottleneck_tail_f32"),
         **train_graph_keys(tg, "bottleneck_tail_f32"),
         "tail_pieces_ms": tail["f32"]["pieces"],
         "two_launch_ms": tail["f32"]["two_launch"],
         "max_abs_err": tail["f32"]["err"], "ms": tail["f32"]["kernel"],
         "plain_ms": tail["f32"]["plain"], "bound_ms": tail["f32"]["bound"],
         "bound_by": tail["f32"]["by"], **common},
    ] + [
        {"name": name, "source": source + "mm.cu",
         "replaces": "tools/probe_int8.py:38", "path": "probe_int8",
         "launches": probe_launches[name],
         "detection_ladder_launches": dl_launches[name],
         **parallel_keys(par, name), **graph_keys(graphs, name),
         **serving_keys(serving, name), **train_graph_keys(tg, name),
         "route": "cuda",
         "matched": True, **mm[name]}
        for name in ("mm_bf16", "mm_int8")]
    log(f"[7] halo, halo_pieces and tail times are per main-path frame "
        f"(sums over its launch shapes; halo_pieces block256_*: per "
        f"block-256 frame at K = {K_256}), their library_ms null: no single "
        f"PyTorch call computes any of them; K2's tail_pieces_ms is "
        f"halo_pieces at its tail shapes, two_launch_ms K2 + that (the "
        f"tail's launches when it read gathered pieces); "
        f"bottleneck_tail_rows times are per "
        f"block-256 frame at K = {K_256} (wide_*: per wide_resnet50_2 frame "
        f"at K = {K}); mm times are per launch at "
        f"{'x'.join(map(str, MM_SHAPES[0]))}; main path {step_ms:.2f} "
        f"ms/frame; block-256 path {main_256['ms']:.2f} ms/frame, peak "
        f"{main_256['peak_gib']:.2f} GiB; ladder path {ladder['ms']:.2f} "
        f"ms/frame at capacities "
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
        f"K = 8 and 128; train step {train['ms']:.2f} ms, peak "
        f"{train['peak_gib']:.2f} GiB, GPU vs CPU gradients "
        f"{max(r['grad_err'] for r in train_err):.3g}; validation "
        f"(reduced) MR Reasonable "
        + ", ".join(f"{k} {v['mr']['Reasonable']:.2f}"
                    for k, v in valid["result"]["modes"].items())
        + f"; clip-parallel: two gloo ranks on one card "
        f"{[round(r['ms'], 2) for r in par['two_ranks']]} ms/frame, "
        f"aggregate {par['aggregate_fps']:.2f} frames/s against one rank's "
        f"{par['single_fps']:.2f} (phase 4) and {par['nccl_fps']:.2f} (12b), "
        f"averaged gradient err "
        f"{par['grad_err']:.3g}, NCCL world of one "
        f"{par['nccl'][0]['ms']:.2f} ms/frame"
        + f"; clip IO built in {nio['build_s']:.2f} s (zlib {nio['zlib']}), "
        f"decode {nio['decode_ms']:.2f} ms a 1024x2048 frame "
        f"({nio['decode_512_ms']:.2f} resized to 512x1024); native CLI "
        f"{native_cli['fps']:.2f} fps, decode {native_cli['decode_ms']:.2f} "
        f"ms a frame; validate_capability (reduced) exec rate "
        + ", ".join(f"{k} {v['result']['exec_rate_final_mean']:.3f}"
                    for k, v in capability.items())
        + "; off-by-default lowerings (14a) ms/frame "
        + ", ".join(f"{k} {v['ms']:.2f}" for k, v in sw_main.items())
        + ", GPU vs CPU (14b) "
        + ", ".join(f"{k} {v['max_rel_err']:.3g}"
                    for k, v in sw_modes.items())
        + f", detection (14c) {sw_det['ms']:.2f} ms/frame against "
        f"{sw_det['off_ms']:.2f} off"
        + "; as CUDA graphs (15), ms/frame captured against eager: main "
        f"path {graphs['main']['ms']['captured']:.2f} against "
        f"{graphs['main']['ms']['eager']:.2f}, detection "
        f"{graphs['detection']['ms']['captured']:.2f} against "
        f"{graphs['detection']['ms']['eager']:.2f}, idle share main "
        f"{graphs['main']['idle']['captured']['idle_share']} against "
        f"{graphs['main']['idle']['eager']['idle_share']}, ladder "
        f"capacities captured {graphs['ladder']['semseg']['capacities']} "
        f"(semseg), {graphs['ladder']['detection']['capacities']} "
        f"(detection)"
        + "; the serving programs as CUDA graphs (16), ms/frame captured "
        f"against eager on frames that replayed every graph: semseg ladder "
        f"{serving['semseg']['replay_ms']} against "
        f"{serving['semseg']['eager_ms']}, detection ladder "
        f"{serving['detection']['replay_ms']} against "
        f"{serving['detection']['eager_ms']}, idle share semseg "
        f"{serving['semseg']['idle']['captured']['idle_share']} against "
        f"{serving['semseg']['idle']['eager']['idle_share']}, detection "
        f"{serving['detection']['idle']['captured']['idle_share']} against "
        f"{serving['detection']['idle']['eager']['idle_share']}; dense "
        f"{serving['dense']['ms']['captured']:.2f} against "
        f"{serving['dense']['ms']['eager']:.2f}; clip-parallel frames/s "
        f"gloo {serving['parallel']['gloo']['fps']:.2f}, NCCL "
        f"{serving['parallel']['nccl']['fps']:.2f}"
        + f"; the train step as a CUDA graph (17), ms/step captured against "
        f"eager (cuDNN deterministic) {tg['ms']['captured']:.2f} against "
        f"{tg['ms']['eager']:.2f}, captured in {tg['capture_s']:.2f} s, gap "
        f"to eager {tg['gap']} against eager to eager {tg['floor']}; phase "
        f"11a's captured step {train['ms']:.2f} ms"
        + f"; total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
