"""What ``chip_smoke.py`` and the tools share: the synthetic clip, a random
halo in strip form, the SwiftNet and CSP steppers they drive, a small
detection clip and a small train step for GPU-CPU comparisons, device
timing by CUDA graph replay, the bodies of one clip-parallel rank (eager,
with the group that records its gradient averages, and eager against
captured), PNG files and Cityscapes-layout
clips written without PIL, and the port's lowering switches set for a block
of code."""

from __future__ import annotations

import contextlib
import functools
import re
import statistics
import struct
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from blockcopy_tpu_torch.parallel.distributed import Group


# The port's lowering switches by name: (module, global).  Each module reads
# its global when it runs, so setting one in-process switches the lowering.
SWITCHES = {
    "BORDER_CONV": ("blockcopy_tpu_torch.ops.layers", "BORDER_CONV"),
    "S2D_STEM": ("blockcopy_tpu_torch.ops.layers", "S2D_STEM"),
    "STEM_PLANE_POOL": ("blockcopy_tpu_torch.ops.layers", "STEM_PLANE_POOL"),
    "TALL_CONV_BS": ("blockcopy_tpu_torch.ops.layers", "TALL_CONV_MAX_BS"),
    "OUT_BLOCKS": ("blockcopy_tpu_torch.core.stepper", "OUT_BLOCKS"),
    "PACKED_OUT": ("blockcopy_tpu_torch.core.stepper", "PACKED_OUT"),
    "POLICY_SPLIT_STEM": ("blockcopy_tpu_torch.policy.net",
                          "POLICY_SPLIT_STEM"),
    "POLICY_STEM_CONV4": ("blockcopy_tpu_torch.policy.net",
                          "POLICY_STEM_CONV4"),
    "POLICY_COMPUTE": ("blockcopy_tpu_torch.policy.net", "COMPUTE_DTYPE"),
    "TOPK": ("blockcopy_tpu_torch.models.csp", "TOPK_IMPL"),
    "DECODE_LEAN_POINTS": ("blockcopy_tpu_torch.models.csp",
                           "DECODE_LEAN_POINTS"),
}


@contextlib.contextmanager
def switches(**values):
    """Set the named ``SWITCHES`` for the block and restore them after,
    e.g. ``with switches(BORDER_CONV=True, TALL_CONV_BS=8): ...``."""
    import importlib
    targets = {k: (importlib.import_module(SWITCHES[k][0]), SWITCHES[k][1])
               for k in values}
    saved = {k: getattr(m, g) for k, (m, g) in targets.items()}
    try:
        for k, (m, g) in targets.items():
            setattr(m, g, values[k])
        yield
    finally:
        for k, (m, g) in targets.items():
            setattr(m, g, saved[k])


def synthetic_frames(shape, count, dtype, seed=0, device="cuda"):
    """Synthetic moving frames (a bright square sliding along the diagonal
    over fixed noise, as ``bench.py``), made on ``device``."""
    gen = torch.Generator(device).manual_seed(seed)
    base = torch.randn(shape, generator=gen, device=device)
    out = []
    for t in range(count):
        f = base.clone()
        s = (t * 37) % (shape[1] - 200)
        f[:, s:s + 160, s:s + 160] += 2.0
        out.append(f.to(dtype))
    return out


def strip_halo(gen, k, bs, c, dtype, n_set=None, grid=(1, 8, 16), pad=1,
               relu=False):
    """A ``StripHalo`` on ``gen``'s device: random strip storage of a
    ``grid`` of blocks (the 1024x2048 frame's at block 128 by default) with
    zero sentinels, non-negative where ``relu`` (a halo of post-ReLU
    activations), and ``k`` block indices, ``n_set`` of them (all by
    default) executed blocks drawn at random, the rest padding slots."""
    from blockcopy_tpu_torch.core import grid as G
    from blockcopy_tpu_torch.core.blocked import StripHalo
    n, gh, gw = grid
    total, dev = n * gh * gw, gen.device

    def strip(*shape):
        t = torch.randn(shape, generator=gen, device=dev)
        t = (t.clamp_min(0) if relu else t).to(dtype)
        t[-1] = 0
        return t

    rows = strip(total + 1, 2 * pad, bs, c)
    cols = strip(total + 1, bs, 2 * pad, c)
    chosen = torch.zeros(total, dtype=torch.bool, device=dev)
    order = torch.randperm(total, generator=gen, device=dev)
    chosen[order[:k if n_set is None else n_set]] = True
    idx = G.exec_indices(chosen.view(n, gh, gw), k)
    return StripHalo(rows=rows, cols=cols, idx=idx, n=n, gh=gh, gw=gw,
                     pad=pad)


def swiftnet_stepper(backbone, frame_shape, capacity, dtype, device,
                     train_interval=4, block_size=128):
    """Random SwiftNet parameters (seed 0) and a fixed-capacity stepper with
    the fast policy, target 0.5, blocks of ``block_size``; a ``capacity`` of
    None is the target's share of the grid (64 of 128 blocks at 1024x2048
    and block 128, 16 of 32 at block 256)."""
    from blockcopy_tpu_torch.core.stepper import (FixedCapacityStepper,
                                                  StepperConfig)
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    cfg = SwiftNetConfig(backbone=backbone, num_classes=19)
    params = init_swiftnet(cfg, seed=0, dtype=dtype, device=device)
    scfg = StepperConfig(block_size=block_size, block_target=0.5,
                         train_interval=train_interval, policy_arch="fast")
    if capacity is None:
        blocks = ((frame_shape[1] // block_size)
                  * (frame_shape[2] // block_size))
        capacity = int(round(scfg.block_target * blocks))
    return params, FixedCapacityStepper(make_apply_fn(cfg), scfg, frame_shape,
                                        capacity=capacity, dtype=dtype,
                                        device=device)


def csp_stepper(frame_shape, capacity, dtype, device, cfg=None,
                train_interval=4):
    """Random CSP parameters (seed 0; ``CSPConfig()`` unless ``cfg``) and a
    detection stepper with the fast policy, block 128, target 0.3: the
    workload of ``bench_detection.py``."""
    from blockcopy_tpu_torch.core.stepper import StepperConfig
    from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
    from blockcopy_tpu_torch.tasks.detection.stepper import DetectionStepper
    cfg = CSPConfig() if cfg is None else cfg
    params = init_csp(cfg, seed=0, dtype=dtype, device=device)
    scfg = StepperConfig(block_size=128, block_target=0.3,
                         train_interval=train_interval, num_classes=1,
                         policy_arch="fast")
    return params, DetectionStepper(cfg, scfg, frame_shape, capacity,
                                    dtype=dtype, device=device)


def detection_clip(device, frames=3):
    """A 256x512 fp32 clip through the detection stepper, CSP with
    ``stage_blocks=(1, 2, 2, 1)`` at full widths, capacity 4 of 8,
    REINFORCE every 2nd frame.  The injected draws are -1 (execute) or 2
    (skip) for exactly 4 blocks, so the grids do not depend on the policy's
    probabilities; the ``csp_cls`` bias is 0 and ``score_thr`` 0.6, so some
    dets are valid.  Returns, per frame on the CPU: the canvases, the grid
    and the (dets, labels, valid)."""
    from blockcopy_tpu_torch.models.csp import CSPConfig
    from blockcopy_tpu_torch.policy.optim import tree_map
    shape = (1, 256, 512, 3)
    cfg = CSPConfig(stage_blocks=(1, 2, 2, 1), score_thr=0.6)
    params, stepper = csp_stepper(shape, 4, torch.float32, device, cfg,
                                  train_interval=2)
    params["head"]["csp_cls"]["b"].zero_()
    # made on the CPU, so runs on either device get the same frames
    clip = [f.to(device) for f in synthetic_frames(
        shape, frames, torch.float32, seed=2, device="cpu")]
    gen = torch.Generator().manual_seed(2)
    draws = []
    for _ in range(frames - 1):
        u = torch.full((8,), 2.0)
        u[torch.randperm(8, generator=gen)[:4]] = -1.0
        draws.append((u.view(1, 2, 4).to(device),
                      torch.rand((8,), generator=gen).to(device)))
    state = stepper.init_state(params, seed=1)
    out = []
    for t, frame in enumerate(clip):
        state = stepper.first_step(params, state, frame) if t == 0 else \
            stepper.step(params, state, frame, draws=draws[t - 1])
        # copies: the step updates the canvases in place
        out.append({"canvases": tree_map(
                        lambda x: x.to("cpu", torch.float32, copy=True),
                        state["canvases"]),
                    "grid": state["prev_grid"].cpu(),
                    "dets": tuple(x.cpu()
                                  for x in stepper.fetch_outputs(state))})
    return out


def compare_clips(got, ref):
    """Two ``detection_clip`` results: whether the grids are equal; the
    largest abs difference of every carried canvas relative to that canvas's
    largest |ref value|; and per frame the dets' error, None where
    ``valid`` or ``labels`` differ, else the largest difference of the valid
    dets (each matched to the ref det with the nearest box: two dets whose
    scores nearly tie may swap places) relative to the largest |ref det|."""
    grids = all(torch.equal(a["grid"], b["grid"]) for a, b in zip(got, ref))
    canvas_err = 0.0
    for a, b in zip(got, ref):
        for name, r in b["canvases"].items():
            g = a["canvases"][name]
            pairs = [(g[k], r[k]) for k in r] if isinstance(r, dict) \
                else [(g, r)]
            for x, y in pairs:
                scale = max(y.abs().max().item(), 1e-30)
                canvas_err = max(canvas_err,
                                 (x - y).abs().max().item() / scale)
    dets_err = []
    for a, b in zip(got, ref):
        (gd, gl, gv), (rd, rl, rv) = a["dets"], b["dets"]
        if not (torch.equal(gv, rv) and torch.equal(gl, rl)):
            dets_err.append(None)
            continue
        gd, rd = gd[gv], rd[rv]
        near = (gd[:, None, :4] - rd[None, :, :4]).abs().amax(-1).argmin(1) \
            if len(rd) else torch.zeros(0, dtype=torch.long)
        if len(set(near.tolist())) != len(near):
            dets_err.append(None)
        else:
            dets_err.append(((gd - rd[near]).abs().max() / rd.abs().max())
                            .item() if len(rd) else 0.0)
    return grids, canvas_err, dets_err


@contextlib.contextmanager
def relu_masks(record=None, force=None, flips=None):
    """Within the block, ``ops.layers.relu`` appends the sign mask of each
    input (``x > 0``) to ``record``, or, given ``force``, passes exactly
    where the next mask of ``force`` is true (numpy or tensors, in call
    order) and appends to ``flips`` the number of places where that mask
    and the input's own disagree, and the largest |input| there relative
    to the input's largest.

    Two devices round differently, so an input within rounding of 0 can fall
    on either side of the kink, and every gradient upstream of it then
    differs by up to 1e-2 of its largest value; the same masks on both
    sides make a gradient comparison hold the arithmetic."""
    from blockcopy_tpu_torch.ops import layers as L

    plain = L.relu
    masks = iter(force) if force is not None else None

    def relu(x):
        d = L._data(x).detach()
        if masks is None:
            record.append(d > 0)
            return plain(x)
        m = next(masks)
        want = (m if isinstance(m, torch.Tensor)
                else torch.from_numpy(np.array(m))).to(d.device)
        if want.shape != d.shape:
            raise ValueError(f"mask {tuple(want.shape)} for a ReLU input "
                             f"{tuple(d.shape)}")
        off = want != (d > 0)
        scale = max(d.abs().max().item(), 1e-30)
        flips.append((int(off.sum()),
                      d[off].abs().max().item() / scale if off.any()
                      else 0.0))
        return L.emap(lambda t: torch.where(want, t, torch.zeros_like(t)), x)

    L.relu = relu
    try:
        yield
    finally:
        L.relu = plain


def leaf_err(got, ref) -> float:
    """The largest difference of any leaf of two equally shaped trees,
    relative to that leaf's largest |ref value|."""
    from blockcopy_tpu_torch.policy.optim import tree_leaves

    err = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        err = max(err, (a - b).abs().max().item()
                  / max(b.abs().max().item(), 1e-30))
    return err


def train_parity(steps=2, seed=0, device="cuda"):
    """The detection train step on ``device`` against the CPU: CSP with
    ``stage_blocks=(1, 2, 2, 1)`` at full widths, 128x256 fp32 synthetic
    batches of 2, the validation tool's schedule and loss weights.  Per
    step, from the same state on both devices: the losses; the gradients
    with the device's ReLUs given the CPU's masks (``relu_masks``) and
    without; then each device's Adam + EMA update fed the CPU's gradients.
    Run with TF32 off.
    Returns one dict a step: the loss terms' largest relative error, the
    gradient leaves' largest error relative to the leaf (aligned, and not),
    whether the key sets are equal, the mask disagreements (count, largest
    |input| there relative to the input's largest), and the updated state's
    largest leaf error."""
    from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
    from blockcopy_tpu_torch.policy.optim import tree_map
    from blockcopy_tpu_torch.tasks.detection import train as T
    from blockcopy_tpu_torch.tasks.detection.train_dataset import \
        SyntheticDetTrainDataset
    from blockcopy_tpu_torch.utils.convert import params_to_numpy

    cfg = CSPConfig(stage_blocks=(1, 2, 2, 1))
    tcfg = T.TrainConfig(lr=2e-4, warmup_iters=50, warmup_ratio=0.1,
                         lr_steps=(), iters_per_epoch=10,
                         loss_weights=(1.0, 1.0, 0.1))
    ds = SyntheticDetTrainDataset(2 * steps, 128, 256, seed=5)
    params = init_csp(cfg, seed=seed, device="cpu")
    states = {"cpu": T.init_train_state(params, tcfg),
              "dev": T.init_train_state(
                  tree_map(lambda t: t.to(device, copy=True), params), tcfg)}
    run = lambda key, b: T.loss_and_grads(
        states[key]["params"], *_on(b, "cpu" if key == "cpu" else device),
        cfg, tcfg.loss_weights)
    report = []
    for i in range(steps):
        items = [ds[2 * i], ds[2 * i + 1]]
        batch = [torch.from_numpy(np.stack([it[j] for it in items]))
                 for j in range(4)]
        masks, flips = [], []
        with relu_masks(record=masks):
            loss_c, grads_c = run("cpu", batch)
        _, grads_free = run("dev", batch)
        with relu_masks(force=masks, flips=flips):
            loss_g, grads_g = run("dev", batch)
        keys = sorted(params_to_numpy(grads_g)) == \
            sorted(params_to_numpy(grads_c))
        T.adam_ema_update(states["cpu"], grads_c, tcfg)
        T.adam_ema_update(states["dev"],
                          tree_map(lambda t: t.to(device), grads_c), tcfg)
        report.append({
            "step": i + 1,
            "loss_err": max(abs(loss_g[k].item() - loss_c[k].item())
                            / abs(loss_c[k].item()) for k in loss_c),
            "grad_err": leaf_err(grads_g, grads_c),
            "grad_err_unaligned": leaf_err(grads_free, grads_c),
            "grad_keys_equal": keys,
            "relus": len(masks),
            "mask_flips": sum(f[0] for f in flips),
            "flip_max_rel_input": max((f[1] for f in flips), default=0.0),
            "update_err": leaf_err(
                {k: states["dev"][k] for k in ("params", "m", "v",
                                               "ema_params")},
                {k: states["cpu"][k] for k in ("params", "m", "v",
                                               "ema_params")}),
            "loss_total": loss_c["loss_total"].item()})
    return report


def _on(batch, dev):
    """A (images, maps) batch of CPU tensors on ``dev``."""
    return batch[0].to(dev), tuple(m.to(dev) for m in batch[1:])


def busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profiled(fn, steps):
    """``fn(i)`` for ``i < steps`` under torch's profiler: the loop's host
    ms (fenced by ``synchronize``) and the trace's GPU events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            fn(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]


def device_idle(fn, steps):
    """``profiled``'s wall ms a step, device-busy ms a step (the union of
    the trace's GPU kernel and copy intervals; None where it holds none),
    the idle share 1 - busy / wall, and GPU kernels a step."""
    wall, events = profiled(fn, steps)
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in events]) / 1e3 if events else None
    return {"wall_ms": wall / steps,
            "busy_ms": None if busy is None else busy / steps,
            "idle_share": None if busy is None else 1.0 - busy / wall,
            "kernels": len(events) / steps}


def device_ms(fn, samples=50, inner=10):
    """Median device time of one call of ``fn`` (``device_times``)."""
    return statistics.median(device_times(fn, samples, inner))


def device_times(fn, samples, inner):
    """Device times of one call of ``fn``, one per sample: ``inner`` calls
    are captured in a CUDA graph (so host dispatch does not pace the card)
    and the graph is replayed ``samples`` times between CUDA events, after a
    warm-up on the side stream that then captures them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(inner):
            fn()
    graph.replay()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return times


def tail_stage_ms(fn, calls=20):
    """Device ms per call of ``fn`` in each stage of K2's two-launch fp32
    route (``tail_f32``): ``<BM, true>`` is the 3x3 conv into h2,
    ``<BM, false>`` the 1x1 into y.
    Returns ``{"3x3": (ms, BM), "1x1": (ms, BM)}`` from the profiler's
    kernel records over ``calls`` calls, BM the row tiles it ran."""
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


# -- clip-parallel ranks (chip_smoke.py phase 12) ----------------------------


@contextlib.contextmanager
def _stderr_count(pattern: str):
    """Count the lines of file descriptor 2 that hold ``pattern`` while the
    block runs (threads of C++ libraries, such as gloo's, report there and
    not through Python's warnings), then pass the text on."""
    import os
    import sys
    import tempfile
    sys.stderr.flush()
    saved = os.dup(2)
    box = [0]
    with tempfile.TemporaryFile() as tmp:
        os.dup2(tmp.fileno(), 2)
        try:
            yield box
        finally:
            os.dup2(saved, 2)
            os.close(saved)
            tmp.seek(0)
            text = tmp.read().decode(errors="replace")
            box[0] = text.count(pattern)
            sys.stderr.write(text)


def count_syncs(fn, *args):
    """``fn(*args)`` with torch's sync debug mode warning: its result and
    the number of synchronizing CUDA calls it made, in this thread (as
    Python warnings) and in the threads of the libraries it calls (on
    stderr)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught, \
            _stderr_count("called a synchronizing CUDA operation") as other:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, other[0] + sum("synchronizing" in str(w.message)
                               for w in caught)


def _flat(tree):
    from blockcopy_tpu_torch.policy.optim import tree_leaves
    return torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])


class RecordingGroup(Group):
    """A ``Group`` that keeps a copy of every gradient average's input (the
    rank's own gradients) and output, on the group's device."""

    def __init__(self, group: Group):
        super().__init__(group.rank, group.size, group.device, group.pg)
        self.records = []

    def mean_tree(self, tree):
        from blockcopy_tpu_torch.policy.optim import tree_map
        out = super().mean_tree(tree)
        self.records.append(tuple(tree_map(lambda t: t.detach().clone(), x)
                                  for x in (tree, out)))
        return out


def parallel_stepper_rank(group, model="swiftnet", steps=12):
    """One clip-parallel rank at full width: the main path's stepper
    (SwiftNet-RN50, capacity 64) or the detection stepper (CSP-R50,
    capacity 38, ``csp_cls`` bias 0), 1024x2048 bf16, fast policy,
    REINFORCE every 4th frame, its gradients averaged over ``group``;
    ``init_parallel_state``, ``first_step``, ``steps`` steps of its own
    clip (seeded by rank), on a CUDA device.  A steady frame runs under
    ``set_sync_debug_mode("error")``; a train frame too on NCCL, while on
    gloo, which stages a CUDA all_reduce through the host, its syncs are
    counted instead.  Returns, on the CPU: the launch counts (zeroed just
    before ``init_state``), ms per step (host clock, synchronize-fenced)
    with each step's start and end on the host's monotonic clock
    (``time.perf_counter``, shared by the processes of one host), the train
    frames with their sync counts and policy digests, the rank's own and
    the averaged gradient of the first train frame, and the peak memory in
    GiB.  The steps are the eager parallel step (``parallel_graphs_rank``
    holds the captured ones against it)."""
    import torch.distributed as dist
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.parallel import clip_parallel
    from blockcopy_tpu_torch.policy.optim import tree_map
    torch.backends.cudnn.allow_tf32 = True
    shape, dtype = (1, 1024, 2048, 3), torch.bfloat16
    if model == "swiftnet":
        params, stepper = swiftnet_stepper("resnet50", shape, 64, dtype,
                                           group.device)
    else:
        params, stepper = csp_stepper(shape, 38, dtype, group.device)
        params["head"]["csp_cls"]["b"].zero_()
    frames = synthetic_frames(shape, steps + 1, dtype, seed=group.rank,
                              device=group.device)
    keep = RecordingGroup(group)
    syncs_on_train = dist.get_backend(group.pg) == "gloo"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    state = clip_parallel.init_parallel_state(stepper, params, 1, group.rank)
    first, step = stepper.first_step, functools.partial(stepper.step,
                                                        group=keep)
    state = first(params, state, frames[0])
    torch.cuda.synchronize()
    group.barrier()
    ms, stamps, trained, kept_params = [], [], [], []
    for frame in frames[1:]:
        fi = state["frame_idx"] + 1
        train = fi % stepper.cfg.train_interval == 0 and fi >= 2
        t0 = time.perf_counter()
        if train and syncs_on_train:
            state, syncs = count_syncs(step, params, state, frame)
        else:
            torch.cuda.set_sync_debug_mode("error")
            try:
                state = step(params, state, frame)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs = 0
        torch.cuda.synchronize()
        stamps.append((t0, time.perf_counter()))
        ms.append((stamps[-1][1] - t0) * 1e3)
        if train:
            trained.append((fi, syncs))
            kept_params.append(tree_map(lambda t: t.clone(),
                                        state["policy"]["params"]))
    out = stepper.fetch_outputs(state)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in
                 (out if isinstance(out, tuple) else (out,))
                 if t.is_floating_point())
    return {"launches": dict(kernels.launches), "ms": ms, "stamps": stamps,
            "trained": trained, "finite": finite,
            "digests": [clip_parallel.params_digest(p) for p in kept_params],
            "grad_own": _flat(keep.records[0][0]).cpu(),
            "grad_mean": _flat(keep.records[0][1]).cpu(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "capacity": stepper.capacity}


def parallel_graphs_rank(group, backbone="resnet50", shape=(1, 1024, 2048, 3),
                         capacity=64, dtype="bfloat16", block_size=128,
                         train_interval=4, lockstep=8, timed=12):
    """One clip-parallel rank, the eager parallel step against the captured
    one (``clip_parallel.build_parallel_steps``, ``core/graphs.py``
    ``StepperGraphs`` bound to ``group``): a SwiftNet stepper (fast policy,
    target 0.5, REINFORCE every ``train_interval`` frames) on this rank's
    own clip, two states from ``init_parallel_state``, stepped in lockstep
    over ``lockstep`` frames with the same injected draws (seeded by rank),
    cuDNN's deterministic algorithms on.  After each train frame the
    digests of both policies.  Then ``timed`` more captured steps, the
    draws injected, each fenced by ``synchronize`` on CUDA, with its start
    and end on the host's monotonic clock, under
    ``set_sync_debug_mode("error")`` (on gloo, which stages the all_reduce
    through the host, a train frame's syncs are counted instead).  Returns the
    digests (eager, captured) per train frame, the graphs' keys, whether
    the captured outputs are finite and bitwise the eager ones after the
    lockstep, and on CUDA the launches of the timed steps (zeroed just
    before them), their ms, stamps and train syncs."""
    import torch.distributed as dist
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.parallel import clip_parallel
    cuda = group.device.type == "cuda"
    dtype = getattr(torch, dtype)
    params, stepper = swiftnet_stepper(backbone, shape, capacity, dtype,
                                       group.device, train_interval,
                                       block_size)
    frames = synthetic_frames(shape, lockstep + timed, dtype,
                              seed=group.rank, device=group.device)
    gen = torch.Generator(group.device).manual_seed(100 + group.rank)
    geom = stepper.geom
    draws = [(torch.rand(geom, generator=gen, device=group.device),
              torch.rand((stepper.total,), generator=gen,
                         device=group.device))
             for _ in frames]
    eager = clip_parallel.init_parallel_state(stepper, params, 1, group.rank)
    state = clip_parallel.init_parallel_state(stepper, params, 1, group.rank)
    first, step = clip_parallel.build_parallel_steps(stepper, group)
    digests = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for t in range(lockstep):
            if t == 0:
                eager = stepper.first_step(params, eager, frames[0])
                state = first(params, state, frames[0])
                continue
            eager = stepper.step(params, eager, frames[t], draws[t],
                                 group=group)
            state = step(params, state, frames[t], draws[t])
            if stepper.is_train_frame(t + 1):
                digests.append(tuple(clip_parallel.params_digest(
                    s["policy"]["params"]) for s in (eager, state)))
        same = all(torch.equal(a, b) for a, b in zip(
            _flat_outputs(stepper, eager), _flat_outputs(stepper, state)))
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in _flat_outputs(stepper, state))
        ms, stamps, trained = [], [], []
        syncs_on_train = cuda and dist.get_backend(group.pg) == "gloo"
        if cuda:
            torch.cuda.synchronize()
        group.barrier()
        kernels.reset_launches()
        for t in range(lockstep, lockstep + timed):
            train = stepper.is_train_frame(state["frame_idx"] + 1)
            t0 = time.perf_counter()
            if train and syncs_on_train:
                state, syncs = count_syncs(step, params, state, frames[t],
                                           draws[t])
            else:
                if cuda:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    state, syncs = step(params, state, frames[t],
                                        draws[t]), 0
                finally:
                    if cuda:
                        torch.cuda.set_sync_debug_mode(0)
            if cuda:
                torch.cuda.synchronize()
            stamps.append((t0, time.perf_counter()))
            ms.append((stamps[-1][1] - t0) * 1e3)
            if train:
                trained.append((t + 1, syncs))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {"digests": digests, "outputs_equal": same, "finite": finite,
            "launches": dict(kernels.launches), "ms": ms, "stamps": stamps,
            "trained": trained}


def _flat_outputs(stepper, state):
    out = stepper.fetch_outputs(state)
    return out if isinstance(out, tuple) else (out,)


# -- PNG files without PIL (the card's machine may have none) -----------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img, palette=None) -> bytes:
    """``img`` (uint8) as a PNG file: (H, W) gray, or palette indices when
    ``palette`` ((n, 3) uint8 colours) is given; (H, W, 3) RGB.  8 bits, no
    interlace, one IDAT.  Row y is filtered with filter ``y % 5`` (None,
    Sub, Up, Average, Paeth), so a decoder meets every filter."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    if bpp not in (1, 3) or (palette is not None and bpp != 1):
        raise ValueError(f"png_bytes writes gray, palette or RGB, got "
                         f"{img.shape}")
    color = 2 if bpp == 3 else (0 if palette is None else 3)
    rows = img.reshape(h, w * bpp).astype(np.int16)
    zero_row = np.zeros((1, w * bpp), np.int16)
    zero_px = np.zeros((h, bpp), np.int16)
    up = np.vstack([zero_row, rows[:-1]])
    left = np.hstack([zero_px, rows[:, :-bpp]])
    upleft = np.hstack([zero_px, up[:, :-bpp]])
    filt = np.arange(h) % 5
    preds = (0, left, up, (left + up) // 2, _paeth(left, up, upleft))
    raw = np.empty((h, w * bpp + 1), np.uint8)
    raw[:, 0] = filt
    for f, pred in enumerate(preds):
        sel = filt == f
        body = rows[sel] if f == 0 else rows[sel] - pred[sel]
        raw[sel, 1:] = (body % 256).astype(np.uint8)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    if palette is not None:
        out += _chunk(b"PLTE", np.ascontiguousarray(palette, np.uint8)
                      .tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw.tobytes())) \
        + _chunk(b"IEND", b"")


def write_png(path, img, palette=None) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(png_bytes(img, palette))


def street_frame(height, width, clip, t, seed=0) -> np.ndarray:
    """A (H, W, 3) uint8 frame of clip ``clip`` at time ``t``: a blocky
    background with fine noise (fixed for the clip) and a square (160 px,
    or half the height if less) sliding along the diagonal, inverted."""
    rs = np.random.RandomState(seed + clip)
    coarse = rs.randint(0, 240, ((height + 7) // 8, (width + 7) // 8, 3))
    img = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:height, :width]
    img = (img + rs.randint(0, 16, (height, width, 3))).astype(np.uint8)
    side = min(160, height // 2)
    s = (37 * (clip + t)) % (height - side)
    img[s:s + side, s:s + side] = 255 - img[s:s + side, s:s + side]
    return img


def cityscapes_layout(root, height, width, clips=2, frames=4,
                      splits=("train", "val"), labels=True, seed=0,
                      city="synth"):
    """Write a Cityscapes-layout directory under ``root``: per split,
    ``clips`` annotated frames in ``leftImg8bit/<split>/<city>/`` (frame 19
    of sequence c, as Cityscapes annotates the 20th frame of a snippet),
    the ``frames`` frames ending there in ``leftImg8bit_sequence/``, and
    with ``labels`` a gray ``gtFine`` label-id map (ids 0-33) per annotated
    frame.  Returns the number of files written."""
    root = Path(root)
    written = 0
    for si, split in enumerate(splits):
        for c in range(clips):
            clip = si * clips + c
            for t in range(frames):
                fid = 19 - (frames - 1 - t)
                name = f"{city}_{c:06d}_{fid:06d}_leftImg8bit.png"
                data = png_bytes(street_frame(height, width, clip, t, seed))
                dirs = ["leftImg8bit_sequence"] + (
                    ["leftImg8bit"] if t == frames - 1 else [])
                for top in dirs:
                    path = root / top / split / city / name
                    path.parent.mkdir(parents=True, exist_ok=True)
                    path.write_bytes(data)
                    written += 1
            if labels:
                rs = np.random.RandomState(seed + 7919 + clip)
                ids = np.repeat(np.repeat(
                    rs.randint(0, 34, ((height + 15) // 16,
                                       (width + 15) // 16)), 16, 0), 16, 1)
                write_png(root / "gtFine" / split / city
                          / f"{city}_{c:06d}_000019_gtFine_labelIds.png",
                          ids[:height, :width])
                written += 1
    return written
