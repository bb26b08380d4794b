"""One rank's run: set-up, the measured window, and the comparison.

The window is a closed loop of one stream of clips.  Each frame is
uploaded from host memory (the program's ``device.to_device``: pinned,
asynchronous) and submitted through the program's captured steps (a
clip's ``first_step`` after ``reset_temporal``, then ``step`` with the
frame's uniforms); an event is recorded after it and nothing waits for
it, but that at most ``in_flight`` frames are queued (a decoder's
buffers).  Frames are submitted until ``seconds`` have passed, checked at
clip boundaries, and the window ends at the synchronize after the last.
A few clips drawn from the seed are recorded as served (outputs, grids,
policy state); the reference judges them after the window.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import torch

import programs
from harness import check, program, traffic
from harness.modules import forbidden_modules
from harness.trace import Traced
from harness.weights import realize, sub_seed
import reference
from reference.clip import Served
from reference.policy import flatten, in_channels, spec_policy

PROFILED = (4, 5)      # the clips a --trace 1 run profiles


def model_spec(cfg):
    """The spec of the configuration's reference model's parameters."""
    return reference.model(cfg)[1](cfg)


def initial_policy(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """The policy every rank starts from, by ``program.policy_tensors``'
    paths: parameters from the seed, RMSprop state zero, running cost -1
    (no frame seen)."""
    classes = cfg["num_classes"] if cfg["task"] == "semseg" \
        else cfg["num_classes"] - 1
    params = flatten(realize(spec_policy(in_channels(classes)),
                             sub_seed(seed, 4), torch.float32, device))
    out = {f"params/{k}": v for k, v in params.items()}
    out.update({f"sq/{k}": torch.zeros_like(v) for k, v in params.items()})
    out.update({f"buf/{k}": torch.zeros_like(v) for k, v in params.items()})
    out["running_cost"] = torch.full((), -1.0, device=device)
    return out


def recorded_clips(seed: int) -> tuple:
    """The window's first clip, which starts from the benchmark's own
    policy, and one of clips 1-3 drawn from the seed."""
    return (0, 1 + sub_seed(seed, 5) % 3)


class Recording:
    """A clip as the program served it: its starting policy, each frame's
    outputs and grid (``prog.served``, ``prog`` the configuration's
    program module), the policy after each train frame and at its end.
    Its buffers are allocated in set-up (``Recording(...)``), so that the
    window only copies into them: an allocation there could reach
    ``cudaMalloc``, which waits for the card."""

    def __init__(self, stepper, state, prog, length: int):
        like = lambda tree: {k: torch.empty_like(v) for k, v in tree.items()}
        self.prog = prog
        self.start = like(program.policy_tensors(state))
        self.frames = [like(prog.served(state)) for _ in range(length)]
        self.after = {t: like(program.policy_tensors(state))
                      for t in range(2, length + 1)
                      if stepper.is_train_frame(t)}
        self.end_state = like(program.policy_tensors(state))
        self.count = 0

    @staticmethod
    def _copy(dst, src) -> None:
        for k, v in src.items():
            dst[k].copy_(v)

    def begin(self, state) -> None:
        self._copy(self.start, program.policy_tensors(state))

    def frame(self, state, t: int) -> None:
        self._copy(self.frames[t - 1], self.prog.served(state))
        if t in self.after:
            self._copy(self.after[t], program.policy_tensors(state))
        self.count = t

    def end(self, state) -> None:
        self._copy(self.end_state, program.policy_tensors(state))

    def served(self, geom) -> Served:
        """The recorded frames in the reference's layout."""
        out = Served()
        for rec in self.frames[: self.count]:
            o, g = self.prog.reference_layout(rec, geom)
            out.outputs.append(o)
            out.grids.append(g)
        return out


class Clock:
    """Frame completion times: CUDA events on the card, the host's clock
    after each (synchronous) frame on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks: List = []
        self.start = self._mark()

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def frame(self, in_flight: int) -> None:
        self.marks.append(self._mark())
        if self.cuda and len(self.marks) > in_flight:
            self.marks[-1 - in_flight].synchronize()

    def intervals_ms(self) -> List[float]:
        out, prev = [], self.start
        for m in self.marks:
            out.append(prev.elapsed_time(m) if self.cuda
                       else (m - prev) * 1e3)
            prev = m
        return out


def serve_rank(cell, seed: int, seconds: float, trace: bool, t0: float,
               device, group=None, stop_vote=None) -> Dict:
    """Run one rank of a cell and return its report (host values only).
    ``group`` is the program's clip-parallel group (None on one chip);
    ``stop_vote(flag) -> bool`` agrees the window's end across ranks."""
    cfg, tr = cell.cfg, cell.traffic
    rank = 0 if group is None else group.rank
    log = lambda msg: print(f"[rank {rank}] {time.time() - t0:.2f} s: "
                            f"{msg}", file=sys.stderr, flush=True)
    log("start")
    prog = programs.of(cfg)
    dtype = getattr(torch, cfg["dtype"])
    params = realize(model_spec(cfg), sub_seed(seed, 1), dtype, device)
    log("weights")
    stepper, state, first, step = program.build(cfg, tr["block_size"],
                                                params, device, group)
    pol0 = initial_policy(cfg, seed, device)
    program.load_policy(state, pol0)
    log("program")
    host = traffic.host_clips(tr, cfg, seed, rank, dtype, device)
    draws = traffic.draws(tr, cfg, seed, rank, device)
    log("traffic")
    from blockcopy_tpu_torch.device import to_device

    def serve(slot: int, f: int):
        nonlocal state
        x = to_device(host[slot][f], device)
        t = time.perf_counter()
        if f == 0:
            state = stepper.reset_temporal(state)
            first(params, state, x)
        else:
            step(params, state, x, draws=draws[slot][f - 1])
        return time.perf_counter() - t

    # set-up: the first clip captures every graph this traffic replays
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    for f in range(cfg["clip_length"]):
        serve(0, f)
    sync()
    log("graphs captured")
    program.load_policy(state, pol0)
    recs = {i: Recording(stepper, state, prog, cfg["clip_length"])
            for i in recorded_clips(seed)}
    sync()
    if stop_vote is not None:
        stop_vote(False)        # every rank set up
    setup_s = time.time() - t0
    log("set-up done")

    kinds, profiled, submit_s = [], [], 0.0
    summary = None
    clock = Clock(device)
    w0 = time.perf_counter()
    i = 0
    while True:
        if i > 0 and not (trace and i <= PROFILED[-1]):
            done = time.perf_counter() - w0 >= seconds
            if (stop_vote(done) if stop_vote is not None else done):
                break
        slot = i % tr["clips"]
        if trace and i == PROFILED[0]:
            tracer = Traced(device).__enter__()
        rec = recs.get(i)
        if rec is not None:
            rec.begin(state)
        for f in range(cfg["clip_length"]):
            submit_s += serve(slot, f)
            clock.frame(tr["in_flight"])
            t = f + 1
            kinds.append("first" if t == 1 else
                         "train" if stepper.is_train_frame(t) else "plain")
            # the frame after the profiled clips waits for the trace's
            # teardown: it is left out with them
            profiled.append(trace and (i in PROFILED or (
                i == PROFILED[-1] + 1 and f == 0)))
            if rec is not None:
                rec.frame(state, t)
        if rec is not None:
            rec.end(state)
        if trace and i == PROFILED[-1]:
            tracer.__exit__(None, None, None)
            summary = tracer.summary
            summary["frames"] = len(PROFILED) * cfg["clip_length"]
            summary["kinds"] = kinds[-summary["frames"]:]
        i += 1
    sync()
    window_s = time.perf_counter() - w0
    intervals = clock.intervals_ms()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    geom = stepper.geom
    recs = {i: r for i, r in recs.items() if r.count}
    del first, step, stepper, state, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"window: {len(kinds)} frames in {window_s:.3f} s")
    q = max(1, len(intervals) // 4)
    quarters = [part for part in (intervals[j:j + q]
                                  for j in range(0, 4 * q, q)) if part]
    log("ms a frame by quarter of the window: " + " ".join(
        f"{sum(part) / len(part):.3f}" for part in quarters) + "; longest "
        + " ".join(f"{v:.2f}" for v in sorted(intervals)[-5:]))
    gaps = check.judge(cell, seed, recs, geom, pol0, host, draws, device,
                       group)
    log("reference")
    return {
        "rank": rank, "setup_s": setup_s, "window_s": window_s,
        "frames": len(kinds), "kinds": kinds, "profiled": profiled,
        "intervals_ms": intervals, "submit_s": submit_s,
        "memory_peak_bytes": int(peak), "trace": summary,
        "recorded": {i: r.count for i, r in recs.items()},
        "gaps": gaps, "forbidden": forbidden_modules(),
    }
