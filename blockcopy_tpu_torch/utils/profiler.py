"""Hierarchical named timers, level-gated (counterpart of
``blockcopy_tpu/utils/profiler.py``).

Spans are fenced with ``torch.cuda.synchronize()`` only when the profiler is
on (level > 0), so at level 0 the frame loop stays free of syncs.  For
kernel-level detail use ``trace_to`` (``torch.profiler``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class Timings:
    def __init__(self, level: int = 0):
        self.level = level
        self.reset()

    def set_level(self, level: int):
        self.level = level

    def reset(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.image_count = 0

    def add_count(self, n: int = 1):
        self.image_count += n

    @contextlib.contextmanager
    def env(self, name: str, level: int = 5):
        if self.level <= 0 or level > self.level:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @staticmethod
    def _sync():
        # a CPU run has no device work to wait for
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __repr__(self):
        if not self.totals:
            return "Timings: (empty)"
        lines = ["Timings (avg ms/image):" if self.image_count else
                 "Timings (total s / count):"]
        for name in sorted(self.totals):
            tot, cnt = self.totals[name], self.counts[name]
            if self.image_count:
                lines.append(
                    f"  {name:<45s} {1000*tot/self.image_count:9.3f} ms/img "
                    f"({cnt} calls)")
            else:
                lines.append(f"  {name:<45s} {tot:9.4f} s ({cnt} calls)")
        return "\n".join(lines)


timings = Timings()


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the body with ``torch.profiler`` (CPU and, where present,
    CUDA activity) and write a Chrome trace to ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
