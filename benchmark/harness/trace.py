"""The profiler's trace of whole clips, reduced to what the per-layer
metrics read: device operations by name (count, seconds), the union of
the device's busy intervals, and the longest idle gaps by what the host
was doing."""

from __future__ import annotations

import time
from typing import Dict, List


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def idle_gaps(gpu, cpu, top: int = 10) -> List[list]:
    """The ``top`` longest gaps between device operations, each named by
    the innermost host operation running at its start."""
    gaps, end = [], None
    for s, e, _ in sorted(gpu):
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    out = []
    for length, at in gaps[:top]:
        name, best = "host", None
        for s, e, n in cpu:
            if s <= at <= e and (best is None or s >= best):
                name, best = n, s
        out.append([name, length / 1e6])
    return out


class Traced:
    """``with Traced(device) as t:`` around whole clips, fenced by
    ``synchronize`` on both sides; afterwards ``t.summary``."""

    def __init__(self, device):
        self.device = device
        self.summary = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        from torch.autograd import DeviceType
        gpu, cpu = [], []
        for e in self._prof.events():
            span = (e.time_range.start, e.time_range.end, e.name)
            (gpu if e.device_type == DeviceType.CUDA else cpu).append(span)
        ops: Dict[str, list] = {}
        for s, e, n in gpu:
            op = ops.setdefault(n, [0, 0.0])
            op[0] += 1
            op[1] += (e - s) / 1e6
        self.summary = {
            "window_s": wall,
            "busy_s": busy_us([(s, e) for s, e, _ in gpu]) / 1e6,
            "ops": ops,
            "idle_gaps": idle_gaps(gpu, cpu),
        }
        return False


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")
