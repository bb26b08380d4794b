"""The port's tracing: host spans, device marks and counters, gated by one
level (counterpart of ``blockcopy_tpu/utils/profiler.py``).

``timings.set_level(n)`` (the CLIs' ``--timings n``) switches it:

* level 0: nothing is recorded and no mark is captured;
* level 1 and above: the ``env`` spans of that level or below;
* level 2 and above: also the ``bc.*`` spans of the steps (``bc.step``,
  ``bc.graph.check``, ``bc.graph.inputs``, ``bc.graph.launch``,
  ``bc.upload``) and the counters (``count``);
* level 3: also the device marks (``enter_step`` / ``mark`` / ``exit_step``).

A span (``timings.env(name, level)``) is the host's ``perf_counter`` time
inside it, totalled and counted; nothing waits for the card, so it is the
time the host spent, not the device's.  While it is recorded it is also a
``torch.profiler.record_function`` range, so a profiler's trace shows it on
the device trace's clock.

A mark is a one-thread kernel (``csrc/mark.cu``: ``mark_enter``, ``mark``,
``mark_exit``) launched on the current stream, which stamps the card's clock
into a ring on the device.  Launched where a step's host code runs, it is
captured into the step's CUDA graph and stamps on every replay with no host
involvement.  ``enter_step(kind)`` opens a step, each ``mark(name)`` ends
the span ``name`` (from the previous mark), ``exit_step()`` ends the last
span, ``writeback``.  Work forked onto another stream inside a span is not
covered unless it is joined before the span's mark.  On the CPU a mark
appends ``perf_counter_ns`` to a host ring of the same capacity.

``report()`` returns the host spans, the counters and the rings, read back
in one copy each (after the caller's synchronize: nothing here
synchronizes), paired into per-step lists of ``(span, ns)`` in step order.
``reset()`` clears all of them.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

RING = 1 << 18      # marks a ring holds: 7 minutes of 6-mark steps at 100/s
_HEAD = 2           # the device ring's cursor and drop count
_ROLES = ("enter", "span", "exit")
EXIT_SPAN = "writeback"


class _Span:
    __slots__ = ("owner", "name", "t0", "rf")

    def __init__(self, owner, name):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        self.owner.totals[self.name] += dt
        self.owner.counts[self.name] += 1
        return False


_OFF = contextlib.nullcontext()


class Timings:
    """Host spans and counters, level-gated (see the module's docstring)."""

    def __init__(self, level: int = 0):
        self.level = level
        self.reset()

    def set_level(self, level: int):
        self.level = level

    def reset(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.counters = defaultdict(float)
        self.image_count = 0

    def add_count(self, n: int = 1):
        self.image_count += n

    def env(self, name: str, level: int = 5):
        """A span of the host's time, recorded where ``level`` is at most
        the profiler's."""
        if self.level <= 0 or level > self.level:
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n: float = 1) -> None:
        """Add ``n`` to counter ``name`` (level 2 and above)."""
        if self.level >= 2:
            self.counters[name] += n

    def spans(self) -> Dict[str, List[float]]:
        return {k: [self.totals[k], self.counts[k]]
                for k in sorted(self.totals)}

    def __repr__(self):
        return _host_text(self.spans(), self.image_count)


def _host_text(spans, images: int) -> str:
    if not spans:
        return "Timings: (empty)"
    lines = ["Timings, host time (avg ms/image):" if images
             else "Timings, host time (total s / count):"]
    for name, (tot, cnt) in spans.items():
        if images:
            lines.append(f"  {name:<45s} {1000*tot/images:9.3f} ms/img "
                         f"({cnt} calls)")
        else:
            lines.append(f"  {name:<45s} {tot:9.4f} s ({cnt} calls)")
    return "\n".join(lines)


timings = Timings()


# -- device marks --------------------------------------------------------------

_ids: Dict[Tuple[str, str], int] = {}
_marks: List[Tuple[str, str]] = []     # id -> (role, name)


def _mark_id(role: str, name: str) -> int:
    key = (role, name)
    if key not in _ids:
        _ids[key] = len(_marks)
        _marks.append(key)
    return _ids[key]


class _Ring:
    """Where a device's marks land: an int64 tensor on a card (cursor,
    drops, then ``(id, ns)`` pairs), a list on the CPU."""

    def __init__(self, device: torch.device, capacity: int):
        self.device, self.capacity = device, capacity
        if device.type == "cuda":
            self.buf = torch.zeros(_HEAD + 2 * capacity, dtype=torch.int64,
                                   device=device)
        else:
            self.host: List[Tuple[int, int]] = []
            self.dropped = 0

    def put(self, role: int, mid: int) -> None:
        if self.device.type != "cuda":
            if len(self.host) < self.capacity:
                self.host.append((mid, time.perf_counter_ns()))
            else:
                self.dropped += 1
            return
        from blockcopy_tpu_torch.ops import kernels
        from blockcopy_tpu_torch.ops.kernels import build
        stream = torch.cuda.current_stream(self.device).cuda_stream
        build.check(_lib().mark_launch(role, self.buf.data_ptr(),
                                       self.capacity, mid, stream), "mark")
        kernels.launches["mark"] += 1

    def read(self) -> Tuple[List[Tuple[int, int]], int]:
        """The marks in the order they were stamped, and the drops."""
        if self.device.type != "cuda":
            return list(self.host), self.dropped
        raw = self.buf.cpu()        # one copy
        n = min(int(raw[0]), self.capacity)
        return ([tuple(p) for p in
                 raw[_HEAD:_HEAD + 2 * n].view(-1, 2).tolist()],
                int(raw[1]))

    def clear(self) -> None:
        if self.device.type == "cuda":
            self.buf[:_HEAD].zero_()
        else:
            self.host.clear()
            self.dropped = 0


def _lib():
    """``csrc/mark.cu``, built and loaded at the first mark on a card."""
    import ctypes

    from blockcopy_tpu_torch.ops.kernels import build
    lib = build.library("mark")
    if not getattr(lib, "_typed", False):
        lib.mark_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
        lib.mark_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


_rings: Dict[torch.device, _Ring] = {}


def _device(where) -> torch.device:
    return where.device if isinstance(where, torch.Tensor) \
        else torch.device(where)


def marking(where=None) -> bool:
    """Whether marks are on (level 3; ``where``, a tensor or device, not
    on the meta device)."""
    return timings.level >= 3 and (
        where is None or _device(where).type != "meta")


def _put(role: str, name: str, where) -> None:
    if not marking(where):
        return
    dev = _device(where)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ring = _rings.get(dev)
    if ring is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the first mark on a card must come before "
                               "a capture: its ring would be the graph's")
        ring = _rings[dev] = _Ring(dev, RING)
    ring.put(_ROLES.index(role), _mark_id(role, name))


def enter_step(kind: str, where) -> None:
    """Open a step of kind ``kind`` on ``where``'s device."""
    _put("enter", kind, where)


def mark(name: str, where) -> None:
    """End span ``name``: the time since the previous mark."""
    _put("span", name, where)


def exit_step(where) -> None:
    """End the step's last span, ``writeback``."""
    _put("exit", EXIT_SPAN, where)


def pair(marks, dropped: int = 0) -> Dict:
    """Marks in stamped order as steps: ``{"steps": [{"kind", "spans":
    [[name, ns], ...]}], "unpaired": marks outside a whole step, "dropped":
    dropped}``.  A step cut short, by a full ring or a step that never
    exited, is left out and its marks counted as unpaired."""
    steps, cur, prev, unpaired = [], None, 0, 0
    for mid, t in marks:
        role, name = _marks[mid]
        if role == "enter":
            if cur is not None:
                unpaired += 1 + len(cur["spans"])
            cur, prev = {"kind": name, "spans": []}, t
            continue
        if cur is None:
            unpaired += 1
            continue
        cur["spans"].append([name, t - prev])
        prev = t
        if role == "exit":
            steps.append(cur)
            cur = None
    if cur is not None:
        unpaired += 1 + len(cur["spans"])
    return {"steps": steps, "unpaired": unpaired, "dropped": dropped}


# -- the report -----------------------------------------------------------------


def report() -> Dict:
    """Host spans ``{name: [total_s, count]}``, the images counted
    (``add_count``), counters (at level 3 also
    ``marks/dropped`` and ``marks/unpaired``), and each ring's steps
    (``pair``), devices in the order they first marked.  Call it after
    synchronizing the card: each ring is read in one copy."""
    steps, unpaired, dropped = [], 0, 0
    for ring in _rings.values():
        got = pair(*ring.read())
        steps += got["steps"]
        unpaired += got["unpaired"]
        dropped += got["dropped"]
    counters = dict(timings.counters)
    if marking():
        counters["marks/dropped"] = dropped
        counters["marks/unpaired"] = unpaired
    return {"level": timings.level, "spans": timings.spans(),
            "images": timings.image_count, "counters": counters,
            "steps": steps}


def reset() -> None:
    """Clear the spans, the counters and every ring."""
    timings.reset()
    for ring in _rings.values():
        ring.clear()


def device_spans(steps) -> Dict[str, Dict[str, List[float]]]:
    """``{kind: {span: [mean ms, steps]}}`` over ``report()``'s steps."""
    acc: Dict[str, Dict[str, List[float]]] = {}
    for step in steps:
        spans = acc.setdefault(step["kind"], {})
        for name, ns in step["spans"]:
            v = spans.setdefault(name, [0.0, 0])
            v[0] += ns / 1e6
            v[1] += 1
    return {kind: {name: [ms / n, n] for name, (ms, n) in spans.items()}
            for kind, spans in acc.items()}


def text(rep=None) -> str:
    """The host spans, the counters and the device spans a kind of step,
    for a log (the CLIs' ``--timings``)."""
    rep = report() if rep is None else rep
    lines = [_host_text(rep["spans"], rep["images"])]
    if rep["counters"]:
        lines.append("Counters:")
        lines += [f"  {k:<45s} {v:g}" for k, v in
                  sorted(rep["counters"].items())]
    for kind, spans in device_spans(rep["steps"]).items():
        total = sum(ms for ms, _ in spans.values())
        lines.append(f"Device spans, {kind} steps "
                     f"({max(n for _, n in spans.values())}), "
                     f"{total:.3f} ms a step:")
        lines += [f"  {name:<45s} {ms:9.3f} ms" for name, (ms, _) in
                  spans.items()]
    return "\n".join(lines)
