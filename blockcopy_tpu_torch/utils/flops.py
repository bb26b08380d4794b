"""Analytic compute-cost accounting (counterpart of
``blockcopy_tpu/utils/flops.py``).

``ExecCtx`` tallies conv MACs from shapes while a step runs; the ladder
engine records each capacity's tally once and averages over the frames each
capacity ran.  Capacity padding slots count as work: masked compute is
executed compute.
"""

from __future__ import annotations


def policy_net_macs(policy_h: int, policy_w: int, num_classes: int,
                    width_factor: int = 2, arch: str = "ref") -> float:
    """MACs of one policy-net forward at policy input resolution
    (= frame/4 * 128/block_size), layer for layer as ``policy/net.py``."""
    h, w = policy_h, policy_w
    cin = 3 + 3 + num_classes + 1
    if arch == "fast":
        # space-to-depth-4 stem: all convs at 1/16 the positions
        h, w = h // 4, w // 4
        c0, c1, c2 = cin * 16, 128, 256
        m = float(h * w * c1 * c0)                 # stem 1x1
        m += 2 * h * w * c1 * c1 * 9               # block1
        h, w = h // 2, w // 2                      # block2 (stride 2)
        m += h * w * c2 * c1 * 9 + h * w * c2 * c2 * 9 + h * w * c2 * c1
        h, w = h // 2, w // 2                      # head0 (stride 2)
        m += h * w * c2 * c2 * 9
        h, w = h // 2, w // 2                      # head1 -> 1 logit
        m += h * w * 1 * c2 * 9
        return m
    if arch != "ref":
        raise ValueError(f"unknown policy arch {arch!r}")
    c1, c2, c3 = 16 * width_factor, 32 * width_factor, 64 * width_factor
    m = 0.0
    m += h * w * c1 * cin * 9                      # conv1 3x3
    m += 2 * h * w * c1 * c1 * 9                   # layer1 basic block
    h, w = h // 2, w // 2                          # layer2 (stride 2)
    m += h * w * c2 * c1 * 9 + h * w * c2 * c2 * 9 + h * w * c2 * c1
    h, w = h // 2, w // 2                          # layer3 (stride 2)
    m += h * w * c3 * c2 * 9 + h * w * c3 * c3 * 9 + h * w * c3 * c2
    planes = 128
    h, w = h // 2, w // 2                          # head0 (stride 2)
    m += h * w * planes * c3 * 9
    h, w = h // 2, w // 2                          # head1
    m += h * w * planes * planes * 9
    h, w = h // 2, w // 2                          # head2 -> 1 logit
    m += h * w * 1 * planes * 9
    return m


class FlopsTracker:
    """Per-frame MACs of the ladder engine.

    ``record_trace(capacity, macs)`` once per capacity; ``record_frame``
    per frame (capacity 0: a copy-only frame).  The average includes the
    policy net for every image whose frame ran it.
    """

    def __init__(self, policy_macs_per_frame: float = 0.0):
        self.macs_per_capacity = {}      # capacity -> {module: macs}
        self.frames = []
        self.images = 0
        self.policy_macs = policy_macs_per_frame
        self.policy_frames = 0

    def record_trace(self, capacity: int, macs):
        """``macs``: per-module dict (``ExecCtx.macs_by_module()``) or a
        plain float (stored under module '')."""
        if not isinstance(macs, dict):
            macs = {"": float(macs)}
        self.macs_per_capacity[capacity] = macs

    def record_frame(self, capacity: int, policy_ran: bool,
                     images: int = 1):
        self.frames.append(capacity)
        self.images += images
        if policy_ran:
            # the policy net runs batched: count per image
            self.policy_frames += images

    def reset_frames(self):
        self.frames = []
        self.policy_frames = 0
        self.images = 0

    def average_macs_by_module(self) -> dict:
        """Average MACs per image by top-level module, plus ``policy``."""
        if not self.images:
            return {}
        acc: dict = {}
        for c in self.frames:
            for mod, m in self.macs_per_capacity.get(c, {}).items():
                acc[mod] = acc.get(mod, 0.0) + m
        if self.policy_frames:
            acc["policy"] = self.policy_macs * self.policy_frames
        return {k: v / self.images for k, v in acc.items()}

    def average_macs(self) -> float:
        """Average MACs per image (a batched step's cost spreads over its
        batch)."""
        return sum(self.average_macs_by_module().values())

    def average_gmacs(self) -> float:
        return self.average_macs() / 1e9


def format_gmacs_breakdown(by_module: dict, images_note: str = "") -> str:
    """A per-module GMACs table in the shape of the reference's
    flops-counter output."""
    total = sum(by_module.values())
    lines = [f"GMACs per image{images_note}: {total / 1e9:.3f}"]
    for mod, m in sorted(by_module.items(), key=lambda kv: -kv[1]):
        pct = 100.0 * m / total if total else 0.0
        lines.append(f"  {mod:<12s} {m / 1e9:9.3f} GMACs  ({pct:4.1f}%)")
    return "\n".join(lines)
