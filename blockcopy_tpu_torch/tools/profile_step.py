"""Where one steady step of the main path spends its time, on the GPU.

    python3 -m blockcopy_tpu_torch.tools.profile_step [--steps 8]
        [--engine stepper|ladder] [--model swiftnet|csp]

Runs the main path of ``chip_smoke.py`` (SwiftNet-RN50, 1024x2048 bf16, fast
policy, block 128, target 0.5, REINFORCE every 4th frame), warms up past the
first two train frames, then traces ``--steps`` steps with
``torch.profiler`` and prints one JSON line.  ``--model csp`` runs the
detection step of ``chip_smoke.py`` phase 9a instead (CSP-R50, 1024x2048
bf16, fast policy, block 128, target 0.3: 38 of 128 blocks).
``--engine ladder`` runs the ladder engine of ``chip_smoke.py`` phase 8a
(``BlockCopyModel`` with the CLI's default settings, one clip), or with
``--model csp`` that of phase 10a (``CSPBlockCopy`` from
``configs/csp/csp_r50_clip_blockcopy_030.py``, the ``csp_cls`` bias 0), and
adds the capacities of the traced frames.  The line holds:

* ``wall_ms_per_step``: host clock over the traced steps, fenced by
  ``torch.cuda.synchronize()`` (the profiler's own cost included);
* ``device_busy_ms_per_step``: the union of the GPU kernel and copy
  intervals in the trace, per step; ``device_idle_share`` = 1 - busy / wall;
* ``kernels_per_step``: GPU kernel launches per step;
* ``top``: the kernels with the most device time per step, by name.

Without a GPU it exits non-zero; if the trace holds no device events it
prints ``null`` for the device numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from blockcopy_tpu_torch.tools.measure import (csp_stepper, swiftnet_stepper,
                                               synthetic_frames)


CSP_CONFIG = (Path(__file__).resolve().parents[2] / "configs" / "csp"
              / "csp_r50_clip_blockcopy_030.py")


def _busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _stepper(shape, model):
    """The stepper's per-frame call: ``first_step`` then ``step``."""
    if model == "csp":
        params, stepper = csp_stepper(shape, 38, torch.bfloat16, "cuda")
    else:
        params, stepper = swiftnet_stepper("resnet50", shape, 64,
                                           torch.bfloat16, "cuda")
    box = {"state": stepper.init_state(params, seed=1)}

    def run(t, frame):
        fn = stepper.first_step if t == 0 else stepper.step
        box["state"] = fn(params, box["state"], frame)
        return None

    return run


def _ladder(shape, model_name):
    """The ladder engine's per-frame call; returns the frame's count."""
    if model_name == "csp":
        from blockcopy_tpu_torch.models.builder import build_detector
        from blockcopy_tpu_torch.utils.registry import load_config
        model = build_detector(load_config(str(CSP_CONFIG)),
                               dtype=torch.bfloat16, device="cuda")
        # live boxes: random-init scores all sit below score_thr
        model.params["head"]["csp_cls"]["b"].zero_()
    else:
        from blockcopy_tpu_torch.core.argparser import default_settings
        from blockcopy_tpu_torch.core.engine import BlockCopyModel
        from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                         init_swiftnet,
                                                         make_apply_fn)
        cfg = SwiftNetConfig(backbone="resnet50", num_classes=19)
        model = BlockCopyModel(
            make_apply_fn(cfg),
            init_swiftnet(cfg, seed=0, dtype=torch.bfloat16, device="cuda"),
            default_settings(), device="cuda")

    def run(t, frame):
        model(frame)
        return model.policy_meta["num_exec"]

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--engine", choices=("stepper", "ladder"),
                    default="stepper")
    ap.add_argument("--model", choices=("swiftnet", "csp"),
                    default="swiftnet")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: CUDA is not available", file=sys.stderr)
        return 2
    shape = (1, 1024, 2048, 3)
    run = _stepper(shape, args.model) if args.engine == "stepper" \
        else _ladder(shape, args.model)
    frames = synthetic_frames(shape, args.warmup + args.steps + 1,
                              torch.bfloat16)
    for t in range(args.warmup + 1):
        run(t, frames[t])
    torch.cuda.synchronize()

    counts = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(args.warmup + 1, args.warmup + 1 + args.steps):
            counts.append(run(t, frames[t]))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    steps = args.steps
    result = {"device": torch.cuda.get_device_name(0), "steps": steps,
              "engine": args.engine, "model": args.model,
              "wall_ms_per_step": wall_ms / steps,
              "device_busy_ms_per_step": None, "device_idle_share": None,
              "kernels_per_step": None, "top": None}
    if args.engine == "ladder":
        result["capacities"] = counts
    if events:
        busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                            for e in events]) / 1e3
        by_name = {}
        for e in events:
            name = e.name[:80]
            t, n = by_name.get(name, (0.0, 0))
            by_name[name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
        result.update({
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernels_per_step": len(events) / steps,
            "top": [{"name": name, "ms_per_step": t / steps,
                     "calls_per_step": n / steps}
                    for name, (t, n) in top],
        })
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
