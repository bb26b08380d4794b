"""Where one steady step of the main path spends its time, on the GPU.

    python3 -m blockcopy_tpu_torch.tools.profile_step [--steps 8]
        [--engine stepper|ladder|train] [--model swiftnet|csp]
        [--backbone resnet50] [--block-size 128] [--eager]

Runs the main path of ``chip_smoke.py`` (SwiftNet-RN50, 1024x2048 bf16, fast
policy, block 128, target 0.5, REINFORCE every 4th frame), warms up past the
first two train frames, then traces ``--steps`` steps with
``torch.profiler`` and prints one JSON line.  The steps are those the CLIs
run: the stepper's and each ladder capacity's as CUDA graphs
(``core/graphs.py``), captured in the warm-up; ``--eager`` runs them op by
op (the line's ``graphs`` says which).  ``--backbone`` and
``--block-size`` change SwiftNet's backbone and block size (the stepper's
capacity stays half the grid: 16 of 32 blocks at block 256); the
``BLOCKCOPY_TPU_FUSED_BOTTLENECK`` switch (``0`` runs every bottleneck
unfused) is the model's, read from the environment when it is imported;
the line's ``fused_bottleneck`` is its value (null: the default, on).
``--model csp`` runs the detection step of ``chip_smoke.py`` phase 9a
instead (CSP-R50, 1024x2048 bf16, fast policy, block 128, target 0.3: 38 of
128 blocks).
``--engine ladder`` runs the ladder engine of ``chip_smoke.py`` phase 8a
(``BlockCopyModel`` with the CLI's default settings, one clip), or with
``--model csp`` that of phase 10a (``CSPBlockCopy`` from
``configs/csp/csp_r50_clip_blockcopy_030.py``, the ``csp_cls`` bias 0), and
adds the capacities of the traced frames.  ``--engine train`` runs the
detection train step of ``chip_smoke.py`` phase 11a instead (CSP-R50, fp32,
640x1280 crops, batch 2, cuDNN TF32 on: the train CLI's defaults).  The
line holds:

* ``wall_ms_per_step``: host clock over the traced steps, fenced by
  ``torch.cuda.synchronize()`` (the profiler's own cost included);
* ``device_busy_ms_per_step``: the union of the GPU kernel and copy
  intervals in the trace, per step; ``device_idle_share`` = 1 - busy / wall;
* ``kernels_per_step``: GPU kernel launches per step;
* ``k2_launches_per_step``: the bottleneck-tail wrapper's launches per
  step, by route (``ops/kernels`` ``launches``);
* ``halo_pieces_launches_per_step``: the halo kernel's ``halo_pieces``
  launches per step (one, the stem's plane pool: the fused tails read
  their halo from the strips inside K2);
* ``top``: the kernels with the most device time per step, by name.

Without a GPU it exits non-zero; if the trace holds no device events it
prints ``null`` for the device numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from blockcopy_tpu_torch.core.graphs import StepperGraphs
from blockcopy_tpu_torch.models import swiftnet
from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.tools.measure import (busy_us, csp_stepper,
                                               profiled, swiftnet_stepper,
                                               synthetic_frames)


CSP_CONFIG = (Path(__file__).resolve().parents[2] / "configs" / "csp"
              / "csp_r50_clip_blockcopy_030.py")


def _stepper(shape, args):
    """The stepper's per-frame call: ``first_step`` then ``step``."""
    if args.model == "csp":
        params, stepper = csp_stepper(shape, 38, torch.bfloat16, "cuda")
    else:
        params, stepper = swiftnet_stepper(args.backbone, shape, None,
                                           torch.bfloat16, "cuda",
                                           block_size=args.block_size)
    box = {"state": stepper.init_state(params, seed=1)}
    steps = stepper if args.eager else StepperGraphs(stepper)

    def run(t, frame):
        fn = steps.first_step if t == 0 else steps.step
        box["state"] = fn(params, box["state"], frame)
        return None

    return run


def _ladder(shape, args):
    """The ladder engine's per-frame call; returns the frame's count."""
    if args.model == "csp":
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
        cfg = SwiftNetConfig(backbone=args.backbone, num_classes=19)
        model = BlockCopyModel(
            make_apply_fn(cfg),
            init_swiftnet(cfg, seed=0, dtype=torch.bfloat16, device="cuda"),
            default_settings(block_size=args.block_size), device="cuda")
    model.graphs = not args.eager

    def run(t, frame):
        model(frame)
        return model.policy_meta["num_exec"]

    return run


def _train():
    """The detection train step at the train CLI's defaults, on one
    synthetic batch uploaded once."""
    import numpy as np
    from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
    from blockcopy_tpu_torch.tasks.detection import train as T
    from blockcopy_tpu_torch.tasks.detection.train_dataset import \
        SyntheticDetTrainDataset
    torch.backends.cudnn.allow_tf32 = True
    cfg, tcfg = CSPConfig(), T.TrainConfig(iters_per_epoch=32)
    items = [SyntheticDetTrainDataset(2, 640, 1280, seed=0)[i]
             for i in range(2)]
    images, *maps = [torch.from_numpy(np.stack([it[k] for it in items]))
                     .cuda() for k in range(4)]
    step = T.make_train_step(cfg, tcfg, "cuda")
    box = {"state": T.init_train_state(init_csp(cfg, seed=0, device="cuda"),
                                       tcfg)}

    def run(t, frame):
        box["state"], _ = step(box["state"], images, tuple(maps))
        return None

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--engine", choices=("stepper", "ladder", "train"),
                    default="stepper")
    ap.add_argument("--model", choices=("swiftnet", "csp"),
                    default="swiftnet")
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--eager", action="store_true",
                    help="run the steps op by op, not as CUDA graphs")
    args = ap.parse_args()
    if args.model != "swiftnet" and (args.backbone != "resnet50"
                                     or args.block_size != 128):
        ap.error("--backbone and --block-size are SwiftNet's")
    if not torch.cuda.is_available():
        print("profile_step: CUDA is not available", file=sys.stderr)
        return 2
    shape = (1, 1024, 2048, 3)
    run = {"stepper": lambda: _stepper(shape, args),
           "ladder": lambda: _ladder(shape, args),
           "train": _train}[args.engine]()
    frames = [None] * (args.warmup + args.steps + 1) \
        if args.engine == "train" else synthetic_frames(
            shape, args.warmup + args.steps + 1, torch.bfloat16)
    for t in range(args.warmup + 1):
        run(t, frames[t])
    torch.cuda.synchronize()

    counts = []
    kernels.reset_launches()
    first = args.warmup + 1
    wall_ms, events = profiled(
        lambda i: counts.append(run(first + i, frames[first + i])),
        args.steps)
    steps = args.steps
    k2 = {key: kernels.launches[key] / steps for key in (
        "bottleneck_tail", "bottleneck_tail_rows", "bottleneck_tail_f32")}
    result = {"device": torch.cuda.get_device_name(0), "steps": steps,
              "engine": args.engine,
              "model": "csp" if args.engine == "train" else args.model,
              "backbone": args.backbone, "block_size": args.block_size,
              "fused_bottleneck": swiftnet.FUSED_BOTTLENECK,
              "graphs": args.engine != "train" and not args.eager,
              "k2_launches_per_step": k2,
              "halo_pieces_launches_per_step":
                  kernels.launches["halo_pieces"] / steps,
              "wall_ms_per_step": wall_ms / steps,
              "device_busy_ms_per_step": None, "device_idle_share": None,
              "kernels_per_step": None, "top": None}
    if args.engine == "ladder":
        result["capacities"] = counts
    if events:
        busy_ms = busy_us([(e.time_range.start, e.time_range.end)
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
