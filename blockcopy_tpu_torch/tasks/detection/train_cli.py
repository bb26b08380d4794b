"""CSP detector training CLI (counterpart of
``blockcopy_tpu/tasks/detection/train_cli.py``), flag for flag, plus
``--device``.

Offline training as the reference's inherited stack (losses
``csp_head.py:332-416``, runner ``mean_teacher_runner.py``, launcher
``apis/train.py:19-100``): dataset -> augmentation and GT maps -> the train
step (Adam, step LR, warm-up, mean-teacher EMA) -> per-epoch checkpoints.
Checkpoints are the JAX package's flat ``.npz`` trees, loadable by either
package's detection CLI (``--checkpoint epoch_N[_teacher].npz``); the
teacher plays the reference's ``.pth.stu`` mean-teacher weights.  The last
stdout line is one JSON object.

    python -m blockcopy_tpu_torch.tasks.detection.train_cli --synthetic \\
        --epochs 2 --steps-per-epoch 20 --out work_dirs/csp   # on the card
    python -m blockcopy_tpu_torch.tasks.detection.train_cli --synthetic \\
        --crop-height 128 --crop-width 256 --steps-per-epoch 4 \\
        --device cpu                                # on the CPU, when asked
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from blockcopy_tpu_torch.data.loader import PrefetchLoader
from blockcopy_tpu_torch.device import resolve_device, to_device
from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
from blockcopy_tpu_torch.tasks.detection.train import (TrainConfig,
                                                       init_train_state,
                                                       load_train_state_,
                                                       make_train_step)
from blockcopy_tpu_torch.tasks.detection.train_dataset import (
    CityPersonsTrainDataset,
    CSPTrainTransform,
    SyntheticDetTrainDataset,
)
from blockcopy_tpu_torch.utils.checkpoint import load_npz, save_params

logger = logging.getLogger("blockcopy_tpu_torch.detection.train")


def build_argparser():
    p = argparse.ArgumentParser(description="BlockCopy CSP training "
                                "(PyTorch/CUDA)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--ann-file", type=str, default="")
    p.add_argument("--img-prefix", type=str, default="")
    p.add_argument("--crop-height", type=int, default=640)
    p.add_argument("--crop-width", type=int, default=1280)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=0,
                   help="0 = one pass over the dataset per epoch")
    p.add_argument("--num-samples", type=int, default=64,
                   help="synthetic dataset size")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--warmup-iters", type=int, default=500)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="work_dirs/csp")
    p.add_argument("--resume", type=str, default="",
                   help="npz full train state to resume from")
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs without a GPU")
    return p


def _read_losses(losses):
    """The loss terms as host floats, in one transfer (read before the
    next step: under a CUDA graph they are its buffers)."""
    vals = torch.stack(list(losses.values())).tolist()
    return dict(zip(losses, vals))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    transform = CSPTrainTransform(
        crop_size=(args.crop_height, args.crop_width), seed=args.seed)
    if args.synthetic:
        dataset = SyntheticDetTrainDataset(
            args.num_samples, args.crop_height, args.crop_width,
            seed=args.seed, transform=transform)
    elif args.ann_file:
        dataset = CityPersonsTrainDataset(args.ann_file, args.img_prefix,
                                          transform)
    else:
        raise AttributeError("need --synthetic or --ann-file/--img-prefix")

    csp_cfg = CSPConfig()
    # iters_per_epoch counts optimizer steps (the unit `step` advances in),
    # full batches per pass, not dataset samples
    tcfg = TrainConfig(lr=args.lr, warmup_iters=args.warmup_iters,
                       iters_per_epoch=args.steps_per_epoch
                       or max(1, len(dataset) // args.batch_size))
    params = init_csp(csp_cfg, seed=args.seed, device=device)
    state = init_train_state(params, tcfg)
    if args.resume and os.path.isfile(args.resume):
        # into the state's own tensors, which the captured step holds
        load_train_state_(state, load_npz(args.resume, state, device=device))
        logger.info("resumed from %s (step %d)", args.resume,
                    int(state["step"]))
    # JAX's jitted, donated step: a CUDA graph on the card
    train_step = make_train_step(csp_cfg, tcfg, device)

    class _Shuffled:
        """Per-epoch random sample order (the reference trains with a
        shuffling sampler), so --steps-per-epoch sees a different prefix
        each epoch."""

        def __init__(self, order):
            self.order = order

        def __len__(self):
            return len(dataset)

        def __getitem__(self, i):
            return dataset[int(self.order[i])]

    def batches(epoch_seed):
        order = np.random.RandomState(args.seed + 7919 * epoch_seed) \
            .permutation(len(dataset))
        loader = PrefetchLoader(_Shuffled(order), num_workers=args.workers)
        group = []
        for item in loader:
            group.append(item)
            if len(group) == args.batch_size:
                # on the device before the step (pinned, async): the
                # graph copies device tensors into its inputs
                yield (to_device(np.stack([g[0] for g in group]), device),
                       tuple(to_device(np.stack([g[1 + i] for g in group]),
                                       device) for i in range(3)))
                group = []

    history = []
    first_losses = None
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        n_steps = 0
        last = {}
        losses = None
        for imgs, gt_maps in batches(epoch):
            state, losses = train_step(state, imgs, gt_maps)
            n_steps += 1
            if n_steps % args.log_interval == 0 or n_steps == 1:
                last = _read_losses(losses)
                logger.info("epoch %d step %d: %s", epoch + 1, n_steps,
                            {k: round(v, 4) for k, v in last.items()})
                if first_losses is None:
                    first_losses = last
            if args.steps_per_epoch and n_steps >= args.steps_per_epoch:
                break
        if losses is None:
            raise RuntimeError(
                f"epoch {epoch + 1}: no full batch produced: the dataset has "
                f"{len(dataset)} samples for --batch-size {args.batch_size}")
        if not last:
            last = _read_losses(losses)
        history.append(last)
        dt = time.perf_counter() - t0
        # the student, the mean teacher (the reference's .pth.stu), both
        # loadable by the eval CLI, and the full state to resume from
        ep = epoch + 1
        save_params(os.path.join(args.out, f"epoch_{ep}.npz"),
                    state["params"])
        save_params(os.path.join(args.out, f"epoch_{ep}_teacher.npz"),
                    state["ema_params"])
        save_params(os.path.join(args.out, "latest_state.npz"), state)
        logger.info("epoch %d done (%d steps, %.1fs): checkpoints saved "
                    "under %s", ep, n_steps, dt, args.out)

    result = {"epochs": args.epochs, "final_losses": history[-1],
              "first_losses": first_losses, "out": args.out,
              "step": int(state["step"])}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
