"""SwiftNet + BlockCopy evaluation CLI (counterpart of
``blockcopy_tpu/tasks/semseg/eval.py``, reference
``semantic_segmentation/test_swiftnet.py``), flag for flag, plus
``--device``.

Dataset setup (Cityscapes-seq clips, a demo folder, or ``--synthetic``),
model build and checkpoint load, then one of three engines: the ladder
``BlockCopyModel`` (default), the ``FixedCapacityStepper``
(``--speed-mode``), or the dense model (``--block-policy static``).  A
warmup phase then an eval phase, with a temporal reset per clip, streaming
mIoU, FPS and analytic GMACs; the last stdout line is one JSON object.

Clip-parallel (``--speed-mode`` only): ``--num-devices D`` spawns D ranks
(rank r on ``cuda:r``; with ``--device cpu`` D CPU ranks on gloo), or a
launcher such as ``torchrun`` starts them (``WORLD_SIZE``).  Each rank steps
clip d of every group of D clips, frame-synchronous; the policy's gradients
are averaged over the ranks.  Rank 0 reports: the confusion matrices and
image counts summed over the ranks, FPS on its clock after a fence every
rank passes.

    python -m blockcopy_tpu_torch.tasks.semseg.eval --synthetic \\
        --model-backbone resnet50 --half            # on the card
    python -m blockcopy_tpu_torch.tasks.semseg.eval --synthetic --res 256 \\
        --device cpu                                # on the CPU, when asked
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

from blockcopy_tpu_torch.core.argparser import add_argparser_arguments
from blockcopy_tpu_torch.core.blocked import ExecCtx
from blockcopy_tpu_torch.core.engine import BlockCopyModel
from blockcopy_tpu_torch.core.graphs import CallGraphs, StepperGraphs
from blockcopy_tpu_torch.data import transforms as et
from blockcopy_tpu_torch.data.cityscapes_vid import CityscapesVid
from blockcopy_tpu_torch.data.demo import DemoImageDataset
from blockcopy_tpu_torch.data.loader import PrefetchLoader
from blockcopy_tpu_torch.models.swiftnet import (
    SwiftNetConfig,
    init_swiftnet,
    make_apply_fn,
    swiftnet_apply,
)
from blockcopy_tpu_torch.ops.layers import resize_bilinear
from blockcopy_tpu_torch.parallel import clip_parallel
from blockcopy_tpu_torch.parallel.distributed import detect_env
from blockcopy_tpu_torch.policy.optim import tree_map
from blockcopy_tpu_torch.utils.checkpoint import load_params
from blockcopy_tpu_torch.utils.flops import format_gmacs_breakdown
from blockcopy_tpu_torch.utils.metrics import StreamSegMetrics
from blockcopy_tpu_torch.utils.profiler import timings

logger = logging.getLogger("blockcopy_tpu_torch.semseg")


class SyntheticClipDataset:
    """Deterministic synthetic video clips (a bright square moving over a
    fixed background) with self-consistent labels, for data-free runs."""

    def __init__(self, num_clips, clip_length, height, width, num_classes=19,
                 seed=0):
        self.num_clips = num_clips
        self.clip_length = clip_length
        self.h, self.w = height, width
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.num_clips

    def __getitem__(self, index):
        rs = np.random.RandomState(self.seed + index)
        base = rs.randn(self.h, self.w, 3).astype(np.float32)
        clip = []
        for t in range(self.clip_length):
            f = base.copy()
            s = (47 * (index + t)) % max(self.h - 200, 1)
            f[s:s + 160, s:s + 160] += 2.0
            clip.append(f)
        label = (np.abs(base[..., 0]) * 7).astype(np.int64) % self.num_classes
        return clip, label, {"relpath": f"synthetic/{index}.png"}


def build_argparser():
    parser = argparse.ArgumentParser(description="BlockCopy Segmentation "
                                     "(PyTorch/CUDA)")
    parser.add_argument("--demo-dir", type=str, default="")
    parser.add_argument("--cityscapes-dir", type=str, default="")
    parser.add_argument("--synthetic", action="store_true",
                        help="run on generated clips (no dataset needed)")
    parser.add_argument("--mode", type=str, default="val",
                        choices=["val", "test"])
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--res", type=int, default=1024,
                        help="smallest image side in pixels")
    parser.add_argument("--clip-length", type=int, default=20)
    parser.add_argument("--workers", type=int, default=6)
    parser.add_argument("--num-clips-warmup", type=int, default=500)
    parser.add_argument("--num-clips-eval", type=int, default=-1)
    parser.add_argument("--model-backbone", default="resnet18", type=str)
    parser.add_argument("--model-checkpoint",
                        default="pretrained/swiftnet_rn18.pth", type=str)
    parser.add_argument("--half", action="store_true",
                        help="bfloat16 model (the policy stays float32)")
    parser.add_argument("--output-dir", default="", type=str)
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--single-clip-loop", action="store_true")
    parser.add_argument("--native-io", action="store_true",
                        help="decode Cityscapes clips with the C++ IO "
                        "library (threaded PNG decode, resize and normalize "
                        "in one pass; with --fast or --mode test no PIL)")
    parser.add_argument("--policy-checkpoint", type=str, default="",
                        help="npz path: load the online policy state before "
                        "warmup if present, save it after warmup")
    parser.add_argument("--speed-mode", action="store_true",
                        help="fixed-capacity stepper: every frame runs the "
                        "same shapes with no host sync")
    parser.add_argument("--num-devices", type=int, default=1,
                        help="clip-parallel over N devices (speed mode "
                        "only): each rank steps one clip on its device, "
                        "the policy gradients are averaged over the ranks")
    parser.add_argument("--timings", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; raises without a GPU) or "
                        "'cpu'")
    add_argparser_arguments(parser)
    return parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    logger.info("Arguments: %s", args)
    if args.num_devices > 1 or detect_env() is not None:
        if not args.speed_mode or args.block_policy == "static":
            raise ValueError("clip-parallel runs need --speed-mode (the "
                             "fixed-capacity stepper)")
        if args.batch_size != 1:
            raise ValueError("clip-parallel runs step one clip per rank: "
                             "use --batch-size 1")
    results = clip_parallel.launch(args.num_devices, args.device, _run,
                                   argv)
    if results is not None:
        print(json.dumps({k: (float(v) if isinstance(v, (int, float,
                                                          np.floating))
                              else v) for k, v in results.items()}))
    return results


def _run(argv, device, group):
    """The CLI's work on ``device``; ``group`` (a
    ``parallel.distributed.Group``, or None for one process) makes it rank
    ``group.rank`` of a clip-parallel run.  Returns the eval results on
    rank 0, None on the others."""
    args = build_argparser().parse_args(argv)
    mesh = group is not None
    num_classes = args.block_num_classes
    timings.set_level(args.timings)

    val_transform = et.ExtCompose([
        et.ExtResize((args.res, args.res * 2)),
        et.ExtToArray(),
        et.ExtNormalize(mean=CityscapesVid.mean, std=CityscapesVid.std),
    ])

    if args.synthetic:
        has_labels = True
        n_warm = max(args.num_clips_warmup, 0) or 4
        n_eval = args.num_clips_eval if args.num_clips_eval > 0 else 4
        dataset_warmup = SyntheticClipDataset(n_warm, args.clip_length,
                                              args.res, args.res * 2,
                                              num_classes)
        dataset_eval = SyntheticClipDataset(n_eval, args.clip_length,
                                            args.res, args.res * 2,
                                            num_classes, seed=10_000)
    elif args.demo_dir:
        has_labels = False
        dataset_warmup = DemoImageDataset(args.demo_dir, val_transform)
        dataset_eval = DemoImageDataset(args.demo_dir, val_transform)
    elif args.cityscapes_dir:
        has_labels = not args.fast and args.mode != "test"
        native_kw = dict(native=True, native_size=(args.res, args.res * 2)) \
            if args.native_io else {}
        dataset_warmup = CityscapesVid(args.cityscapes_dir, split="train",
                                       transform=val_transform,
                                       clip_length=args.clip_length,
                                       has_labels=has_labels, **native_kw)
        dataset_eval = CityscapesVid(args.cityscapes_dir, split=args.mode,
                                     transform=val_transform,
                                     clip_length=args.clip_length,
                                     has_labels=has_labels, **native_kw)
    else:
        raise AttributeError("need --synthetic, --demo-dir or --cityscapes-dir")

    # Model
    dtype = torch.bfloat16 if args.half else torch.float32
    cfg = SwiftNetConfig(backbone=args.model_backbone,
                         num_classes=num_classes)
    if args.model_checkpoint and os.path.isfile(args.model_checkpoint):
        logger.info("=> loading model checkpoint '%s'", args.model_checkpoint)
        params = load_params(args.model_checkpoint, cfg, dtype=dtype,
                             device=device)
    else:
        logger.warning("checkpoint '%s' not found: using random init",
                       args.model_checkpoint)
        params = init_swiftnet(cfg, seed=0, dtype=dtype, device=device)

    apply_fn = make_apply_fn(cfg)
    static = args.block_policy == "static"
    model = None
    stepper_state = {}
    if args.speed_mode and not static:
        from blockcopy_tpu_torch.core.stepper import (FixedCapacityStepper,
                                                      StepperConfig)
        gh, gw = args.res // args.block_size, args.res * 2 // args.block_size
        capacity = max(1, int(round(args.block_target * gh * gw)))
        stepper = FixedCapacityStepper(
            apply_fn, StepperConfig.from_settings(vars(args)),
            (args.batch_size, args.res, args.res * 2, 3), capacity,
            dtype=dtype, device=device)
        stepper_state["stepper"] = stepper
        # the steps as CUDA graphs, captured at their first calls (JAX:
        # jax.jit(..., donate_argnums=(1,)), or the clip-parallel rank's
        # sharded step)
        if mesh:
            stepper_state["state"] = clip_parallel.init_parallel_state(
                stepper, params, 1, group.rank)
            stepper_state["first"], stepper_state["step"] = \
                clip_parallel.build_parallel_steps(stepper, group)
            logger.info("clip-parallel: rank %d of %d on %s", group.rank,
                        group.size, device)
        else:
            graphs = StepperGraphs(stepper)
            stepper_state["state"] = stepper.init_state(params, seed=1)
            stepper_state["first"] = graphs.first_step
            stepper_state["step"] = graphs.step
        logger.info("speed mode: capacity %d/%d blocks, %.2f GMACs/frame",
                    stepper.capacity, stepper.total,
                    stepper.macs_per_step(params) / 1e9)
    elif not static:
        model = BlockCopyModel(apply_fn, params, vars(args), device=device)

    dense = DenseGraphs(cfg, device)
    dense_fwd, upsample = dense.dense_fwd, dense.upsample

    output_dir = None
    if args.output_dir:
        if args.fast:
            raise ValueError("Cannot combine --fast with --output-dir")
        output_dir = os.path.join("output_demo", args.output_dir)
        os.makedirs(output_dir, exist_ok=True)

    staged_clip = {}

    def process_clip(clip, meta, phase):
        """clip: list over time of (B, H, W, 3) numpy frames."""
        if model is not None:
            model.reset_temporal()
        if stepper_state:
            stepper_state["state"] = stepper_state["stepper"].reset_temporal(
                stepper_state["state"])
        preds = None
        for frame_id, frame in enumerate(clip):
            if args.single_clip_loop and frame_id in staged_clip:
                # device-staged frames: measure model FPS, not host
                # conversion
                inputs = staged_clip[frame_id]
                arr = None
            else:
                arr = np.asarray(frame, np.float32)
                # cast on the host so the upload is half-width
                inputs = torch.from_numpy(arr).to(dtype).to(device)
                if args.single_clip_loop:
                    staged_clip[frame_id] = inputs
            timings.add_count(inputs.shape[0])
            with timings.env("process_clip/model", 2):
                if stepper_state:
                    fn = stepper_state["first"] if frame_id == 0 \
                        else stepper_state["step"]
                    stepper_state["state"] = fn(params,
                                                stepper_state["state"],
                                                inputs)
                    out = stepper_state["stepper"].fetch_outputs(
                        stepper_state["state"])
                elif model is not None:
                    out = model(inputs)
                else:
                    out = dense_fwd(params, inputs)
                if frame_id == len(clip) - 1 or output_dir:
                    preds = upsample(out, tuple(inputs.shape[1:3])).clone()
            if output_dir and phase != "warmup":
                if arr is None:
                    arr = inputs.float().cpu().numpy()
                _dump_viz(output_dir, phase, meta, frame_id, arr, preds,
                          model)
        return preds

    def process_dataset(dataset, phase, max_num_clips):
        metrics = StreamSegMetrics(
            num_classes, classes=CityscapesVid.fine_classes,
            class_names=CityscapesVid.train_id_to_name)
        timings.reset()
        if mesh:
            # clip d of each group of D clips to rank d; a partial final
            # group is dropped, as the batch collate drops one
            count = len(dataset) if max_num_clips < 0 \
                else min(len(dataset), max_num_clips)
            if count % group.size and group.rank == 0:
                logger.warning(
                    "dropping %d tail clip(s) not filling a group of %d; "
                    "use a clip count divisible by the group size to "
                    "evaluate them", count % group.size, group.size)
            dataset = clip_parallel.ClipSubset(dataset, clip_parallel.
                                               rank_clips(count, group.rank,
                                                          group.size)[0])
            max_num_clips = -1
        loader = PrefetchLoader(dataset, num_workers=args.workers,
                                max_items=max_num_clips
                                if max_num_clips >= 0 else -1)
        logger.info("## phase %s: %d clips", phase, len(loader))
        if mesh:
            group.barrier()
        start = time.perf_counter()
        num_images = 0
        cached = None
        preds = None

        def batched(it, bsize):
            """Group consecutive clips into time-major batches (the torch
            DataLoader's collate, reference ``test_swiftnet.py:70-80``)."""
            group = []
            for item in it:
                group.append(item)
                if len(group) == bsize:
                    yield _collate(group)
                    group = []
            if group and bsize == 1:
                yield _collate(group)
            elif group:
                # partial batches are dropped: temporal state is
                # shape-static per batch size (the reference's drop_last)
                logger.warning(
                    "dropping %d tail clip(s) not filling a group of %d; "
                    "use a clip count divisible by the group size to "
                    "evaluate them", len(group), bsize)

        def _collate(group):
            clips = [g[0] for g in group]
            t_len = len(clips[0])
            clip_b = [np.stack([np.asarray(c[t], np.float32) for c in clips])
                      for t in range(t_len)]
            targets = [g[1] for g in group]
            target_b = (np.stack(targets)
                        if not any(isinstance(t, int) for t in targets)
                        else 0)
            return clip_b, target_b, group[0][2]

        for clip, target, meta in batched(iter(loader), args.batch_size):
            if args.single_clip_loop:
                if cached is None:
                    cached = (clip, target, meta)
                clip, target, meta = cached
            num_images += len(clip) * clip[0].shape[0]
            if mesh and len(set(group.gather_objects(len(clip)))) > 1:
                raise ValueError("clip-parallel groups step frame-"
                                 "synchronous and need equal clip lengths")
            with timings.env("process_dataset/process_clip", 1):
                preds = process_clip(clip, meta, phase)
            if has_labels and not args.fast and not isinstance(target, int):
                metrics.update(np.asarray(target), preds.cpu().numpy())
        # fence with a device-to-host read
        if preds is not None:
            float(preds.sum())
        if mesh:
            group.barrier()     # every rank has finished
        stop = time.perf_counter()
        if phase != "eval":
            logger.info("Number of images: %d", num_images)
            return None
        running_cost = float(
            stepper_state["state"]["policy"]["running_cost"].mean()) \
            if stepper_state else None
        if mesh:
            # the sums onto every rank; the running cost's mean over the
            # ranks (JAX: over the mesh's devices)
            num_images = int(group.sum_array(num_images))
            metrics.confusion_matrix = group.sum_array(
                metrics.confusion_matrix)
            running_cost = float(group.sum_array(running_cost)) / group.size
            if group.rank != 0:
                return None

        logger.info("Number of images: %d", num_images)
        fps = num_images / (stop - start)
        results = {"fps": fps}
        if has_labels and not args.fast:
            metric_results = metrics.get_results()
            logger.info("Mean IoU %.2f", metric_results["Mean IoU"] * 100)
            results.update({k: v for k, v in metric_results.items()
                            if k != "Class IoU"})
        logger.info("Average FPS: %.2f", fps)
        if model is not None:
            breakdown = model.flops.average_macs_by_module()
            logger.info("%s", format_gmacs_breakdown(breakdown))
            results["gmacs_per_image"] = model.flops.average_gmacs()
            results["gmacs_breakdown"] = {k: v / 1e9
                                          for k, v in breakdown.items()}
            logger.info("%s", model.policy.stats)
            results["perc_exec"] = model.policy.stats.get_exec_percentage()
        elif stepper_state:
            st = stepper_state["stepper"]
            breakdown = st.macs_breakdown_per_step(params)
            logger.info("%s", format_gmacs_breakdown(breakdown))
            results["gmacs_per_image"] = sum(breakdown.values()) / 1e9
            results["gmacs_breakdown"] = {k: v / 1e9
                                          for k, v in breakdown.items()}
            results["perc_exec"] = st.capacity / st.total
            results["running_cost"] = running_cost
        else:
            # the static baseline's cost: exact dense MACs from a shape
            # pass of the same model code on the meta device
            dense_ctx = ExecCtx.dense()
            meta = torch.device("meta")
            with torch.no_grad():
                swiftnet_apply(tree_map(lambda t: t.to(meta), params),
                               torch.empty((1, args.res, args.res * 2, 3),
                                           dtype=dtype, device=meta),
                               dense_ctx, cfg)
            breakdown = dense_ctx.macs_by_module()
            logger.info("%s", format_gmacs_breakdown(breakdown))
            results["gmacs_per_image"] = sum(breakdown.values()) / 1e9
            results["gmacs_breakdown"] = {k: v / 1e9
                                          for k, v in breakdown.items()}
        if args.timings:
            logger.info("%s", timings)
        return results

    def check_policy_health(phase):
        """Phase-boundary NaN guard for the stepper (the ladder engine
        guards each update under --block-policy-verbose instead)."""
        if stepper_state:
            stepper_state["stepper"].check_policy_finite(
                stepper_state["state"]["policy"], phase)

    if args.policy_checkpoint and os.path.exists(args.policy_checkpoint):
        logger.info("loading policy state from %s", args.policy_checkpoint)
        if model is not None:
            model.load_policy(args.policy_checkpoint)
        elif stepper_state:
            from blockcopy_tpu_torch.utils.policy_ckpt import (
                load_stepper_policy)
            state = stepper_state["state"]
            stepper_state["state"] = {**state, "policy": load_stepper_policy(
                args.policy_checkpoint, state["policy"],
                rank=group.rank if mesh else 0)}
    process_dataset(dataset_warmup, "warmup", args.num_clips_warmup)
    check_policy_health("warmup")
    if args.policy_checkpoint:
        if model is not None:
            model.save_policy(args.policy_checkpoint)
        elif stepper_state:
            from blockcopy_tpu_torch.utils.policy_ckpt import (
                save_stepper_policy)
            save_stepper_policy(args.policy_checkpoint,
                                stepper_state["state"]["policy"],
                                devices=group.size if mesh else 0,
                                rank=group.rank if mesh else 0)
        logger.info("saved policy state to %s", args.policy_checkpoint)
    if model is not None:
        model.flops.reset_frames()
        model.policy.stats = type(model.policy.stats)()
    results = process_dataset(dataset_eval, "eval", args.num_clips_eval)
    check_policy_health("eval")
    return results


class DenseGraphs:
    """The CLI's dense forward (``--block-policy static``) and its upsample
    to the input's size as CUDA graphs (``core/graphs.py`` ``CallGraphs``;
    JAX's ``jax.jit`` of both, ``upsample``'s ``hw`` static): one graph per
    input shape, and one per input shape and ``hw``.  Each returns its
    graph's buffer, which the next call overwrites: a caller clones what it
    keeps.  On the CPU they run eagerly."""

    def __init__(self, cfg: SwiftNetConfig, device):
        self.cfg = cfg
        self.calls = CallGraphs(device)

    def dense_fwd(self, params, x):
        return self.calls(("dense_fwd",), self._dense, params, x)

    def _dense(self, params, x):
        with torch.no_grad():
            return swiftnet_apply(params, x, ExecCtx.dense(), self.cfg)

    def upsample(self, out, hw):
        return self.calls(("upsample", hw), functools.partial(_upsample, hw),
                          (), out)


def _upsample(hw, _held, out):
    """The logits resized to ``hw``, their argmax: the upsample graph's
    body."""
    with torch.no_grad():
        return resize_bilinear(out.float(), hw).argmax(dim=-1)


def _dump_viz(output_dir, phase, meta, frame_id, arr, preds, model):
    """Input, prediction and execution-grid overlays (reference
    ``test_swiftnet.py:200-230``), written with PIL."""
    from PIL import Image

    phase_dir = osp.join(output_dir, phase)
    os.makedirs(phase_dir, exist_ok=True)
    relpath = meta["relpath"]
    fname = ".".join(relpath.replace("/", "-").split(".")[:-1]) \
        + f"_{frame_id}"

    img = et.denormalize(arr[0], CityscapesVid.mean, CityscapesVid.std)
    img = np.clip(img, 0, 1)
    Image.fromarray((img * 255).astype(np.uint8)).resize((1024, 512)).save(
        osp.join(phase_dir, f"{fname}_input.jpg"))
    pred_color = CityscapesVid.decode_target(
        preds[0].cpu().numpy()).astype(np.uint8)
    Image.fromarray(pred_color).resize((1024, 512), Image.NEAREST).save(
        osp.join(phase_dir, f"{fname}_output.jpg"))
    if model is not None and "grid" in model.policy_meta:
        grid = model.policy_meta["grid"][0].float().cpu().numpy()
        overlay = img.copy()
        gh, gw = grid.shape
        bh, bw = img.shape[0] // gh, img.shape[1] // gw
        for gy in range(gh):
            for gx in range(gw):
                c = np.array([0.2, 0.8, 0.2]) if grid[gy, gx] else \
                    np.array([0.5, 0.2, 0.7])
                sl = np.s_[gy * bh:(gy + 1) * bh, gx * bw:(gx + 1) * bw]
                overlay[sl] = 0.6 * overlay[sl] + 0.4 * c
        Image.fromarray((np.clip(overlay, 0, 1) * 255).astype(np.uint8)) \
            .resize((1024, 512)).save(osp.join(phase_dir, f"{fname}_grid.jpg"))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
