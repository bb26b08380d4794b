"""CSP + BlockCopy detection evaluation CLI (counterpart of
``blockcopy_tpu/tasks/detection/eval.py``, reference
``Pedestron/tools/test_city_person.py``), flag for flag, plus ``--device``.

Builds warmup (train-split) and eval sets of CityPersons clips, runs the
per-clip BlockCopy loop (``reset_temporal`` per clip, ``simple_test`` per
frame), dumps COCO-format detections and reports the four CityPersons miss
rates, FPS and average GMACs; the last stdout line is one JSON object.  The
engine is the ladder ``CSPBlockCopy``; ``--speed-mode`` runs the
``DetectionStepper`` instead.  Configs are the mmdet-style python files of
``configs/csp/`` (``utils/registry.py``); ``--synthetic`` runs on generated
clips.

Clip-parallel (``--speed-mode`` only): ``--num-devices D`` spawns D ranks
(rank r on ``cuda:r``; with ``--device cpu`` D CPU ranks on gloo), or a
launcher such as ``torchrun`` starts them (``WORLD_SIZE``).  Each rank steps
clip d of every group of D clips, frame-synchronous, the policy's gradients
averaged over the ranks; a partial final group is padded by repeating its
last clip and the padded results are thrown away.  The detections reach
rank 0, which runs the MR evaluator.

    python -m blockcopy_tpu_torch.tasks.detection.eval --synthetic --half \\
        --config configs/csp/csp_r50_clip_blockcopy_030.py      # on the card
    python -m blockcopy_tpu_torch.tasks.detection.eval --synthetic --res 256 \\
        --clip-length 2 --num-clips-warmup 1 --num-clips-eval 1 \\
        --device cpu                                # on the CPU, when asked
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from blockcopy_tpu_torch.core.argparser import add_argparser_arguments
from blockcopy_tpu_torch.data.loader import PrefetchLoader
from blockcopy_tpu_torch.device import to_device
from blockcopy_tpu_torch.models.builder import build_detector, load_csp_params
from blockcopy_tpu_torch.models.csp import (CSPBlockCopy, CSPConfig,
                                            dets_to_bbox_results, init_csp,
                                            soft_nms_rescore)
from blockcopy_tpu_torch.parallel import clip_parallel
from blockcopy_tpu_torch.parallel.distributed import detect_env
from blockcopy_tpu_torch.tasks.detection.dataset import CityPersonsClipDataset
from blockcopy_tpu_torch.tasks.detection.eval_mr import (
    SETUP_LABELS,
    CityPersonsMREvaluator,
    bbox_results_to_coco,
)
from blockcopy_tpu_torch.utils.flops import format_gmacs_breakdown
from blockcopy_tpu_torch.utils import profiler
from blockcopy_tpu_torch.utils.profiler import timings
from blockcopy_tpu_torch.utils.registry import load_config

logger = logging.getLogger("blockcopy_tpu_torch.detection")


class SyntheticDetClipDataset:
    """Generated clips with moving bright blobs and matching COCO GT, for
    data-free runs."""

    def __init__(self, num_clips, clip_length, height, width, seed=0):
        self.num_clips = num_clips
        self.clip_length = clip_length
        self.h, self.w = height, width
        self.seed = seed

    def __len__(self):
        return self.num_clips

    def coco_gt(self):
        images, anns = [], []
        aid = 1
        for i in range(self.num_clips):
            images.append({"id": i + 1,
                           "file_name": f"synthetic_{i:06d}_leftImg8bit.png",
                           "width": self.w, "height": self.h})
            for x, y, w, h in self._boxes(i, self.clip_length - 1):
                anns.append({
                    "id": aid, "image_id": i + 1, "category_id": 1,
                    "bbox": [x, y, w, h], "height": h, "vis_ratio": 1.0,
                    "ignore": 0, "iscrowd": 0, "area": w * h,
                })
                aid += 1
        return {"images": images, "annotations": anns,
                "categories": [{"id": 1, "name": "pedestrian"}]}

    def _boxes(self, index, t):
        rs = np.random.RandomState(self.seed + index)
        boxes = []
        for _ in range(rs.randint(1, 4)):
            x = int(rs.randint(0, self.w - 80)) + 3 * t
            y = int(rs.randint(0, self.h - 160))
            boxes.append((min(x, self.w - 40), y, 33, 80))
        return boxes

    def __getitem__(self, index):
        rs = np.random.RandomState(self.seed + index)
        base = rs.randn(self.h, self.w, 3).astype(np.float32) * 0.3
        clip = []
        for t in range(self.clip_length):
            f = base.copy()
            for x, y, w, h in self._boxes(index, t):
                f[y:y + h, x:x + w] += 2.5
            clip.append(f)
        meta = {"image_id": index + 1,
                "file_name": f"synthetic_{index:06d}_leftImg8bit.png",
                "img_shape": (self.h, self.w), "scale_factor": 1.0,
                "is_clip": True}
        return clip, [], meta


def build_argparser():
    p = argparse.ArgumentParser(description="BlockCopy CSP test "
                                "(PyTorch/CUDA)")
    p.add_argument("--config", type=str, default="",
                   help="mmdet-style python config file")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--ann-file", type=str, default="")
    p.add_argument("--img-prefix", type=str, default="")
    p.add_argument("--ann-file-warmup", type=str, default="")
    p.add_argument("--img-prefix-warmup", type=str, default="")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--res", type=int, default=1024)
    p.add_argument("--clip-length", type=int, default=20)
    p.add_argument("--num-clips-warmup", type=int, default=300)
    p.add_argument("--num-clips-eval", type=int, default=-1)
    p.add_argument("--workers", type=int, default=6)
    p.add_argument("--half", action="store_true",
                   help="bfloat16 model (the policy stays float32)")
    p.add_argument("--out", type=str, default="",
                   help="json file for detection dump")
    p.add_argument("--output-dir", type=str, default="",
                   help="write detection/grid visualization overlays")
    p.add_argument("--timings", type=int, default=0,
                   help="tracing level (utils/profiler.py), printed after "
                   "the eval phase: 0 off; 2 the steps' bc.* spans "
                   "(bc.step, bc.graph.check, bc.graph.inputs, "
                   "bc.graph.launch, bc.upload) and the counters (replays, "
                   "input copies, captures, kernel builds); 3 also the "
                   "ladder engine's phase spans and the device marks "
                   "captured into the stepper's graphs (device time a span "
                   "a kind of frame: policy, blocks, outputs, reinforce, "
                   "writeback).  Spans are host time: nothing waits for "
                   "the card")
    p.add_argument("--policy-checkpoint", type=str, default="",
                   help="load the online policy state from this path if it "
                   "exists, save it after warmup: an .npz holds one "
                   "replica; in clip-parallel runs any other path is a "
                   "directory of one file per rank")
    p.add_argument("--checkpoint-start", type=int, default=-1,
                   help="with --checkpoint-end: evaluate the epoch range "
                   "[start, end) of a training run, treating --checkpoint "
                   "as the run directory of epoch_N[_teacher].npz files "
                   "and polling until each appears")
    p.add_argument("--checkpoint-end", type=int, default=-1)
    p.add_argument("--mean-teacher", action="store_true",
                   help="epoch-range mode evaluates the EMA-teacher "
                   "checkpoints (reference .pth.stu role)")
    p.add_argument("--poll-seconds", type=float, default=5.0,
                   help="epoch-range mode: wait granularity")
    p.add_argument("--speed-mode", action="store_true",
                   help="fixed-capacity detection stepper: policy, blocked "
                   "CSP, decode, NMS and the IoU gain on the device, no "
                   "steady-state host sync")
    p.add_argument("--num-devices", type=int, default=1,
                   help="clip-parallel over N devices (speed mode only): "
                   "each rank steps one clip on its device, the policy "
                   "gradients are averaged over the ranks")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    add_argparser_arguments(p)
    p.set_defaults(block_policy="rl_objectdetection", block_num_classes=1,
                   block_target=0.3, block_optim_wd=0.0001)
    return p


class _StepperDetector:
    """``DetectionStepper`` behind the ladder engine's interface
    (``reset_temporal`` / ``simple_test``), so the eval loop is shared."""

    def __init__(self, params, csp_cfg, settings, frame_shape, dtype,
                 device, group=None):
        from blockcopy_tpu_torch.core.stepper import StepperConfig
        from blockcopy_tpu_torch.tasks.detection.stepper import \
            DetectionStepper

        scfg = StepperConfig.from_settings(settings)
        gh = frame_shape[1] // scfg.block_size
        gw = frame_shape[2] // scfg.block_size
        capacity = max(1, int(round(settings["block_target"] * gh * gw)))
        self.params = params
        self.csp_cfg = csp_cfg
        self.stepper = DetectionStepper(csp_cfg, scfg, frame_shape, capacity,
                                        dtype=dtype, device=device)
        self.group = group
        # the steps as CUDA graphs, captured at their first calls (JAX:
        # jax.jit(..., donate_argnums=(1,)), or the clip-parallel rank's
        # sharded step)
        if group is None:
            from blockcopy_tpu_torch.core.graphs import StepperGraphs
            self.graphs = StepperGraphs(self.stepper)
            self.state = self.stepper.init_state(params, seed=1)
            self._first, self._step = self.graphs.first_step, \
                self.graphs.step
        else:
            self.state = clip_parallel.init_parallel_state(
                self.stepper, params, 1, group.rank)
            self._first, self._step = clip_parallel.build_parallel_steps(
                self.stepper, group)
        self._frame_id = 0

    def reset_temporal(self):
        self.state = self.stepper.reset_temporal(self.state)
        self._frame_id = 0

    def simple_test(self, img, img_shape=None):
        self.step_only(img)
        return self.current_results()

    def step_only(self, img):
        """Step without reading the detections back: only a clip's last,
        annotated frame is evaluated (as the reference), so a steady frame
        makes no host sync."""
        fn = self._first if self._frame_id == 0 else self._step
        self.state = fn(self.params, self.state, img)
        self._frame_id += 1

    def current_results(self):
        """The last frame's per-class box arrays (one transfer); soft-NMS
        rescoring, where configured, on the host as the ladder engine."""
        dets, labels, valid = self.stepper.fetch_outputs(self.state)
        if self.csp_cfg.nms_type == "soft_nms":
            dets, labels, valid = soft_nms_rescore(dets, labels, valid,
                                                   self.csp_cfg)
        return dets_to_bbox_results(dets, labels, valid,
                                    self.csp_cfg.num_classes)[0]

    @property
    def policy_meta(self):
        # the overlays read the grid: the last stepped frame's
        return {"grid": self.state["prev_grid"] > 0}

    # policy persistence, as the semseg CLI's (utils/policy_ckpt.py)
    def load_policy(self, path):
        from blockcopy_tpu_torch.utils.policy_ckpt import load_stepper_policy
        self.state = {**self.state, "policy": load_stepper_policy(
            path, self.state["policy"], rank=self._rank()[1])}

    def save_policy(self, path):
        from blockcopy_tpu_torch.utils.policy_ckpt import save_stepper_policy
        devices, rank = self._rank()
        save_stepper_policy(path, self.state["policy"], devices=devices,
                            rank=rank)

    def _rank(self):
        """(ranks, this rank) of a clip-parallel run; (0, 0) alone."""
        return (0, 0) if self.group is None else (self.group.size,
                                                  self.group.rank)


def _explicitly_passed(argv) -> set:
    """Keys the user typed on the command line: the same argv re-parsed
    with every default ``argparse.SUPPRESS``, so only given flags land in
    the namespace."""
    p = build_argparser()
    for a in p._actions:
        a.default = argparse.SUPPRESS
    p._defaults.clear()
    return set(vars(p.parse_args(argv)).keys())


def _wait_for_epoch(run_dir, epoch, end, suffix, poll_s):
    """Block until ``epoch_<i><suffix>.npz`` exists and, unless it is the
    range's last epoch, the next epoch's file too (the writer has moved
    on, so the file is complete).  Reference
    ``Pedestron/tools/test_city_person.py:276-284``."""
    path = os.path.join(run_dir, f"epoch_{epoch}{suffix}.npz")
    while not os.path.exists(path):
        logger.info("path not existing %s", path)
        time.sleep(poll_s)
    nxt = os.path.join(run_dir, f"epoch_{epoch + 1}{suffix}.npz")
    while epoch + 1 != end and not os.path.exists(nxt):
        logger.info("path not existing %s", nxt)
        time.sleep(poll_s)
    return path


def _run_epoch_range(args, argv):
    """Evaluate every epoch checkpoint of a (possibly still running)
    training run, polling for each file as the reference script does."""
    argv = list(sys.argv[1:] if argv is None else argv)
    # drop the range, teacher and poll flags and the --checkpoint and --out
    # values from the per-epoch argv ("--flag value" or "--flag=value")
    drop_with_value = {"--checkpoint", "--checkpoint-start",
                       "--checkpoint-end", "--poll-seconds", "--out"}
    cleaned, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok in drop_with_value:
            skip = True
            continue
        if tok.split("=", 1)[0] in drop_with_value or tok == "--mean-teacher":
            continue
        cleaned.append(tok)
    suffix = "_teacher" if args.mean_teacher else ""
    summaries = []
    for epoch in range(args.checkpoint_start, args.checkpoint_end):
        path = _wait_for_epoch(args.checkpoint, epoch, args.checkpoint_end,
                               suffix, args.poll_seconds)
        ep_argv = cleaned + ["--checkpoint", path]
        if args.out:
            root, ext = os.path.splitext(args.out)
            ep_argv += ["--out", f"{root}_epoch{epoch}{ext or '.json'}"]
        logger.info("## epoch %d: evaluating %s", epoch, path)
        summaries.append({"epoch": epoch, "result": main(ep_argv)})
    return summaries


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logger.info("Arguments: %s", args)
    if args.checkpoint_start >= 0 or args.checkpoint_end >= 0:
        if not 0 <= args.checkpoint_start < args.checkpoint_end:
            raise ValueError("--checkpoint-start/--checkpoint-end must form "
                             "a valid range")
        if not args.checkpoint or os.path.isfile(args.checkpoint):
            raise ValueError("epoch-range mode: --checkpoint is the "
                             "training run's directory")
        return _run_epoch_range(args, argv)
    if args.num_devices > 1 or detect_env() is not None:
        if not args.speed_mode:
            raise ValueError("clip-parallel runs need --speed-mode (the "
                             "fixed-capacity stepper)")
        if args.output_dir:
            raise ValueError("clip-parallel runs write no overlays: drop "
                             "--output-dir")
    argv = sys.argv[1:] if argv is None else list(argv)
    results = clip_parallel.launch(args.num_devices, args.device, _run,
                                   argv)
    if results is not None:
        print(json.dumps(results))
    return results


def _run(argv, device, group):
    """The CLI's work on ``device``; ``group`` (a
    ``parallel.distributed.Group``, or None for one process) makes it rank
    ``group.rank`` of a clip-parallel run.  Returns the results on rank 0,
    None on the others."""
    args = build_argparser().parse_args(argv)
    mesh = group is not None
    timings.set_level(args.timings)
    dtype = torch.bfloat16 if args.half else torch.float32

    settings = dict(vars(args))
    ckpt = args.checkpoint if args.checkpoint and \
        os.path.isfile(args.checkpoint) else None
    if args.checkpoint and not ckpt:
        logger.warning("checkpoint '%s' not found: random init",
                       args.checkpoint)
    if args.config:
        # precedence: explicit CLI --block-* flags > the config's
        # blockcopy_settings > CLI defaults; a flag typed at its default
        # value still counts as explicit
        explicit = _explicitly_passed(argv)
        overrides = {k: settings[k] for k in explicit
                     if k.startswith("block_")}
        model = build_detector(load_config(args.config), checkpoint=ckpt,
                               dtype=dtype, settings_override=overrides,
                               device=device)
        settings = model.settings
    else:
        cfg = CSPConfig()
        if ckpt:
            params = load_csp_params(ckpt, cfg, dtype, device)
            logger.info("loaded checkpoint %s", ckpt)
        else:
            params = init_csp(cfg, seed=0, dtype=dtype, device=device)
        model = CSPBlockCopy(params, cfg, settings, device=device)

    if args.speed_mode:
        if settings["block_policy"] != "rl_objectdetection":
            raise ValueError("--speed-mode runs the REINFORCE stepper: "
                             "--block-policy rl_objectdetection")
        model = _StepperDetector(model.params, model.cfg, settings,
                                 (1, args.res, args.res * 2, 3), dtype,
                                 device, group)

    if args.synthetic:
        n_warm = max(args.num_clips_warmup, 0) or 2
        n_eval = args.num_clips_eval if args.num_clips_eval > 0 else 2
        ds_warm = SyntheticDetClipDataset(n_warm, args.clip_length, args.res,
                                          args.res * 2)
        ds_eval = SyntheticDetClipDataset(n_eval, args.clip_length, args.res,
                                          args.res * 2, seed=10_000)
        evaluator = CityPersonsMREvaluator(ds_eval.coco_gt())
    else:
        if not (args.ann_file and args.img_prefix):
            raise ValueError("need --ann-file and --img-prefix, or "
                             "--synthetic")
        scale = (args.res * 2, args.res)  # the dataset takes (w, h)
        ds_eval = CityPersonsClipDataset(args.ann_file, args.img_prefix,
                                         img_scale=scale,
                                         clip_length=args.clip_length)
        ds_warm = CityPersonsClipDataset(
            args.ann_file_warmup or args.ann_file,
            args.img_prefix_warmup or args.img_prefix, img_scale=scale,
            clip_length=args.clip_length)
        evaluator = CityPersonsMREvaluator(args.ann_file)

    def upload(frame):
        # cast on the host so the upload is half-width in bf16
        return to_device(torch.from_numpy(
            np.asarray(frame, np.float32)[None]).to(dtype), device)

    def run_phase_mesh(ds, phase, max_clips):
        """Clip d of each group of D clips on rank d, frame-synchronous; a
        partial final group is padded by repeating its last clip, whose
        results are thrown away, so the MR is exact for any clip count.
        The detections and image counts are gathered on every rank."""
        count = len(ds) if max_clips < 0 else min(len(ds), max_clips)
        indices, real = clip_parallel.rank_clips(count, group.rank,
                                                 group.size, pad=True)
        loader = PrefetchLoader(clip_parallel.ClipSubset(ds, indices),
                                num_workers=args.workers)
        logger.info("## phase %s: %d clips over %d ranks", phase, count,
                    group.size)
        detections = []
        num_images = 0
        group.barrier()
        start = time.perf_counter()
        for (clip, _, meta), is_real in zip(iter(loader), real):
            if len(set(group.gather_objects(len(clip)))) > 1:
                raise ValueError("clip-parallel groups step frame-"
                                 "synchronous and need equal clip lengths")
            model.reset_temporal()
            for frame in clip:
                model.step_only(upload(frame))
                num_images += int(is_real)
            if phase == "eval":
                bbox_results = model.current_results()
                if is_real:
                    detections.extend(bbox_results_to_coco(
                        bbox_results, meta["image_id"]))
        if phase != "eval":
            model.current_results()     # fence with a device-to-host read
        group.barrier()
        elapsed = time.perf_counter() - start
        num_images = int(group.sum_array(num_images))
        detections = [d for part in group.gather_objects(detections)
                      for d in part]
        return detections, num_images, elapsed

    def run_phase(ds, phase, max_clips):
        profiler.reset()        # --timings reports the last phase
        if mesh:
            return run_phase_mesh(ds, phase, max_clips)
        loader = PrefetchLoader(ds, num_workers=args.workers,
                                max_items=max_clips if max_clips >= 0 else -1)
        logger.info("## phase %s: %d clips", phase, len(loader))
        detections = []
        num_images = 0
        start = time.perf_counter()
        for clip, _, meta in iter(loader):
            model.reset_temporal()
            viz = args.output_dir and phase == "eval"
            # the stepper reads its boxes back only at a clip's end (the
            # clip's last frame is the annotated one), unless overlays
            # need every frame's
            lazy = isinstance(model, _StepperDetector) and not viz
            for frame_id, frame in enumerate(clip):
                img = upload(frame)
                num_images += 1
                if lazy:
                    model.step_only(img)
                else:
                    bbox_results = model.simple_test(
                        img, img_shape=meta["img_shape"])
                if viz:
                    _dump_viz(args, phase, meta, frame_id,
                              np.asarray(frame, np.float32), bbox_results,
                              model)
            if lazy:
                bbox_results = model.current_results()
            if phase == "eval":
                # the whole per-class list: every class is evaluated
                detections.extend(bbox_results_to_coco(bbox_results,
                                                       meta["image_id"]))
        return detections, num_images, time.perf_counter() - start

    def check_policy_health(phase):
        """Phase-boundary NaN guard for the stepper (the ladder engine
        guards each frame under --block-policy-verbose instead)."""
        if args.speed_mode:
            model.stepper.check_policy_finite(model.state["policy"], phase)

    if args.policy_checkpoint and os.path.exists(args.policy_checkpoint):
        logger.info("loading policy state from %s", args.policy_checkpoint)
        model.load_policy(args.policy_checkpoint)
    run_phase(ds_warm, "warmup", args.num_clips_warmup)
    check_policy_health("warmup")
    if args.policy_checkpoint:
        model.save_policy(args.policy_checkpoint)
        logger.info("saved policy state to %s", args.policy_checkpoint)
    if not args.speed_mode:
        model.flops.reset_frames()
    dets, num_images, elapsed = run_phase(ds_eval, "eval",
                                          args.num_clips_eval)
    check_policy_health("eval")
    if mesh and group.rank != 0:
        return None

    if args.out:
        with open(args.out, "w") as f:
            json.dump(dets, f)
        logger.info("wrote %d detections to %s", len(dets), args.out)

    mrs = evaluator.evaluate(dets)
    results = {f"MR_{k}": v for k, v in mrs.items()}
    results["fps"] = num_images / elapsed
    if args.speed_mode:
        breakdown = model.stepper.macs_breakdown_per_step(model.params)
        results["gmacs_per_image"] = sum(breakdown.values()) / 1e9
        results["perc_exec"] = model.stepper.capacity / model.stepper.total
    else:
        breakdown = model.flops.average_macs_by_module()
        results["gmacs_per_image"] = model.flops.average_gmacs()
        results["perc_exec"] = model.policy.stats.get_exec_percentage()
    results["gmacs_breakdown"] = {k: v / 1e9 for k, v in breakdown.items()}
    # the effective target, after the config and CLI merge
    results["block_target"] = float(settings["block_target"])
    for k in SETUP_LABELS:
        logger.info("Average Miss Rate (MR) %-22s = %.2f%%", k, mrs[k])
    logger.info("%s", format_gmacs_breakdown(breakdown))
    if args.timings:
        logger.info("%s", profiler.text())
    return results


def _dump_viz(args, phase, meta, frame_id, frame, bbox_results, model):
    """Detections and execution-grid overlays (reference
    ``test_city_person.py:64-117``), written with PIL."""
    from PIL import Image, ImageDraw

    from blockcopy_tpu_torch.tasks.detection.dataset import IMG_MEAN, IMG_STD

    out_dir = os.path.join(args.output_dir, phase)
    os.makedirs(out_dir, exist_ok=True)
    img = np.clip(frame * IMG_STD + IMG_MEAN, 0, 255).astype(np.uint8)
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    for arr in bbox_results:
        for x1, y1, x2, y2, score in np.asarray(arr):
            if score < 0.3:
                continue
            draw.rectangle([x1, y1, x2, y2], outline=(255, 40, 40), width=3)
            draw.text((x1 + 2, y1 + 2), f"{score:.2f}", fill=(255, 240, 0))
    if "grid" in model.policy_meta:
        grid = model.policy_meta["grid"][0].cpu().numpy()
        bh, bw = img.shape[0] // grid.shape[0], img.shape[1] // grid.shape[1]
        overlay = np.asarray(pil).astype(np.float32)
        tint = np.where(
            np.kron(grid, np.ones((bh, bw)))[..., None] > 0,
            np.array([40.0, 160.0, 40.0]), np.array([100.0, 40.0, 140.0]))
        overlay = 0.75 * overlay + 0.25 * tint
        pil = Image.fromarray(np.clip(overlay, 0, 255).astype(np.uint8))
    name = meta["file_name"].replace("/", "-").rsplit(".", 1)[0]
    pil.resize((1024, 512)).save(
        os.path.join(out_dir, f"{name}_{frame_id}_dets.jpg"))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
