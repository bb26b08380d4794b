"""Detection quality validation (counterpart of the root
``tools/validate_detection.py``): train CSP in-process on synthetic
pedestrian-like clips, then serve the trained detector through the fused
``DetectionStepper`` in bf16 in three closed-loop modes and score each with
the CityPersons miss rate (MR).

* **dense**: every frame through the all-blocks first-frame step (the
  per-frame dense reference);
* **blockcopy**: target 0.3, the online REINFORCE policy warmed up on train
  clips (the headline configuration);
* **frozen**: the first frame dense, its detections then held for the clip
  (the baseline BlockCopy must beat).

Per mode: MR on the last, annotated frame of each eval clip (``eval_mr.py``)
and the per-frame agreement with dense (greedy-IoU F1 at 0.5).  The two
head lowerings that change numbers (``HEAD_BLOCKED_FINAL``,
``HEAD_FUSED_BRANCH_CONV``) are then each re-run off, unless
``--skip-flag-ab``.  Prints the result as JSON; ``--out`` also writes it
there (no file is written by default).

    python3 -m blockcopy_tpu_torch.tools.validate_detection     # on the card
    python3 -m blockcopy_tpu_torch.tools.validate_detection --device cpu \\
        --train-iters 2 --warmup-clips 1 --eval-clips 1 --skip-flag-ab
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from blockcopy_tpu_torch.device import resolve_device, to_device

H, W = 512, 1024
CLIP_LEN = 10
BS = 128


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _iou_matrix(a, b):
    """a (N, 4), b (M, 4) xyxy -> (N, M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ax1, ay1, ax2, ay2 = (a[:, i, None] for i in range(4))
    bx1, by1, bx2, by2 = (b[None, :, i] for i in range(4))
    iw = np.maximum(0, np.minimum(ax2, bx2) - np.maximum(ax1, bx1))
    ih = np.maximum(0, np.minimum(ay2, by2) - np.maximum(ay1, by1))
    inter = iw * ih
    area_a = (ax2 - ax1) * (ay2 - ay1)
    area_b = (bx2 - bx1) * (by2 - by1)
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def f1_vs(dense, test, iou_thr=0.5, score_thr=0.3):
    """Greedy-IoU F1 of ``test`` boxes against ``dense`` boxes (both (N, 5)
    xyxy + score); 1.0 when both are empty."""
    d = dense[dense[:, 4] >= score_thr][:, :4]
    t = test[test[:, 4] >= score_thr][:, :4]
    if len(d) == 0 and len(t) == 0:
        return 1.0
    iou = _iou_matrix(d, t)
    tp = 0
    used = np.zeros(len(t), bool)
    for i in np.argsort(-dense[dense[:, 4] >= score_thr][:, 4]):
        j = -1
        best = iou_thr
        for k in range(len(t)):
            if not used[k] and iou[i, k] >= best:
                best, j = iou[i, k], k
        if j >= 0:
            used[j] = True
            tp += 1
    return 2.0 * tp / max(len(d) + len(t), 1)


def dets_to_coco(arr, image_id):
    out = []
    for x1, y1, x2, y2, s in arr:
        out.append({"image_id": image_id, "category_id": 1,
                    "bbox": [float(x1), float(y1), float(x2 - x1),
                             float(y2 - y1)],
                    "height": float(y2 - y1), "score": float(s)})
    return out


# ---------------------------------------------------------------------------


def train_csp(csp_cfg, iters, seed=7, device=None):
    """Train a CSP offline on the synthetic blob distribution (train clips
    from another seed space than the eval clips), through the train CLI's
    step (a CUDA graph on the card).  Returns the live fp32 params and the
    run's summary; the losses are read once, at the end."""
    from blockcopy_tpu_torch.models.csp import init_csp
    from blockcopy_tpu_torch.tasks.detection import train as T
    from blockcopy_tpu_torch.tasks.detection.eval import \
        SyntheticDetClipDataset

    device = resolve_device(device)
    ds = SyntheticDetClipDataset(64, CLIP_LEN, H, W, seed=10_000)
    params = init_csp(csp_cfg, seed=seed, device=device)
    # The short-run regime of the JAX tool (its measured lr sweep): cls
    # weight 1.0 (at the reference's 0.01 a few hundred iterations stay at
    # the background prior: no detections, a vacuous MR); lr 2e-4 with 50
    # warm-up iterations at 0.1 (lr 1e-3 oscillates at batch 1).
    tcfg = T.TrainConfig(lr=2e-4, warmup_iters=50, warmup_ratio=0.1,
                         iters_per_epoch=max(iters, 1), lr_steps=(),
                         loss_weights=(1.0, 1.0, 0.1))
    state = T.init_train_state(params, tcfg)
    step = T.make_train_step(csp_cfg, tcfg, device)
    rs = np.random.RandomState(seed)
    t0 = time.time()
    totals = []
    for i in range(iters):
        ci = int(rs.randint(0, len(ds)))
        t = int(rs.randint(0, CLIP_LEN))
        clip, _, _ = ds[ci]
        boxes = np.array([(x, y, x + w, y + h)
                          for x, y, w, h in ds._boxes(ci, t)], np.float32)
        maps = tuple(to_device(m[None], device)
                     for m in T.calc_gt_center(boxes, None, (H, W)))
        state, losses = step(state, to_device(clip[t][None], device), maps)
        if i in (0, iters - 1):
            # a copy: the next replay overwrites the graph's loss buffers
            totals.append(losses["loss_total"].clone())
    totals = torch.stack(totals).tolist()      # waits for the last step
    # The live params, not the mean-teacher EMA: at alpha 0.999 the teacher
    # still holds 0.999^iters (55-67% at 400-600 iterations) of the random
    # init; EMA evaluation suits the reference's 160k-iteration schedule.
    return state["params"], {
        "iters": iters, "loss_first": round(totals[0], 4),
        "loss_last": round(totals[-1], 4),
        "train_seconds": round(time.time() - t0, 1)}


def build_stepper(params_bf16, csp_cfg, target, seed=1, device=None):
    from blockcopy_tpu_torch.core.stepper import StepperConfig
    from blockcopy_tpu_torch.tasks.detection.stepper import DetectionStepper

    gh, gw = H // BS, W // BS
    capacity = max(1, int(round(target * gh * gw)))
    scfg = StepperConfig(block_size=BS, block_target=target,
                         train_interval=4, num_classes=1,
                         policy_arch="fast")
    stepper = DetectionStepper(csp_cfg, scfg, (1, H, W, 3), capacity,
                               dtype=torch.bfloat16, device=device)
    return stepper, stepper.init_state(params_bf16, seed=seed)


def fetch(stepper, state):
    """The step's fixed-size dets -> (N, 5) numpy xyxy + score, in one
    transfer (``fetch_dets``)."""
    from blockcopy_tpu_torch.models.csp import fetch_dets

    dets, _, valid = fetch_dets(*stepper.fetch_outputs(state))
    return dets[valid].astype(np.float32)


def _frame(f, device):
    return to_device(f[None], device).to(torch.bfloat16)


def run_blockcopy_mode(params, csp_cfg, ds_warm, ds_eval, dense_per_clip,
                       target, seed=1, device=None):
    """Warm the online policy up on train clips, then evaluate: returns the
    per-frame F1 against dense, the last frames' COCO dets and the mean
    executed share."""
    stepper, state = build_stepper(params, csp_cfg, target, seed, device)
    for ci in range(len(ds_warm)):
        clip, _, _ = ds_warm[ci]
        state = stepper.reset_temporal(state)
        for t, f in enumerate(clip):
            fn = stepper.first_step if t == 0 else stepper.step
            state = fn(params, state, _frame(f, stepper.device))

    f1s, coco, rates = [], [], []
    for ci in range(len(ds_eval)):
        clip, _, meta = ds_eval[ci]
        state = stepper.reset_temporal(state)
        for t, f in enumerate(clip):
            fn = stepper.first_step if t == 0 else stepper.step
            state = fn(params, state, _frame(f, stepper.device))
            if t >= 2:
                f1s.append(f1_vs(dense_per_clip[ci][t],
                                 fetch(stepper, state)))
                rates.append(state["prev_grid"].mean().item())
        coco.extend(dets_to_coco(fetch(stepper, state), meta["image_id"]))
    return f1s, coco, float(np.mean(rates))


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--target", type=float, default=0.3)
    ap.add_argument("--train-iters", type=int, default=400)
    ap.add_argument("--warmup-clips", type=int, default=30)
    ap.add_argument("--eval-clips", type=int, default=8)
    ap.add_argument("--skip-flag-ab", action="store_true")
    ap.add_argument("--out", type=str, default="",
                   help="also write the JSON result to this path")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cpu' runs without a GPU")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from blockcopy_tpu_torch.models import csp as cspmod
    from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
    from blockcopy_tpu_torch.policy.optim import tree_map
    from blockcopy_tpu_torch.tasks.detection.eval import \
        SyntheticDetClipDataset
    from blockcopy_tpu_torch.tasks.detection.eval_mr import \
        CityPersonsMREvaluator

    device = resolve_device(args.device)
    csp_cfg = CSPConfig()
    params_f32, train_info = train_csp(csp_cfg, args.train_iters,
                                       device=device)
    print("trained:", json.dumps(train_info), flush=True)
    # cast per leaf to the shipped bf16 parameter dtypes (GroupNorm and the
    # output scales stay fp32)
    ref = init_csp(csp_cfg, dtype=torch.bfloat16, device="meta")
    params = tree_map(lambda t, r: t.to(r.dtype), params_f32, ref)
    del params_f32

    ds_warm = SyntheticDetClipDataset(args.warmup_clips, CLIP_LEN, H, W,
                                      seed=500)
    ds_eval = SyntheticDetClipDataset(args.eval_clips, CLIP_LEN, H, W,
                                      seed=0)
    evaluator = CityPersonsMREvaluator(ds_eval.coco_gt())

    # dense reference: the all-blocks first-frame step, every frame
    stepper, state = build_stepper(params, csp_cfg, args.target,
                                   device=device)
    dense_per_clip, dense_coco = [], []
    for ci in range(len(ds_eval)):
        clip, _, meta = ds_eval[ci]
        per = []
        state = stepper.reset_temporal(state)
        for f in clip:
            state = stepper.first_step(params, state, _frame(f, device))
            per.append(fetch(stepper, state))
        dense_per_clip.append(per)
        dense_coco.extend(dets_to_coco(per[-1], meta["image_id"]))
    del stepper, state

    results = {"geometry": f"{H}x{W} bs{BS}", "target": args.target,
               "train": train_info, "warmup_clips": args.warmup_clips,
               "eval_clips": args.eval_clips, "clip_len": CLIP_LEN,
               "modes": {}}
    results["modes"]["dense"] = {"mr": evaluator.evaluate(dense_coco),
                                 "agreement_f1_vs_dense": 1.0}

    # frozen baseline: frame 0's detections held for the whole clip
    froz_f1, froz_coco = [], []
    for ci in range(len(ds_eval)):
        _, _, meta = ds_eval[ci]
        for t in range(2, CLIP_LEN):
            froz_f1.append(f1_vs(dense_per_clip[ci][t],
                                 dense_per_clip[ci][0]))
        froz_coco.extend(dets_to_coco(dense_per_clip[ci][0],
                                      meta["image_id"]))
    results["modes"]["frozen"] = {
        "mr": evaluator.evaluate(froz_coco),
        "agreement_f1_vs_dense": float(np.mean(froz_f1))}

    # BlockCopy at the shipped defaults
    f1s, coco, rate = run_blockcopy_mode(params, csp_cfg, ds_warm, ds_eval,
                                         dense_per_clip, args.target,
                                         device=device)
    results["modes"]["blockcopy"] = {
        "mr": evaluator.evaluate(coco),
        "agreement_f1_vs_dense": float(np.mean(f1s)),
        "exec_rate_eval": rate}
    print(json.dumps(results["modes"], indent=2), flush=True)

    # quality A/B of the two head lowerings that change numbers: module
    # flags, read at every call
    if not args.skip_flag_ab:
        for flag in ("HEAD_BLOCKED_FINAL", "HEAD_FUSED_BRANCH_CONV"):
            prev = getattr(cspmod, flag)
            setattr(cspmod, flag, False)
            try:
                f1s, coco, rate = run_blockcopy_mode(
                    params, csp_cfg, ds_warm, ds_eval, dense_per_clip,
                    args.target, device=device)
            finally:
                setattr(cspmod, flag, prev)
            results["modes"][f"blockcopy_{flag}=0"] = {
                "mr": evaluator.evaluate(coco),
                "agreement_f1_vs_dense": float(np.mean(f1s)),
                "exec_rate_eval": rate}
            print(flag, "=0 done", flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
