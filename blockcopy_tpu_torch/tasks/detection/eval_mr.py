"""CityPersons log-average miss-rate (MR) evaluation (counterpart of
``blockcopy_tpu/tasks/detection/eval_mr.py``, numpy only).

A clean-room reimplementation of the reference evaluator
(``Pedestron/tools/cityPerson/eval_MR_multisetup.py`` + ``eval_demo.py:6-18``):
the standard Caltech/CityPersons protocol — greedy IoU-0.5 matching with
ignore regions, miss rate sampled at 9 FPPI points in [0.01, 1], averaged in
log space — under the four setups:

    Reasonable          height >= 50, visibility >= 0.65
    Reasonable_small    height 50..75, visibility >= 0.65
    Reasonable_occ=heavy height >= 50, visibility 0.2..0.65
    All                 height >= 20, visibility 0.2..inf

Works directly on COCO-format dicts (no pycocotools dependency): GT
annotations need ``bbox`` (xywh), ``height``, ``vis_ratio``, ``ignore``;
detections need ``image_id``, ``bbox`` (xywh), ``score``.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

HT_RNG = [[50, 1e10], [50, 75], [50, 1e10], [20, 1e10]]
VIS_RNG = [[0.65, 1e10], [0.65, 1e10], [0.2, 0.65], [0.2, 1e10]]
SETUP_LABELS = ["Reasonable", "Reasonable_small", "Reasonable_occ=heavy",
                "All"]
FPPI_THRS = np.array([0.0100, 0.0178, 0.0316, 0.0562, 0.1000, 0.1778,
                      0.3162, 0.5623, 1.0000])
EXP_FILTER = 1.25
IOU_THR = 0.5
MAX_DETS = 1000


def _iou_matrix(dts: np.ndarray, gts: np.ndarray,
                gt_ignore: np.ndarray) -> np.ndarray:
    """xywh IoU; for ignore GTs the union is the detection area alone
    (crowd-style, reference ``eval_MR_multisetup.py:188-219``)."""
    ious = np.zeros((len(dts), len(gts)))
    for j, g in enumerate(gts):
        gx1, gy1, gw, gh = g
        garea = gw * gh
        for i, d in enumerate(dts):
            dx1, dy1, dw, dh = d
            iw = min(dx1 + dw, gx1 + gw) - max(dx1, gx1)
            ih = min(dy1 + dh, gy1 + gh) - max(dy1, gy1)
            if iw <= 0 or ih <= 0:
                continue
            inter = iw * ih
            union = dw * dh if gt_ignore[j] else dw * dh + garea - inter
            ious[i, j] = inter / union
    return ious


def _match_image(gt_list: List[dict], dt_list: List[dict], hrng, vrng):
    """Greedy per-image matching (reference ``evaluateImg``,
    ``eval_MR_multisetup.py:221-320``).  Returns (dt_scores, dt_matched,
    dt_ignored, n_valid_gt)."""
    gts = list(gt_list)
    for g in gts:
        ig = g.get("ignore", 0)
        h = g.get("height", g["bbox"][3])
        vis = g.get("vis_ratio", 1.0)
        g["_ignore"] = 1 if (ig or h < hrng[0] or h > hrng[1]
                             or vis < vrng[0] or vis > vrng[1]) else 0
    gts = sorted(gts, key=lambda g: g["_ignore"])  # ignore last (stable)
    dts = sorted(dt_list, key=lambda d: -d["score"])[:MAX_DETS]
    # height pre-filter on detections with the expanded range
    dts = [d for d in dts
           if hrng[0] / EXP_FILTER <= d.get("height", d["bbox"][3])
           < hrng[1] * EXP_FILTER]

    gt_ig = np.array([g["_ignore"] for g in gts], int)
    if dts and gts:
        ious = _iou_matrix(
            np.array([d["bbox"] for d in dts], float),
            np.array([g["bbox"] for g in gts], float),
            gt_ig,
        )
    else:
        ious = np.zeros((len(dts), len(gts)))

    gt_matched = np.zeros(len(gts), bool)
    dt_matched = np.zeros(len(dts), bool)
    dt_ignored = np.zeros(len(dts), bool)
    for di in range(len(dts)):
        best_iou = min(IOU_THR, 1 - 1e-10)
        best_g = -1
        best_is_real = False
        for gi in range(len(gts)):
            if gt_matched[gi] and not gt_ig[gi]:
                continue
            # once matched to a real gt, don't fall through to ignore gts
            if best_is_real and gt_ig[gi]:
                break
            if ious[di, gi] < best_iou:
                continue
            best_iou = ious[di, gi]
            best_g = gi
            best_is_real = not gt_ig[gi]
        if best_g == -1:
            continue
        dt_ignored[di] = bool(gt_ig[best_g])
        dt_matched[di] = True
        if best_is_real:
            gt_matched[best_g] = True
    scores = np.array([d["score"] for d in dts], float)
    n_valid_gt = int((gt_ig == 0).sum())
    return scores, dt_matched, dt_ignored, n_valid_gt


def evaluate_setup(gt_by_img: Dict, dt_by_img: Dict, img_ids: Sequence,
                   setup: int) -> float:
    """Log-average miss rate for one setup (reference ``accumulate`` +
    ``summarize``, ``eval_MR_multisetup.py:322-470``)."""
    hrng, vrng = HT_RNG[setup], VIS_RNG[setup]
    all_scores, all_tp, all_fp = [], [], []
    npig = 0
    for img_id in img_ids:
        gt = [dict(g) for g in gt_by_img.get(img_id, [])]
        dt = dt_by_img.get(img_id, [])
        if not gt and not dt:
            continue
        scores, matched, ignored, nv = _match_image(gt, dt, hrng, vrng)
        npig += nv
        keep = ~ignored
        all_scores.append(scores[keep])
        all_tp.append(matched[keep])
        all_fp.append(~matched[keep])
    if npig == 0:
        return -1.0
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    tp = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
    fp = np.concatenate(all_fp) if all_fp else np.zeros(0, bool)
    order = np.argsort(-scores, kind="mergesort")
    tp, fp = tp[order], fp[order]
    tp_sum = np.cumsum(tp).astype(float)
    fp_sum = np.cumsum(fp).astype(float)
    n_imgs = len(img_ids)
    fppi = fp_sum / n_imgs
    recall = (tp_sum / npig).tolist()
    # monotone non-increasing fix from the right
    for i in range(len(recall) - 1, 0, -1):
        if recall[i] < recall[i - 1]:
            recall[i - 1] = recall[i]
    q = np.zeros(len(FPPI_THRS))
    if len(recall):
        inds = np.searchsorted(fppi, FPPI_THRS, side="right") - 1
        for ri, pi in enumerate(inds):
            # pi == -1 replicates the reference's wrap-to-last quirk
            q[ri] = recall[pi]
    mrs = 1.0 - q
    mrs = mrs[mrs < 2]
    if len(mrs) == 0:
        return -1.0
    # protocol-exact log-average: a zero miss rate at any FPPI point makes
    # log() -inf and the result exactly 0, as in the reference
    # (``eval_MR_multisetup.py:478-481`` — no epsilon clamp)
    with np.errstate(divide="ignore"):
        return float(np.exp(np.mean(np.log(mrs))))


class CityPersonsMREvaluator:
    """End-to-end: COCO-format GT json + detection list -> 4 MR percentages
    (reference ``eval_demo.py.validate``)."""

    def __init__(self, ann_file_or_dict):
        if isinstance(ann_file_or_dict, str):
            with open(ann_file_or_dict) as f:
                gt = json.load(f)
        else:
            gt = ann_file_or_dict
        self.img_ids = sorted(img["id"] for img in gt["images"])
        self.gt_by_img = defaultdict(list)
        for ann in gt["annotations"]:
            self.gt_by_img[ann["image_id"]].append(ann)

    def evaluate(self, detections: List[dict]) -> Dict[str, float]:
        """detections: COCO result dicts with image_id / bbox xywh / score."""
        dt_by_img = defaultdict(list)
        for i, d in enumerate(detections):
            d = dict(d)
            d.setdefault("height", d["bbox"][3])
            dt_by_img[d["image_id"]].append(d)
        out = {}
        for s, label in enumerate(SETUP_LABELS):
            mr = evaluate_setup(self.gt_by_img, dt_by_img, self.img_ids, s)
            out[label] = mr * 100 if mr >= 0 else -1.0
        return out


def bbox_results_to_coco(bbox_results, image_id: int) -> List[dict]:
    """Per-class xyxy+score arrays -> COCO result dicts (xywh), as the
    reference dumps for validation (``test_city_person.py:338-359``)."""
    out = []
    for cls, arr in enumerate(bbox_results):
        for row in np.asarray(arr):
            x1, y1, x2, y2, score = [float(v) for v in row[:5]]
            out.append({
                "image_id": image_id,
                "category_id": cls + 1,
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "height": y2 - y1,
                "score": score,
            })
    return out
