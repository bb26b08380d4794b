"""Detection information gain: the IoU-based instance-mask reward
(counterpart of ``blockcopy_tpu/tasks/detection/information_gain.py``).

The host functions take per-class numpy box lists, as the reference
(``blockcopy/policy/information_gain.py:43-160``).  The fixed-size variants
take the decode's (dets (K, 5), labels (K,), valid (K,)) tensors and run on
the device, so the detection step reads nothing back; they paint the
policy-input mask directly at the policy's resolution with scaled integer
boxes (box edges may differ by <= 1 px from painting at full resolution).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from blockcopy_tpu_torch.device import to_device

SUBSAMPLE = 2


def get_iou(bbox1, bbox2) -> float:
    ax1, ay1, ax2, ay2 = bbox1
    bx1, by1, bx2, by2 = bbox2
    x_left = max(ax1, bx1)
    y_top = max(ay1, by1)
    x_right = min(ax2, bx2)
    y_bottom = min(ay2, by2)
    if x_right < x_left or y_bottom < y_top:
        return 0.0
    inter = (x_right - x_left) * (y_bottom - y_top)
    a1 = (ax2 - ax1) * (ay2 - ay1)
    a2 = (bx2 - bx1) * (by2 - by1)
    return inter / float(max(a1 + a2 - inter, 1e-10))


def build_instance_mask(bbox_results: List[List[np.ndarray]], size,
                        dtype=np.float32) -> np.ndarray:
    """(N, H, W, C) score-weighted box mask (reference
    ``information_gain.py:56-66``)."""
    n, h, w, c = size
    mask = np.zeros((n, h, w, c), dtype)
    for cls in range(c):
        for row in bbox_results[0][cls]:
            x1, y1, x2, y2 = row[:4].astype(np.int32)
            region = mask[0, y1:y2, x1:x2, cls]
            mask[0, y1:y2, x1:x2, cls] = np.maximum(region, row[4])
    return mask


def build_instance_mask_iou_gain(bbox_results, bbox_results_prev, size,
                                 subsample=SUBSAMPLE) -> np.ndarray:
    """(N, H, W, 1) gain map (reference ``information_gain.py:68-108``)."""
    if len(bbox_results) != 1:
        raise ValueError("only batch size 1 is supported")
    n, h, w, c = size
    hs, ws = h // subsample, w // subsample
    mask = np.zeros((n, hs, ws, 1), np.float32)

    def paint(box, value):
        x1, y1, x2, y2 = box
        mask[0, y1:y2, x1:x2, 0] = np.maximum(mask[0, y1:y2, x1:x2, 0],
                                              value)

    for cls in range(c):
        cur = bbox_results[0][cls]
        prev = bbox_results_prev[0][cls]
        cur_boxes = (cur[:, :4] / subsample).astype(np.int32)
        prev_boxes = (prev[:, :4] / subsample).astype(np.int32)
        matched = set()
        for bbox, score in zip(cur_boxes, cur[:, 4]):
            best_iou, best_j = 0.0, None
            for j, pb in enumerate(prev_boxes):
                if pb[0] >= pb[2] or pb[1] >= pb[3]:
                    continue
                iou = get_iou(bbox, pb)
                if iou > best_iou:
                    best_iou, best_j = iou, j
            matched.add(best_j)
            ig = 1.0 - best_iou
            paint(bbox, ig * float(score))
            if best_j is not None:
                paint(prev_boxes[best_j], ig * float(prev[best_j, 4]))
        for j in range(len(prev_boxes)):
            if j not in matched:
                paint(prev_boxes[j], float(prev[j, 4]))
    # back to full resolution (nearest)
    return mask.repeat(subsample, axis=1).repeat(subsample, axis=2)


def paint_boxes_max(boxes: torch.Tensor, weights: torch.Tensor, h: int,
                    w: int, chunk: int = 8) -> torch.Tensor:
    """Max-paint boxes: (K, 4) int [x1, y1, x2, y2) and (K,) weights ->
    (h, w) fp32.  Boxes go ``chunk`` at a time, so the indicator tensor
    stays (chunk, h, w) for any K."""
    weights = weights.float()
    ys = torch.arange(h, dtype=boxes.dtype, device=boxes.device)
    xs = torch.arange(w, dtype=boxes.dtype, device=boxes.device)
    out = torch.zeros((h, w), device=boxes.device)
    for lo in range(0, boxes.shape[0], chunk):
        b, wgt = boxes[lo:lo + chunk], weights[lo:lo + chunk]
        row = (ys[None, :] >= b[:, 1:2]) & (ys[None, :] < b[:, 3:4])
        col = (xs[None, :] >= b[:, 0:1]) & (xs[None, :] < b[:, 2:3])
        m = row[:, :, None] & col[:, None, :]          # (chunk, h, w)
        vals = torch.where(m, wgt[:, None, None], 0.0).amax(0)
        out = torch.maximum(out, vals)
    return out


def _iou_matrix_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference ``get_iou`` (no +1 extents) pairwise: a (K, 4), b
    (Kp, 4) -> (K, Kp)."""
    lx = torch.maximum(a[:, None, 0], b[None, :, 0])
    ly = torch.maximum(a[:, None, 1], b[None, :, 1])
    rx = torch.minimum(a[:, None, 2], b[None, :, 2])
    ry = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (rx - lx).clamp_min(0.0) * (ry - ly).clamp_min(0.0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = (area_a[:, None] + area_b[None, :] - inter).clamp_min(1e-10)
    return inter / union


def iou_gain_fixed(dets, labels, valid, dets_prev, labels_prev, valid_prev,
                   hw, subsample: int = SUBSAMPLE) -> torch.Tensor:
    """``build_instance_mask_iou_gain`` over fixed-size det tensors
    (``information_gain.py:151``): (1, h // subsample, w // subsample, 1)
    fp32, without the host version's nearest upsample (the reward is
    max-pooled per block)."""
    h, w = hw
    hs, ws = h // subsample, w // subsample
    # float -> int32 truncates toward zero, as astype does
    cb = (dets[:, :4] / subsample).to(torch.int32)
    pb = (dets_prev[:, :4] / subsample).to(torch.int32)
    cs, ps = dets[:, 4], dets_prev[:, 4]
    kp = pb.shape[0]

    # degenerate previous boxes cannot match (the reference skips them)
    p_ok = valid_prev & (pb[:, 0] < pb[:, 2]) & (pb[:, 1] < pb[:, 3])
    iou = _iou_matrix_plain(cb.float(), pb.float())
    pair_ok = (valid[:, None] & p_ok[None, :]
               & (labels[:, None] == labels_prev[None, :]))
    iou = torch.where(pair_ok, iou, 0.0)
    best_iou, best_j = iou.max(dim=1)     # ties: the first index
    has_match = best_iou > 0.0            # the reference: strictly above 0
    ig = 1.0 - best_iou

    w_cur = torch.where(valid, ig * cs, 0.0)
    onehot = ((best_j[:, None] == torch.arange(kp, device=dets.device))
              & has_match[:, None] & valid[:, None])       # (K, Kp)
    ig_to_prev = torch.where(onehot, ig[:, None], 0.0).amax(dim=0)
    matched = onehot.any(dim=0)
    w_prev = torch.where(valid_prev,
                         torch.where(matched, ig_to_prev * ps, ps), 0.0)

    mask = paint_boxes_max(torch.cat([cb, pb]), torch.cat([w_cur, w_prev]),
                           hs, ws)
    return mask[None, :, :, None]


def instance_mask_fixed(dets, labels, valid, hw, num_fg_classes: int,
                        scale: float = 1.0) -> torch.Tensor:
    """``build_instance_mask`` over fixed-size det tensors
    (``information_gain.py:190``): (1, h, w, C) score-weighted box mask,
    boxes scaled by ``scale`` then truncated."""
    h, w = hw
    boxes = (dets[:, :4] * scale).to(torch.int32)
    maps = [paint_boxes_max(boxes, torch.where(valid & (labels == c),
                                               dets[:, 4], 0.0), h, w)
            for c in range(num_fg_classes)]
    return torch.stack(maps, -1)[None]


class DetectionInformationGain:
    """The detection reward for a REINFORCE policy: box lists are host
    data, painted on the host as the reference does; the policy sees the
    rasterized fp32 maps on its ``device``."""

    def __init__(self, num_classes: int, device="cpu"):
        self.num_classes = num_classes
        self.device = torch.device(device)

    def get_output_repr(self, policy_meta: Dict) -> torch.Tensor:
        n, h, w, _ = policy_meta["inputs"].shape
        return to_device(build_instance_mask(
            policy_meta["outputs"], (n, h, w, self.num_classes)),
            self.device)

    def compute(self, policy_meta: Dict) -> torch.Tensor:
        n, h, w, _ = policy_meta["inputs"].shape
        return to_device(build_instance_mask_iou_gain(
            policy_meta["outputs"], policy_meta["outputs_prev"],
            (n, h, w, self.num_classes)), self.device)
