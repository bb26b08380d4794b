"""The two tasks' outputs as the policy sees them: the representation fed
back to the policy, the information gain that rewards it, and for
detection the box decode and greedy NMS of mmdet's CSP head.

The detection mask painting and IoU gain are frozen copies of the served
program's plain, fixed-size versions (boxes scaled and truncated, IoU
without the +1 extents, as BlockCopy's reference); the NMS is mmdet's
greedy sweep with the +1 extents of its CUDA kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SUBSAMPLE = 2


def pool_to_grid(gain, grid_hw):
    """(1, 1, h, w) -> (gh, gw): the largest gain within each block."""
    return F.adaptive_max_pool2d(gain, grid_hw)[0, 0]


# ---------------------------------------------------------------------------
# semantic segmentation
# ---------------------------------------------------------------------------


def semseg_gain(cur, prev, scale: float = 0.25):
    """KL(prev || cur) per pixel at 1/4 of the logits' size, the mean over
    classes: (1, 1, h/4, w/4)."""
    hw = (int(cur.shape[2] * scale), int(cur.shape[3] * scale))
    rs = lambda t: F.interpolate(t.float(), hw, mode="bilinear",
                                 align_corners=False)
    log_p = torch.log_softmax(rs(cur), 1)
    log_q = torch.log_softmax(rs(prev), 1)
    return (torch.exp(log_q) * (log_q - log_p)).mean(1, keepdim=True)


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------


def height2bbox(points, heights, offsets, stride, wh_ratio, max_shape):
    """CSP's (height, offset) at a point -> clamped xyxy boxes."""
    x = points[:, 0] + offsets[:, 1] * stride
    y = points[:, 1] + offsets[:, 0] * stride
    hgt = heights[:, 0] * stride
    box = torch.stack([x - wh_ratio * hgt / 2, y - hgt * 0.5,
                       x + wh_ratio * hgt / 2, y + hgt * 0.5], -1)
    lim = torch.tensor([max_shape[1] - 1, max_shape[0] - 1] * 2,
                       dtype=box.dtype, device=box.device)
    return torch.minimum(box.clamp_min(0), lim)


def iou_plus1(a, b):
    """Pairwise IoU with +1 extents (mmdet's NMS kernel)."""
    area = lambda t: (t[:, 2] - t[:, 0] + 1).clamp_min(0) * (
        t[:, 3] - t[:, 1] + 1).clamp_min(0)
    lx = torch.maximum(a[:, None, 0], b[None, :, 0])
    ly = torch.maximum(a[:, None, 1], b[None, :, 1])
    rx = torch.minimum(a[:, None, 2], b[None, :, 2])
    ry = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (rx - lx + 1).clamp_min(0) * (ry - ly + 1).clamp_min(0)
    return inter / (area(a)[:, None] + area(b)[None, :] - inter).clamp_min(
        1e-10)


def decode(maps, img_hw, cfg: Dict):
    """CSP ``get_bboxes`` for one image: sigmoid centers, the top
    ``nms_pre`` (a stable sort: ties to the lowest position), boxes,
    greedy NMS above ``score_thr``, the ``max_per_img`` best kept.
    ``maps`` (cls, reg, offset) (1, c, h, w).  Returns fixed-size
    (dets (K, 5), labels (K,) int32, valid (K,) bool) in score order."""
    cls, reg, off = maps
    stride = cfg["head_stride"]
    h, w = cls.shape[2], cls.shape[3]
    scores = torch.sigmoid(cls[0].reshape(cls.shape[1], -1).t())
    heights = torch.exp(reg[0].reshape(reg.shape[1], -1).t())
    offsets = off[0].reshape(2, -1).t()
    top = torch.sort(scores.max(1).values, descending=True,
                     stable=True).indices[: cfg["nms_pre"]]
    points = torch.stack([(top % w) * stride, (top // w) * stride],
                         -1).float() + stride // 2
    boxes = height2bbox(points, heights[top], offsets[top], stride,
                        cfg["wh_ratio"], img_hw)
    scores = scores[top]
    k = cfg["max_per_img"]
    rows = []
    for c in range(scores.shape[1]):
        s = scores[:, c]
        live = (s > cfg["score_thr"]).cpu().numpy()
        s_np = s.cpu().numpy()
        dead = iou_plus1(boxes, boxes).cpu().numpy() > cfg["nms_iou"]
        order = np.argsort(-s_np, kind="stable")
        killed = ~live
        for i in order:
            if killed[i]:
                continue
            rows.append((float(s_np[i]), c, int(i)))
            if sum(r[1] == c for r in rows) == k:
                break
            killed |= dead[i]
    rows.sort(key=lambda r: -r[0])     # stable: class, then pivot order
    rows = rows[:k]
    dets = torch.zeros((k, 5), device=cls.device)
    labels = torch.zeros((k,), dtype=torch.int32, device=cls.device)
    valid = torch.zeros((k,), dtype=torch.bool, device=cls.device)
    for j, (_, c, i) in enumerate(rows):
        dets[j, :4] = boxes[i]
        dets[j, 4] = scores[i, c]
        labels[j] = c
        valid[j] = True
    return dets, labels, valid


def box_gap(served: Tuple, decoded: Tuple, img_hw) -> float:
    """The widest gap between two fixed-size box sets, each in score
    order: the largest difference of a valid row's coordinates (px) or
    score; the frame's larger side where the two keep different
    counts or labels."""
    d1, l1, v1 = served
    d2, l2, v2 = decoded
    n1, n2 = int(v1.sum()), int(v2.sum())
    if n1 != n2 or not torch.equal(l1[v1], l2[v2]):
        return float(max(img_hw))
    if n1 == 0:
        return 0.0
    return float((d1[v1].float() - d2[v2].float()).abs().max())


def paint_boxes_max(boxes, weights, h: int, w: int, chunk: int = 8):
    """Max-paint boxes (K, 4) int [x1, y1, x2, y2) with weights (K,) ->
    (h, w) fp32."""
    weights = weights.float()
    ys = torch.arange(h, dtype=boxes.dtype, device=boxes.device)
    xs = torch.arange(w, dtype=boxes.dtype, device=boxes.device)
    out = torch.zeros((h, w), device=boxes.device)
    for lo in range(0, boxes.shape[0], chunk):
        b, wgt = boxes[lo:lo + chunk], weights[lo:lo + chunk]
        row = (ys[None, :] >= b[:, 1:2]) & (ys[None, :] < b[:, 3:4])
        col = (xs[None, :] >= b[:, 0:1]) & (xs[None, :] < b[:, 2:3])
        m = row[:, :, None] & col[:, None, :]
        out = torch.maximum(out, torch.where(m, wgt[:, None, None],
                                             0.0).amax(0))
    return out


def instance_mask(dets, labels, valid, hw, classes: int, scale: float):
    """The score-weighted box mask the policy sees: (1, classes, h, w)."""
    boxes = (dets[:, :4] * scale).to(torch.int32)
    maps = [paint_boxes_max(boxes, torch.where(valid & (labels == c),
                                               dets[:, 4], 0.0), *hw)
            for c in range(classes)]
    return torch.stack(maps, 0)[None]


def _iou_plain(a, b):
    lx = torch.maximum(a[:, None, 0], b[None, :, 0])
    ly = torch.maximum(a[:, None, 1], b[None, :, 1])
    rx = torch.minimum(a[:, None, 2], b[None, :, 2])
    ry = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (rx - lx).clamp_min(0.0) * (ry - ly).clamp_min(0.0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp_min(
        1e-10)


def detection_gain(cur, prev, img_hw, subsample: int = SUBSAMPLE):
    """The IoU information gain between two frames' boxes, painted at
    1/``subsample``: (1, 1, h, w).  ``cur``/``prev`` are (dets, labels,
    valid)."""
    (dets, labels, valid), (dets_p, labels_p, valid_p) = cur, prev
    hs, ws = img_hw[0] // subsample, img_hw[1] // subsample
    cb = (dets[:, :4] / subsample).to(torch.int32)
    pb = (dets_p[:, :4] / subsample).to(torch.int32)
    p_ok = valid_p & (pb[:, 0] < pb[:, 2]) & (pb[:, 1] < pb[:, 3])
    iou = _iou_plain(cb.float(), pb.float())
    pair = valid[:, None] & p_ok[None, :] & (labels[:, None]
                                             == labels_p[None, :])
    iou = torch.where(pair, iou, 0.0)
    best_iou, best_j = iou.max(dim=1)
    ig = 1.0 - best_iou
    w_cur = torch.where(valid, ig * dets[:, 4], 0.0)
    onehot = ((best_j[:, None] == torch.arange(pb.shape[0],
                                               device=dets.device))
              & (best_iou > 0.0)[:, None] & valid[:, None])
    ig_prev = torch.where(onehot, ig[:, None], 0.0).amax(dim=0)
    w_prev = torch.where(valid_p, torch.where(onehot.any(0),
                                              ig_prev * dets_p[:, 4],
                                              dets_p[:, 4]), 0.0)
    mask = paint_boxes_max(torch.cat([cb, pb]), torch.cat([w_cur, w_prev]),
                           hs, ws)
    return mask[None, None]
