"""Fixed-size NMS in torch (counterpart of ``blockcopy_tpu/ops/nms.py``).

Replaces the reference's CUDA NMS extension (``nms_kernel.cu``, used every
frame by the CSP decode through ``multiclass_nms``) and the Cython
``soft_nms_cpu``.  Inputs are padded arrays of fixed size and the outputs a
fixed-size keep mask, so the detection step reads nothing back to the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# Greedy-NMS lowering (``nms.py:46`` of the JAX package):
#   'loop' (the port's default): ``max_keep`` argmax-selection rounds, a
#       fixed count with no data-dependent control flow, so the step stays
#       free of host syncs;
#   'fixpoint': the synchronous fixpoint iteration keep <- valid &
#       ~(sup @ keep), which converges to exactly the greedy solution after
#       (longest suppression chain + 1) rounds.  Its exit test reads a device
#       value on the host every round.
# JAX defaults to 'fixpoint' (its while_loop exits on the device); both give
# the greedy result exactly.
NMS_IMPL = os.environ.get("BLOCKCOPY_TPU_NMS", "loop")


def box_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 4) xyxy -> (N, N) pairwise IoU with +1 extents (the reference
    CUDA kernel's ``devIoU``)."""
    x1, y1, x2, y2 = boxes.unbind(1)
    area = (x2 - x1 + 1).clamp_min(0) * (y2 - y1 + 1).clamp_min(0)
    lx = torch.maximum(x1[:, None], x1[None, :])
    ly = torch.maximum(y1[:, None], y1[None, :])
    rx = torch.minimum(x2[:, None], x2[None, :])
    ry = torch.minimum(y2[:, None], y2[None, :])
    inter = (rx - lx + 1).clamp_min(0) * (ry - ly + 1).clamp_min(0)
    return inter / (area[:, None] + area[None, :] - inter).clamp_min(1e-10)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
             valid: torch.Tensor = None, iou: torch.Tensor = None,
             max_keep: int = None, impl: str = None) -> torch.Tensor:
    """Greedy NMS (``nms.py:62``); scores need not be sorted.

    'loop': each round takes the highest-scoring live box (ties to the lowest
    index) as a pivot and kills it and its overlaps; ``max_keep`` rounds
    (default N) keep exactly the first ``max_keep`` boxes of the sorted
    sequential sweep.  Once the live set is empty a round changes nothing.

    Args:
        boxes: (N, 4) xyxy.
        scores: (N,) finite scores (-inf marks a dead box).
        valid: (N,) bool; padding rows must be False.
        iou: optional precomputed (N, N) IoU of ``boxes``.
        max_keep: most boxes kept.
        impl: 'loop' | 'fixpoint'; None reads ``NMS_IMPL``.
    Returns:
        keep: (N,) bool.
    """
    n = boxes.shape[0]
    dev = boxes.device
    iou = box_iou_matrix(boxes) if iou is None else iou
    valid = torch.ones((n,), dtype=torch.bool, device=dev) \
        if valid is None else valid
    impl = NMS_IMPL if impl is None else impl
    if impl == "fixpoint":
        return _nms_mask_fixpoint(iou, scores, iou_thr, valid, max_keep)
    if impl != "loop":
        raise ValueError(f"unknown NMS lowering {impl!r}")
    iters = n if max_keep is None else min(max_keep, n)
    # a pivot always kills itself, whatever its IoU with itself
    dead_by = iou > iou_thr
    dead_by.fill_diagonal_(True)
    live = torch.where(valid, scores.float(),
                       torch.full((), float("-inf"), device=dev))
    pivots, alive = [], []
    for _ in range(iters):
        top, i = live.max(0)              # ties: the first maximal index
        pivots.append(i)
        alive.append(top)
        # with the live set empty this masks what is already dead
        live.masked_fill_(dead_by.index_select(0, i.view(1))[0],
                          float("-inf"))
    if not pivots:
        return torch.zeros((n,), dtype=torch.bool, device=dev)
    ok = (torch.stack(alive) > float("-inf")).float()
    hits = torch.zeros((n,), device=dev).index_add_(0, torch.stack(pivots),
                                                    ok)
    return hits > 0


def _nms_mask_fixpoint(iou: torch.Tensor, scores: torch.Tensor,
                       iou_thr: float, valid: torch.Tensor,
                       max_keep: int = None) -> torch.Tensor:
    """Greedy NMS as a synchronous fixpoint iteration (``nms.py:122``).

    ``sup[i, j]``: j precedes i in the pivot order (higher score, ties to the
    lower index) and their IoU exceeds the threshold.  ``keep <- valid &
    ~(sup @ keep)`` settles a box once its predecessors have settled; the
    loop stops at the first unchanged round, a test that reads the device on
    the host each round (a host sync, unlike the 'loop' lowering).  The
    ``max_keep`` cut keeps the first ``max_keep`` kept boxes in pivot order.
    """
    n = scores.shape[0]
    s = torch.where(valid, scores.float(),
                    torch.full((), float("-inf"), device=scores.device))
    idx = torch.arange(n, device=scores.device)
    prec = (s[None, :] > s[:, None]) | (
        (s[None, :] == s[:, None]) & (idx[None, :] < idx[:, None]))
    supf = (prec & (iou > iou_thr)).float()
    keep, prev, it = valid, ~valid, 0
    while it <= n and bool((keep != prev).any()):
        keep, prev = valid & ~((supf @ keep.float()) > 0), keep
        it += 1
    if max_keep is not None and max_keep < n:
        rank = prec.float() @ keep.float()
        keep = keep & (rank < max_keep)
    return keep


def multiclass_nms_fixed(bboxes: torch.Tensor, scores: torch.Tensor,
                         score_thr: float, iou_thr: float, max_per_img: int,
                         impl: str = None):
    """Per-class NMS over boxes shared by the classes, fixed-size output
    (``nms.py:166``, reference ``multiclass_nms``).  ``scores`` (N, C) hold
    the foreground classes only.

    Returns (dets (max_per_img, 5), labels (max_per_img,) int32, valid).
    """
    n, num_classes = scores.shape
    dev = bboxes.device
    # one IoU matrix for all classes; a budget of max_per_img kept boxes per
    # class is exact under the final top-max_per_img cut
    iou = box_iou_matrix(bboxes)
    dets, labels, keeps = [], [], []
    for c in range(num_classes):
        s = scores[:, c]
        keeps.append(nms_mask(bboxes, s, iou_thr, s > score_thr, iou=iou,
                              max_keep=max_per_img, impl=impl))
        dets.append(torch.cat([bboxes, s[:, None]], -1))
        labels.append(torch.full((n,), c, dtype=torch.int32, device=dev))
    dets, labels, keep = torch.cat(dets), torch.cat(labels), torch.cat(keeps)
    pad = max_per_img - dets.shape[0]
    if pad > 0:
        dets = torch.cat([dets, dets.new_zeros((pad, 5))])
        labels = torch.cat([labels, labels.new_zeros((pad,))])
        keep = torch.cat([keep, keep.new_zeros((pad,))])
    score_masked = torch.where(keep, dets[:, 4],
                               torch.full((), float("-inf"), device=dev))
    # stable, as jnp.argsort: the rows not kept all tie at -inf
    top = torch.argsort(-score_masked, stable=True)[:max_per_img]
    return dets[top], labels[top], keep[top]


def soft_nms_numpy(dets, iou_thr=0.3, method="linear", sigma=0.5,
                   min_score=1e-3):
    """Soft-NMS on the host (reference ``soft_nms_cpu.pyx``; ``nms.py:234``).

    dets: (N, 5) numpy [x1, y1, x2, y2, score]; returns the kept dets and
    their original indices.
    """
    dets = dets.copy().astype(np.float64)
    n_act = dets.shape[0]
    inds = np.arange(dets.shape[0])
    i = 0
    while i < n_act:
        max_pos = i + dets[i:n_act, 4].argmax()
        dets[[i, max_pos]] = dets[[max_pos, i]]
        inds[[i, max_pos]] = inds[[max_pos, i]]
        x1, y1, x2, y2 = dets[i, :4]
        area_i = max(x2 - x1 + 1, 0) * max(y2 - y1 + 1, 0)
        j = i + 1
        while j < n_act:
            xx1 = max(x1, dets[j, 0])
            yy1 = max(y1, dets[j, 1])
            xx2 = min(x2, dets[j, 2])
            yy2 = min(y2, dets[j, 3])
            w = max(xx2 - xx1 + 1, 0)
            h = max(yy2 - yy1 + 1, 0)
            inter = w * h
            area_j = max(dets[j, 2] - dets[j, 0] + 1, 0) * \
                max(dets[j, 3] - dets[j, 1] + 1, 0)
            ov = inter / max(area_i + area_j - inter, 1e-10)
            if w > 0 and h > 0:
                # the reference decays and removes a box only inside the
                # positive-overlap branch
                if method == "linear":
                    weight = 1 - ov if ov > iou_thr else 1.0
                elif method == "gaussian":
                    weight = np.exp(-(ov * ov) / sigma)
                else:  # naive nms
                    weight = 0.0 if ov > iou_thr else 1.0
                dets[j, 4] *= weight
                if dets[j, 4] < min_score:
                    # removed at once (swap with the last active row and
                    # look at this slot again): it never becomes a pivot
                    n_act -= 1
                    dets[j] = dets[n_act]
                    inds[j] = inds[n_act]
                    j -= 1
            j += 1
        i += 1
    return dets[:n_act].astype(np.float32), inds[:n_act]
