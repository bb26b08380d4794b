"""Offline CSP detector training (counterpart of
``blockcopy_tpu/tasks/detection/train.py``): CSP losses against gaussian
center/scale/offset ground-truth maps, Adam with a step LR schedule and a
constant warm-up, and a mean-teacher EMA of the weights.

References: losses ``Pedestron/mmdet/models/anchor_heads/csp_head.py:332-416``,
GT maps ``mmdet/datasets/coco_csp_ori_clip.py:414-467``, runner
``mmdet/core/my_mmcv/runner/mean_teacher_runner.py`` and config
``csp_r50_clip_blockcopy_030.py:127-159`` (Adam lr 2e-4, EMA alpha 0.999,
steps [110, 160], warm-up 500 iterations at 1/3).

The train state is ``{params, ema_params, m, v, step}`` with the JAX
package's flat npz keys (``utils/checkpoint.py`` ``save_params``); ``step``
is a 0-d int32 tensor kept on the CPU, so the host reads it without a sync.
A train step makes no host sync: the losses stay on the device until the
caller reads them.  On CUDA the step is a captured CUDA graph, JAX's jitted,
donated step (``make_train_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from blockcopy_tpu_torch.core.blocked import ExecCtx
from blockcopy_tpu_torch.core.graphs import CallGraphs, as_tensors
from blockcopy_tpu_torch.device import resolve_device, to_device
from blockcopy_tpu_torch.models.csp import CSPConfig, csp_apply
from blockcopy_tpu_torch.policy.optim import (tree_copy_, tree_leaves,
                                              tree_map)

INF = 1e8


# ---------------------------------------------------------------------------
# ground-truth maps (host, numpy: per-sample preprocessing)
# ---------------------------------------------------------------------------


def _gaussian_1d(kernel: int) -> np.ndarray:
    sigma = ((kernel - 1) * 0.5 - 1) * 0.3 + 0.8
    s = 2 * sigma ** 2
    dx = np.exp(-np.square(np.arange(kernel) - int(kernel / 2)) / s)
    return dx.reshape(-1, 1)


def calc_gt_center(gts: np.ndarray, igs: Optional[np.ndarray],
                   image_shape: Tuple[int, int], radius: int = 8,
                   stride: int = 4, regress_range=(-1, INF)):
    """CSP ground-truth maps at ``stride`` resolution.

    gts / igs: (N, 4) xyxy pixel boxes (ignore regions).  Returns HWC maps:
    pos (h, w, 3): [gauss, keep-mask (0 inside ignore regions), centers];
    scale (h, w, 2): [log-height at the center's neighbourhood, mask];
    offset (h, w, 3): [y-offset, x-offset, mask].
    """
    radius = int(radius / stride)
    h, w = int(image_shape[0] / stride), int(image_shape[1] / stride)
    pos = np.zeros((h, w, 3), np.float32)
    scale = np.zeros((h, w, 2), np.float32)
    offset = np.zeros((h, w, 3), np.float32)
    pos[:, :, 1] = 1.0
    if igs is not None and len(igs) > 0:
        ig = igs / stride
        for x1, y1, x2, y2 in ig:
            pos[int(y1):int(np.ceil(y2)), int(x1):int(np.ceil(x2)), 1] = 0
    if len(gts) == 0:
        return pos, scale, offset
    heights = gts[:, 3] - gts[:, 1]
    keep = (heights >= regress_range[0]) & (heights <= regress_range[1])
    gts = gts[keep] / stride
    for x1f, y1f, x2f, y2f in gts:
        x1, y1 = int(np.ceil(x1f)), int(np.ceil(y1f))
        x2, y2 = int(x2f), int(y2f)
        if x2 <= x1 or y2 <= y1:
            continue
        c_x, c_y = int((x1f + x2f) / 2), int((y1f + y2f) / 2)
        gau = _gaussian_1d(y2 - y1) @ _gaussian_1d(x2 - x1).T
        pos[y1:y2, x1:x2, 0] = np.maximum(pos[y1:y2, x1:x2, 0], gau)
        pos[y1:y2, x1:x2, 1] = 1
        pos[c_y, c_x, 2] = 1
        ys, ye = max(c_y - radius, 0), min(c_y + radius + 1, h)
        xs, xe = max(c_x - radius, 0), min(c_x + radius + 1, w)
        scale[ys:ye, xs:xe, 0] = np.log(y2f - y1f)
        scale[ys:ye, xs:xe, 1] = 1
        offset[c_y, c_x, 0] = (y1f + y2f) / 2 - c_y - 0.5
        offset[c_y, c_x, 1] = (x1f + x2f) / 2 - c_x - 0.5
        offset[c_y, c_x, 2] = 1
    return pos, scale, offset


# ---------------------------------------------------------------------------
# losses (NHWC maps, as ``csp_apply`` returns them)
# ---------------------------------------------------------------------------


def _smooth_l1(x, y):
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def cls_pos_loss(cls_logits: torch.Tensor,
                 pos_map: torch.Tensor) -> torch.Tensor:
    """Center classification: BCE with CSP's hand-rolled focal weights
    (``csp_head.py:332-364``)."""
    logits = cls_logits[..., 0]
    gauss, keep, centers = pos_map[..., 0], pos_map[..., 1], pos_map[..., 2]
    log_loss = logits.clamp_min(0) - logits * centers \
        + torch.log1p(torch.exp(-logits.abs()))
    pred = torch.sigmoid(logits)
    fore = centers * (1.0 - pred) ** 2
    back = (keep - centers) * ((1.0 - gauss) ** 4.0) * pred ** 2
    return (fore + back).mul(log_loss).sum() / centers.sum().clamp_min(1.0)


def reg_pos_loss(h_pred: torch.Tensor,
                 scale_map: torch.Tensor) -> torch.Tensor:
    """Scale regression: masked smooth-L1 of the height ratio
    (``csp_head.py:367-381``).

    Positions whose log-height target is ~0 (a box crop-clipped to exactly
    the stride's height) are masked out: dividing by them gives ~1e10
    ratios, and one such sample destroys training."""
    target = scale_map[..., 0]
    safe = target.abs() > 1e-6
    mask = scale_map[..., 1] * safe.to(scale_map.dtype)
    denom = torch.where(safe, target, torch.ones_like(target))
    ratio_pred = h_pred[..., 0] / denom
    ratio_tgt = safe.to(target.dtype)
    l1 = mask * _smooth_l1(ratio_pred, ratio_tgt)
    return l1.sum() / mask.sum().clamp_min(1.0)


def offset_pos_loss(offset_pred: torch.Tensor,
                    offset_map: torch.Tensor) -> torch.Tensor:
    """Offset regression: masked smooth-L1 (``csp_head.py:402-416``)."""
    mask = offset_map[..., 2:3]
    l1 = mask * _smooth_l1(offset_pred, offset_map[..., :2])
    return l1.sum() / offset_map[..., 2].sum().clamp_min(1.0)


def csp_loss(outs, gt_maps, weights=(0.01, 1.0, 0.1)
             ) -> Dict[str, torch.Tensor]:
    """The weighted CSP loss terms (weights from
    ``csp_r50_clip_blockcopy_030.py:44-52``)."""
    cls_s, bbox_p, off_p = outs
    pos_map, scale_map, offset_map = gt_maps
    return {
        "loss_cls": cls_pos_loss(cls_s, pos_map) * weights[0],
        "loss_bbox": reg_pos_loss(bbox_p, scale_map) * weights[1],
        "loss_offset": offset_pos_loss(off_p, offset_map) * weights[2],
    }


# ---------------------------------------------------------------------------
# trainer: Adam + step LR + mean-teacher EMA
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 2e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    ema_alpha: float = 0.999
    warmup_iters: int = 500
    warmup_ratio: float = 1.0 / 3.0
    lr_steps: Tuple[int, ...] = (110, 160)  # epochs
    iters_per_epoch: int = 1000
    # (cls, bbox, offset) loss weights, the reference's by default.  The
    # 0.01 cls weight assumes epochs over a large dataset; short synthetic
    # runs (tools/validate_detection.py) up-weight cls so the center
    # heatmap becomes discriminative within hundreds of iterations.
    loss_weights: Tuple[float, float, float] = (0.01, 1.0, 0.1)


def lr_at(step: int, cfg: TrainConfig) -> float:
    """The learning rate of optimizer step ``step`` (the first update is
    step 1), rounded as the JAX package's float32 ``jnp.where`` chain: the
    first decay in float64 then float32, later ones in float32."""
    epoch = int(step) // cfg.iters_per_epoch
    lr = cfg.lr
    for s in cfg.lr_steps:
        decayed = lr * 0.1 if isinstance(lr, float) \
            else np.float32(lr) * np.float32(0.1)
        lr = np.float32(decayed if epoch >= s else lr)
    warm = np.float32(cfg.lr * cfg.warmup_ratio)
    return float(warm if int(step) < cfg.warmup_iters else np.float32(lr))


def init_train_state(params, cfg: TrainConfig) -> Dict:
    """Adam state at step 0; the teacher starts as a copy of the params,
    never an alias (the update writes both in place)."""
    zeros = lambda: tree_map(torch.zeros_like, params)
    return {
        "params": params,
        "ema_params": tree_map(lambda t: t.clone(), params),
        "m": zeros(),
        "v": zeros(),
        "step": torch.zeros((), dtype=torch.int32),
    }


def loss_and_grads(params, images: torch.Tensor, gt_maps,
                   model_cfg: CSPConfig, loss_weights=(0.01, 1.0, 0.1)):
    """Dense forward, the CSP loss, and its gradient with respect to every
    float leaf of ``params`` (as ``jax.value_and_grad`` over the JAX
    params: folded BN, GroupNorm affine, the neck's L2 norm weights, the
    head's biases and output scales included).  Returns
    ``(losses, grads)``: the loss terms and ``loss_total`` as device
    scalars, and a tree of gradients shaped like ``params``."""
    leaves = tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    p = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        outs = csp_apply(p, images, ExecCtx.dense(), model_cfg)
        losses = csp_loss(outs, gt_maps, weights=loss_weights)
        total = sum(losses.values())
        grads = torch.autograd.grad(total, live)
    it = iter(grads)
    losses = {k: v.detach() for k, v in losses.items()}
    losses["loss_total"] = total.detach()
    return losses, tree_map(lambda _: next(it), params)


def adam_schedule(step: int, cfg: TrainConfig) -> Tuple[float, float, float]:
    """Optimizer step ``step``'s learning rate and Adam's bias corrections
    ``1 - b1 ** step`` and ``1 - b2 ** step``, on the host, each rounded
    in float32 as the JAX package's ``train.py:204-216``."""
    b1, b2 = cfg.betas
    return (lr_at(step, cfg),
            float(1 - np.float32(b1) ** np.float32(step)),
            float(1 - np.float32(b2) ** np.float32(step)))


def adam_ema_(state: Dict, grads, lr: torch.Tensor, c1: torch.Tensor,
              c2: torch.Tensor, cfg: TrainConfig) -> None:
    """One Adam step and the mean-teacher EMA, in place on the tensors of
    ``state``'s ``params``, ``ema_params``, ``m`` and ``v``, in the JAX
    package's order of operations (``train.py:211-230``, each product
    rounded in float32).  ``lr``, ``c1`` and ``c2`` (``adam_schedule``)
    are 0-d float32 tensors on the state's device, as JAX divides by a
    device scalar: on CUDA, division by a Python float can multiply by its
    reciprocal instead, so the eager and the captured step take the same
    tensors through this same body."""
    b1, b2 = cfg.betas
    p, e = tree_leaves(state["params"]), tree_leaves(state["ema_params"])
    m, v = tree_leaves(state["m"]), tree_leaves(state["v"])
    g = tree_leaves(grads)
    with torch.no_grad():
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        gg = torch._foreach_mul(g, 1 - b2)
        torch._foreach_mul_(gg, g)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, gg)
        upd = torch._foreach_div(m, c1)
        den = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, den)
        torch._foreach_sub_(p, upd)
        a = cfg.ema_alpha
        torch._foreach_mul_(e, a)
        torch._foreach_add_(e, torch._foreach_mul(p, 1 - a))


def adam_ema_update(state: Dict, grads, cfg: TrainConfig) -> Dict:
    """``adam_ema_`` at the state's next step, which it advances.  The step
    counter lives on the host, so nothing here waits for the device."""
    step = int(state["step"]) + 1
    device = tree_leaves(state["params"])[0].device
    adam_ema_(state, grads, *as_tensors(adam_schedule(step, cfg), device),
              cfg)
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return state


# the train state's tensors, which the step writes in place
HELD = ("params", "ema_params", "m", "v")


def load_train_state_(state: Dict, loaded: Dict) -> Dict:
    """``loaded`` (``utils/checkpoint.py`` ``load_npz`` of a saved train
    state) copied into ``state``'s tensors, which a captured train step
    holds; its step becomes the host counter."""
    tree_copy_({k: state[k] for k in HELD}, {k: loaded[k] for k in HELD})
    state["step"] = torch.tensor(int(loaded["step"]), dtype=torch.int32)
    return state


def make_train_step(model_cfg: CSPConfig, cfg: TrainConfig, device=None,
                    graphs: bool = True):
    """``train_step(state, images, gt_maps) -> (state, losses)`` on
    ``device`` (default CUDA): dense training as the reference's offline
    phase, JAX's ``jax.jit(make_train_step(...), donate_argnums=(0,))``
    (``train_cli.py:98``).  The forward, the gradients and ``adam_ema_``
    write the state's tensors in place (the counterpart of donation); the
    host advances ``state["step"]`` and passes the step's learning rate
    and bias corrections in as 0-d float32 inputs.  With ``graphs`` that
    body is one CUDA graph per shape and dtype of the images and maps
    (``core/graphs.py`` ``CallGraphs``, at ``train_step.calls``), captured
    at its first call; the losses it returns are the graph's buffers,
    which the next call overwrites, so a caller clones what it keeps.
    ``graphs=False`` runs the same body op by op.  On the CPU the body
    runs eagerly either way (with ``graphs`` its losses still land in
    buffers that the next call overwrites).  Host arrays and CPU tensors
    go up pinned and asynchronously (``device.to_device``) before the
    graph sees them."""
    device = resolve_device(device)
    calls = CallGraphs(device) if graphs else None

    def put(x):
        if isinstance(x, torch.Tensor) and x.device.type == device.type:
            return x
        return to_device(x, device)

    def body(held, images, gt_maps, lr, c1, c2):
        losses, grads = loss_and_grads(held["params"], images, gt_maps,
                                       model_cfg, cfg.loss_weights)
        adam_ema_(held, grads, lr, c1, c2, cfg)
        return losses

    def train_step(state, images, gt_maps):
        step = int(state["step"]) + 1
        held = {k: state[k] for k in HELD}
        inputs = (put(images), tuple(map(put, gt_maps)),
                  *adam_schedule(step, cfg))
        losses = body(held, *as_tensors(inputs, device)) if calls is None \
            else calls((), body, held, *inputs)
        state["step"] = torch.tensor(step, dtype=torch.int32)
        return state, losses

    train_step.calls = calls
    return train_step
