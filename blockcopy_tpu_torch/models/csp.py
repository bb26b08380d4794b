"""CSP pedestrian detector (Center-and-Scale Prediction), dense and blocked
from one definition, and its BlockCopy ladder engine ``CSPBlockCopy``
(counterpart of ``blockcopy_tpu/models/csp.py``).

* ResNet-50 backbone with per-stage strides (1, 2, 2, 1), dilations
  (1, 1, 1, 2) and out_indices (1, 2, 3);
* neck: three transposed-conv upsampling heads (512/1024/2048 -> 256 at
  stride 4), a per-branch L2 norm, channel concat -> 768;
* head: per-branch 3x3 conv + GN(32) + ReLU, then the final 3x3 convs for
  the center, scale and offset maps;
* decode: ``csp_height2bbox`` and fixed-size multiclass NMS on the device;
* ``CSPBlockCopy``: ``BlockCopyModel``'s frame loop with the decode as its
  hook, per-class host box lists as each frame's outputs.

Parameters are nested dicts of tensors with the JAX pytree's structure: conv
weights OIHW, the neck's transposed-conv weights (in, out, kh, kw), GN
affine parameters and the two output scales in fp32 whatever the model's
dtype.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from blockcopy_tpu_torch.core import blocked as _blocked
from blockcopy_tpu_torch.core.blocked import ExecCtx
from blockcopy_tpu_torch.core.engine import BlockCopyModel
from blockcopy_tpu_torch.device import resolve_device
from blockcopy_tpu_torch.models.swiftnet import (_downsample, _Init, _stem,
                                                 maybe_fused_bottleneck)
from blockcopy_tpu_torch.ops import layers as L
from blockcopy_tpu_torch.ops import nms as _nms

# The head's final 3x3 convs run blocked over the executed blocks, their halo
# from the branch features' strip canvases, and the three maps are stored
# through per-map canvases (``csp.py:53``, on as in JAX).  Off: each branch
# is combined to dense after its ConvModule and the final convs run dense
# (the reference's tail).  They differ only at the 1-px borders of skipped
# blocks next to executed ones.
HEAD_BLOCKED_FINAL = os.environ.get(
    "BLOCKCOPY_TPU_HEAD_BLOCKED_FINAL", "1") == "1"

# The three branches' first convs run as one conv over the kernels
# concatenated on the output-channel axis: one halo exchange of the
# 768-channel neck output instead of three (``csp.py:68``, on as in JAX).
# The same per-channel arithmetic; applies with ``stacked_convs == 1``.
HEAD_FUSED_BRANCH_CONV = os.environ.get(
    "BLOCKCOPY_TPU_HEAD_FUSED_BRANCH_CONV", "1") == "1"


@dataclasses.dataclass(frozen=True)
class CSPConfig:
    depth: int = 50
    stage_blocks: Sequence[int] = (3, 4, 6, 3)
    strides: Sequence[int] = (1, 2, 2, 1)
    dilations: Sequence[int] = (1, 1, 1, 2)
    out_indices: Sequence[int] = (1, 2, 3)
    neck_out: int = 256
    head_feat: int = 256
    stacked_convs: int = 1
    num_classes: int = 2           # incl. background, mmdet convention
    head_stride: int = 4
    wh_ratio: float = 0.41
    l2norm_scale: float = 10.0
    gn_groups: int = 32
    # test cfg (csp_r50_clip_blockcopy_030.py:66-71)
    nms_pre: int = 1000
    score_thr: float = 0.1
    nms_iou: float = 0.5
    nms_type: str = "nms"  # 'nms' (on the device) | 'soft_nms' (host)
    max_per_img: int = 100

    @property
    def cls_out_channels(self) -> int:
        return self.num_classes - 1


# ---------------------------------------------------------------------------
# init (the JAX package's scheme drawn from one torch Generator: the values
# differ; ``utils/convert.py`` carries JAX's across)
# ---------------------------------------------------------------------------


def init_csp(cfg: CSPConfig, seed: int = 0, dtype=torch.float32,
             device=None) -> Dict:
    """Random CSP parameters on ``device`` (default CUDA)."""
    gen = torch.Generator().manual_seed(seed)
    dev = resolve_device(device)
    init = _Init(gen, dtype, dev)
    put = lambda t, dt=dtype: t.to(device=dev, dtype=dt)

    bb: Dict = {"conv1": init.conv(7, 7, 3, 64), "bn1": init.bn(64)}
    cin = 64
    for stage, (planes, blocks) in enumerate(
            zip((64, 128, 256, 512), cfg.stage_blocks)):
        stage_params = []
        for b in range(blocks):
            s = cfg.strides[stage] if b == 0 else 1
            stage_params.append(init.bottleneck(cin, planes, s, 1, planes))
            cin = planes * 4
        bb[f"layer{stage + 1}"] = stage_params

    def conv_t(k, c_in, c_out):
        # xavier-uniform as mmcv (csp_neck.py:48-51)
        bound = math.sqrt(3.0 / (k * k * (c_in + c_out) / 2))
        w = torch.rand((c_in, c_out, k, k), generator=gen) * 2 * bound - bound
        return {"w": put(w), "b": put(torch.zeros(c_out))}

    neck: Dict = {"p3": conv_t(4, 512, cfg.neck_out),
                  "p4": conv_t(4, 1024, cfg.neck_out),
                  "p5": conv_t(4, 2048, cfg.neck_out)}
    for p in ("p3", "p4", "p5"):
        neck[f"{p}_l2"] = put(torch.full((cfg.neck_out,), cfg.l2norm_scale))

    def normal(c_out, c_in):
        return put(torch.randn((c_out, c_in, 3, 3), generator=gen) * 0.01)

    f32 = torch.float32
    head: Dict = {}
    for branch in ("cls", "reg", "offset"):
        head[f"{branch}_convs"] = [
            {"conv": {"w": normal(cfg.head_feat,
                                  cfg.neck_out * 3 if i == 0
                                  else cfg.head_feat)},
             "gn": {"gamma": put(torch.ones(cfg.head_feat), f32),
                    "beta": put(torch.zeros(cfg.head_feat), f32)}}
            for i in range(cfg.stacked_convs)]
    bias_cls = float(-np.log((1 - 0.01) / 0.01))  # bias_init_with_prob(0.01)
    head["csp_cls"] = {
        "w": normal(cfg.cls_out_channels, cfg.head_feat),
        "b": put(torch.full((cfg.cls_out_channels,), bias_cls))}
    head["csp_reg"] = {"w": normal(1, cfg.head_feat),
                       "b": put(torch.zeros(1))}
    head["csp_offset"] = {"w": normal(2, cfg.head_feat),
                          "b": put(torch.zeros(2))}
    head["reg_scale"] = put(torch.ones(()), f32)
    head["offset_scale"] = put(torch.ones(()), f32)
    return {"backbone": bb, "neck": neck, "head": head}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _bottleneck_block(ctx, name, x, p, stride, dilation):
    """mmdet bottleneck (stride on the 3x3); the fused tail where the gate
    takes it, which a dilated block never is (``csp.py:224``)."""
    out = maybe_fused_bottleneck(ctx, name, x, p, stride, dilation=dilation)
    if out is not None:
        return out
    identity = _downsample(ctx, name, x, p, stride) \
        if "downsample" in p else x
    out = L.conv2d(ctx, f"{name}.conv1", x, p["conv1"]["w"], padding=0)
    out = L.relu(L.batch_norm(out, p["bn1"]["scale"], p["bn1"]["bias"]))
    out = L.conv2d(ctx, f"{name}.conv2", out, p["conv2"]["w"], stride=stride,
                   dilation=dilation)
    out = L.relu(L.batch_norm(out, p["bn2"]["scale"], p["bn2"]["bias"]))
    out = L.conv2d(ctx, f"{name}.conv3", out, p["conv3"]["w"], padding=0)
    out = L.batch_norm(out, p["bn3"]["scale"], p["bn3"]["bias"])
    return L.relu(L.add(out, identity))


def csp_backbone(params, x, ctx: ExecCtx, cfg: CSPConfig):
    """mmdet ResNet ``forward`` with per-stage strides and dilations; the
    features of ``out_indices``."""
    x = _stem(ctx, x, params)
    outs = []
    for stage in range(4):
        for b, p in enumerate(params[f"layer{stage + 1}"]):
            s = cfg.strides[stage] if b == 0 else 1
            x = _bottleneck_block(ctx, f"backbone.layer{stage + 1}.{b}", x, p,
                                  s, cfg.dilations[stage])
        if stage in cfg.out_indices:
            outs.append(x)
    return outs


def _l2norm(x, weight):
    """Per-pixel channel L2 norm times a learned per-channel scale, in fp32
    (reference ``csp_neck.py:85-101``)."""
    def f(d):
        df = d.float()
        norm = torch.sqrt((df * df).sum(-1, keepdim=True)) + 1e-10
        return (df / norm * weight).to(d.dtype)
    return L.emap(f, x)


def csp_neck(params, feats, ctx: ExecCtx, cfg: CSPConfig):
    outs = []
    for name, feat, stride, pad in (("p3", feats[0], 2, 1),
                                    ("p4", feats[1], 4, 0),
                                    ("p5", feats[2], 4, 0)):
        p = L.conv_transpose2d(ctx, f"neck.{name}", feat, params[name]["w"],
                               params[name]["b"], stride=stride, padding=pad)
        outs.append(_l2norm(p, params[f"{name}_l2"]))
    return L.concat_channels(outs)


def csp_head(params, x, ctx: ExecCtx, cfg: CSPConfig):
    """Three branches of blocked ConvModules, then the final prediction
    convs (``csp.py:293``).  Returns the dense fp32 (cls_score, bbox_pred,
    offset_pred) maps at stride 4."""
    blocked_tail = HEAD_BLOCKED_FINAL and not ctx.is_dense \
        and isinstance(x, _blocked.BlockPack)
    outs = {}
    branches = ("cls", "reg", "offset")

    def conv_module(feat, cm, dense_name):
        feat = L.group_norm(feat, cfg.gn_groups, cm["gn"]["gamma"],
                            cm["gn"]["beta"])
        feat = L.relu(feat)
        if not ctx.is_dense and not blocked_tail:
            # combine to dense after each ConvModule (csp_head.py:135-151)
            feat = ctx.store_dense(dense_name, feat)
        return feat

    if HEAD_FUSED_BRANCH_CONV and cfg.stacked_convs == 1:
        w_cat = torch.cat([params[f"{b}_convs"][0]["conv"]["w"]
                           for b in branches], dim=0)
        feat_all = L.conv2d(ctx, "head.branch0", x, w_cat)
        c = cfg.head_feat
        for j, branch in enumerate(branches):
            feat = L.emap(lambda d, lo=j * c: d[..., lo:lo + c], feat_all)
            outs[branch] = conv_module(feat, params[f"{branch}_convs"][0],
                                       f"head.{branch}0.dense")
    else:
        for branch in branches:
            feat = x
            for i, cm in enumerate(params[f"{branch}_convs"]):
                feat = L.conv2d(ctx, f"head.{branch}{i}", feat,
                                cm["conv"]["w"])
                feat = conv_module(feat, cm, f"head.{branch}{i}.dense")
            outs[branch] = feat
    fctx = ctx if blocked_tail else ctx.as_dense()
    maps = []
    for branch, key in zip(branches, ("csp_cls", "csp_reg", "csp_offset")):
        out = L.conv2d(fctx, f"head.{key}", outs[branch], params[key]["w"],
                       params[key]["b"])
        if blocked_tail:
            out = ctx.store_dense(f"head.{key}.out", out)
        maps.append(out)
    cls_score, bbox_pred, offset_pred = maps
    bbox_pred = bbox_pred.float() * params["reg_scale"]
    offset_pred = offset_pred.float() * params["offset_scale"]
    return cls_score.float(), bbox_pred, offset_pred


def csp_apply(params, x, ctx: ExecCtx, cfg: CSPConfig):
    """Backbone + neck + head -> dense prediction maps (NHWC, stride 4)."""
    feats = csp_backbone(params["backbone"], x, ctx, cfg)
    neck_out = csp_neck(params["neck"], feats, ctx, cfg)
    return csp_head(params["head"], neck_out, ctx, cfg)


def make_apply_fn(cfg: CSPConfig):
    def apply_fn(params, x, ctx):
        return csp_apply(params, x, ctx, cfg)
    return apply_fn


# ---------------------------------------------------------------------------
# box decode (get_bboxes)
# ---------------------------------------------------------------------------


def csp_height2bbox(points, heights, offsets, stride=1, wh_ratio=0.41,
                    max_shape=None):
    """Height and offset predictions -> xyxy boxes (reference
    ``mmdet/core/bbox/transforms.py:182-212``).  points (K, 2) [x, y];
    heights (K, 1+); offsets (K, 2) [dy, dx]."""
    x = points[:, 0] + offsets[:, 1] * stride
    y = points[:, 1] + offsets[:, 0] * stride
    hgt = heights[:, 0] * stride
    x1 = x - wh_ratio * hgt / 2
    y1 = y - hgt * 0.5
    x2 = x + wh_ratio * hgt / 2
    y2 = y + hgt * 0.5
    if max_shape is not None:
        x1 = x1.clamp(0, max_shape[1] - 1)
        y1 = y1.clamp(0, max_shape[0] - 1)
        x2 = x2.clamp(0, max_shape[1] - 1)
        y2 = y2.clamp(0, max_shape[0] - 1)
    return torch.stack([x1, y1, x2, y2], -1)


def decode_candidates(cls_score, bbox_pred, offset_pred, img_shape,
                      cfg: CSPConfig, rescale_factor: float = 1.0):
    """The first half of the decode (``csp.py:421-461``): sigmoid scores,
    the top ``nms_pre`` positions, their boxes.  Returns (flat indices
    (nms_pre,), boxes (nms_pre, 4), scores (nms_pre, C)).

    The top ``nms_pre`` come from a stable descending sort, which breaks ties
    to the lowest index as ``lax.top_k`` does (the 'sort' lowering);
    ``torch.topk`` leaves the order of ties unspecified.  The candidates'
    points are computed from their flat index (the lean form of
    ``DECODE_LEAN_POINTS``, bit-exact with gathering them)."""
    stride = cfg.head_stride
    w = cls_score.shape[2]
    scores = torch.sigmoid(cls_score[0].reshape(-1, cfg.cls_out_channels))
    heights = torch.exp(bbox_pred[0].reshape(-1, bbox_pred.shape[-1]))
    offsets = offset_pred[0].reshape(-1, 2)

    nms_pre = min(cfg.nms_pre, scores.shape[0])
    max_scores = scores.max(dim=1).values
    topk = torch.sort(max_scores, descending=True,
                      stable=True).indices[:nms_pre]
    points = torch.stack([(topk % w) * stride, (topk // w) * stride],
                         -1).float() + stride // 2
    heights = heights.index_select(0, topk)
    offsets = offsets.index_select(0, topk)
    scores = scores.index_select(0, topk)
    bboxes = csp_height2bbox(points, heights, offsets, stride=stride,
                             wh_ratio=cfg.wh_ratio,
                             max_shape=img_shape) / rescale_factor
    return topk, bboxes, scores


def csp_decode(cls_score, bbox_pred, offset_pred, img_shape, cfg: CSPConfig,
               rescale_factor: float = 1.0, nms_impl: str = None):
    """``get_bboxes_single`` (``csp_head.py:232-284``) at fixed shapes:
    ``decode_candidates``, then per-class NMS.  Maps are NHWC with N == 1.
    Returns (dets (max_per_img, 5), labels, valid)."""
    _, bboxes, scores = decode_candidates(cls_score, bbox_pred, offset_pred,
                                          img_shape, cfg, rescale_factor)
    return _nms.multiclass_nms_fixed(bboxes, scores, cfg.score_thr,
                                     cfg.nms_iou, cfg.max_per_img,
                                     impl=nms_impl)


def fetch_dets(dets, labels, valid):
    """(dets, labels, valid) as numpy; device tensors come back in one
    transfer (one host sync), packed as fp32 columns [dets | label |
    valid]: int32 labels below 2**24 and bools are exact in fp32."""
    if not isinstance(dets, torch.Tensor):
        return np.asarray(dets), np.asarray(labels), np.asarray(valid)
    packed = torch.cat([dets.detach().float(), labels[:, None].float(),
                        valid[:, None].float()], 1).cpu().numpy()
    return (packed[:, :5], packed[:, 5].astype(np.int32),
            packed[:, 6] > 0)


def soft_nms_rescore(dets, labels, valid, cfg: CSPConfig):
    """Host soft-NMS over the fixed-size decode output (reference
    ``soft_nms_cpu.pyx``; config ``nms=dict(type='soft_nms')``).  Returns
    the rescored fixed-size (dets, labels, valid) as numpy."""
    dets, labels, valid = fetch_dets(dets, labels, valid)
    cand_idx = np.nonzero(valid)[0]
    if len(cand_idx) == 0:
        return dets, labels, valid
    kept_dets, kept_orig = _nms.soft_nms_numpy(dets[cand_idx],
                                               iou_thr=cfg.nms_iou)
    out = np.zeros_like(dets)
    new_labels = np.zeros_like(labels)
    new_valid = np.zeros(len(dets), bool)
    k = min(len(kept_dets), len(dets))
    out[:k] = kept_dets[:k]
    new_labels[:k] = labels[cand_idx[kept_orig[:k]]]
    new_valid[:k] = True
    return out, new_labels, new_valid


def dets_to_bbox_results(dets, labels, valid, num_classes: int
                         ) -> List[List[np.ndarray]]:
    """Fixed-size dets -> mmdet ``bbox2result`` numpy lists
    (``mmdet/core/bbox/transforms.py:138-156``)."""
    dets, labels, valid = fetch_dets(dets, labels, valid)
    return [[dets[valid & (labels == c)].astype(np.float32)
             for c in range(num_classes - 1)]]


# ---------------------------------------------------------------------------
# BlockCopy detection engine
# ---------------------------------------------------------------------------


class CSPBlockCopy(BlockCopyModel):
    """Per-frame BlockCopy pipeline for CSP (reference
    ``csp_blockcopy.py:46-95``; JAX ``csp.py:508``): policy -> blocked
    backbone, neck and head -> decode and NMS on the device -> per-class
    box lists on the host; the policy is optimized with the detection
    information gain, which paints its masks from those lists.

    The frame loop, canvases, MAC record and frame-shape guard are
    ``BlockCopyModel``'s.  The head stores its three maps through canvases
    of its own, so the engine keeps no ``OUT`` canvas.  Host syncs per frame
    with a model run: the executed-block count and the boxes' one transfer
    (``fetch_dets``); the gain's masks go up without a sync
    (``device.py`` ``to_device``).
    """

    def __init__(self, params, cfg: CSPConfig, settings: dict, policy=None,
                 device=None):
        super().__init__(make_apply_fn(cfg), params, settings, policy,
                         device)
        self.cfg = cfg
        self._img_shape = None
        self._rescale = 1.0

    def _store_out(self, ctx, out):
        return out

    def _decode(self, maps):
        dets, labels, valid = csp_decode(*maps, self._img_shape, self.cfg,
                                         self._rescale)
        if self.cfg.nms_type == "soft_nms":
            dets, labels, valid = soft_nms_rescore(dets, labels, valid,
                                                   self.cfg)
        return dets_to_bbox_results(dets, labels, valid,
                                    self.cfg.num_classes)

    def simple_test(self, img, img_shape=None, rescale_factor: float = 1.0,
                    draws=None):
        """One frame; ``img`` dense (1, H, W, 3) normalized NHWC on the
        engine's device.  Returns the per-class (n, 5) box arrays;
        ``draws`` goes to the policy's ``forward``."""
        self._img_shape = tuple(img_shape or img.shape[1:3])
        self._rescale = rescale_factor
        return BlockCopyModel.__call__(self, img, draws)[0]

    __call__ = simple_test
    forward = simple_test
