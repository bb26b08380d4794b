"""Detection ops inherited from mmdetection that the reference ships as CUDA
extensions but that lie off the BlockCopy path (counterpart of
``blockcopy_tpu/ops/extras.py``): sigmoid focal loss, RoIAlign and RoIPool,
deformable convolution (v1 and modulated v2) and masked convolution, in plain
torch.  The JAX package computes them outside any Pallas kernel, and nothing
in the CSP or SwiftNet configs calls them (``dcn=None``); the backbone API
accepts them, so the ops are provided.

Tensors are NHWC as in the JAX package; weights are OIHW.

References: ``Pedestron/mmdet/ops/sigmoid_focal_loss/``, ``ops/roi_align/``,
``ops/roi_pool/``, ``ops/dcn/``, ``ops/masked_conv/``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from blockcopy_tpu_torch.ops import layers as L


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25
                       ) -> torch.Tensor:
    """Per-element sigmoid focal loss, as the CUDA extension: targets are
    1-based class indices (0 = background), logits (N, C) over the
    foreground classes."""
    n, c = logits.shape
    class_range = torch.arange(1, c + 1, device=logits.device)[None, :]
    t = (targets[:, None] == class_range).to(logits.dtype)
    p = torch.sigmoid(logits)
    term_pos = (1 - p) ** gamma * F.logsigmoid(logits)
    term_neg = p ** gamma * F.logsigmoid(-logits)
    return -(t * term_pos * alpha + (1 - t) * term_neg * (1 - alpha))


def _roi_grid(rois, out_size, spatial_scale, sampling_ratio):
    """RoIAlign's sample coordinates: ys, xs each (R, out, s)."""
    s = sampling_ratio
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    bin_w = (x2 - x1).clamp_min(1.0) / out_size
    bin_h = (y2 - y1).clamp_min(1.0) / out_size
    dev = rois.device
    ob = torch.arange(out_size, dtype=torch.float32, device=dev)
    sb = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    # sample position = roi start + (bin index + sub-bin center) * bin size
    off = ob[None, :, None] + sb[None, None, :]          # (1, out, s)
    ys = y1[:, None, None] + off * bin_h[:, None, None]  # (R, out, s)
    xs = x1[:, None, None] + off * bin_w[:, None, None]
    return ys, xs


def _grid_yx(ys, xs, out_size):
    """Per-RoI (out, s) row and column coordinates -> (R, out, out, s, s)
    sample grids."""
    r, _, s = ys.shape
    shape = (r, out_size, out_size, s, s)
    return (ys[:, :, None, :, None].expand(shape),
            xs[:, None, :, None, :].expand(shape))


def roi_align(features: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign (bilinear-sampled average pooling per RoI bin).

    features: (N, H, W, C); rois: (R, 5) [batch index, x1, y1, x2, y2] in
    input pixels.  Returns (R, out_size, out_size, C)."""
    n, h, w, c = features.shape
    ys, xs = _roi_grid(rois, out_size, spatial_scale, sampling_ratio)
    y, x = _grid_yx(ys, xs, out_size)
    b = rois[:, 0].long()[:, None, None, None, None].expand(y.shape)
    # mmdet bilinear_interpolate: samples outside [-1, size] contribute zero
    # (not the clamped border value); inside, coordinates clamp to >= 0
    valid = (y >= -1.0) & (y <= h) & (x >= -1.0) & (x <= w)
    y = y.clamp(0.0, h - 1)
    x = x.clamp(0.0, w - 1)
    y0 = y.floor().long()
    x0 = x.floor().long()
    y1c = (y0 + 1).clamp(0, h - 1)
    x1c = (x0 + 1).clamp(0, w - 1)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    val = (features[b, y0, x0] * (1 - wy) * (1 - wx)
           + features[b, y0, x1c] * (1 - wy) * wx
           + features[b, y1c, x0] * wy * (1 - wx)
           + features[b, y1c, x1c] * wy * wx)
    val = torch.where(valid[..., None], val, torch.zeros_like(val))
    return val.mean(dim=(3, 4))


def roi_pool(features: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
             spatial_scale: float = 1.0) -> torch.Tensor:
    """RoIPool as the JAX package computes it: the max over a fixed 2x2 of
    rounded sample points per bin (static shapes), not mmdet's exact
    quantized bins."""
    n, h, w, c = features.shape
    ys, xs = _roi_grid(rois, out_size, spatial_scale, 2)
    y, x = _grid_yx(ys, xs, out_size)
    b = rois[:, 0].long()[:, None, None, None, None].expand(y.shape)
    y0 = torch.round(y).long().clamp(0, h - 1)
    x0 = torch.round(x).long().clamp(0, w - 1)
    return features[b, y0, x0].amax(dim=(3, 4))


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``img (H, W, C)`` at float positions; samples out
    of bounds contribute zero (the DCN kernels' zero padding,
    ``mmdet/ops/dcn/src/deform_conv_cuda_kernel.cu``
    dmcn_im2col_bilinear)."""
    h, w, _ = img.shape
    y0 = ys.floor()
    x0 = xs.floor()
    wy1 = ys - y0
    wx1 = xs - x0
    out = 0.0
    for dy, wy in ((0, 1 - wy1), (1, wy1)):
        for dx, wx in ((0, 1 - wx1), (1, wx1)):
            yy = y0.long() + dy
            xx = x0.long() + dx
            inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            v = img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
            out = out + v * (wy * wx * inb)[..., None]
    return out


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor = None, stride: int = 1, padding: int = 1,
                  dilation: int = 1, deformable_groups: int = 1,
                  mask: torch.Tensor = None) -> torch.Tensor:
    """Deformable convolution, v1 (``mask=None``) and modulated v2
    (``deform_conv_cuda`` / ``modulated_deform_conv``, ``mmdet/ops/dcn``):
    per-tap bilinear sampling at learned offsets, then one contraction over
    the gathered taps.

    Args:
        x: (N, H, W, C) features.
        offsets: (N, Ho, Wo, dg*kh*kw*2), the last axis (dy, dx) per tap in
            row-major tap order (torch layout).
        w: (Cout, C, kh, kw) OIHW weights.
        mask: optional (N, Ho, Wo, dg*kh*kw) modulation (DCNv2).
    Returns:
        (N, Ho, Wo, Cout).
    """
    n, h, wdt, c = x.shape
    cout, _, kh, kw = w.shape
    dg = deformable_groups
    assert c % dg == 0
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (wdt + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    off = offsets.reshape(n, ho, wo, dg, kh * kw, 2)
    mod = None if mask is None else mask.reshape(n, ho, wo, dg, kh * kw)
    dev = x.device
    base_y = (torch.arange(ho, device=dev) * stride - padding).float()
    base_x = (torch.arange(wo, device=dev) * stride - padding).float()
    wt = w.permute(2, 3, 1, 0).reshape(kh * kw, c, cout)
    cg = c // dg
    outs = []
    for i in range(n):
        taps = []
        for t in range(kh * kw):
            ky, kx = t // kw, t % kw
            ys = (base_y[:, None] + ky * dilation)[None] \
                + off[i, :, :, :, t, 0].permute(2, 0, 1)
            xs = (base_x[None, :] + kx * dilation)[None] \
                + off[i, :, :, :, t, 1].permute(2, 0, 1)
            # per deformable group: sample that group's channel slice
            per_g = []
            for g in range(dg):
                v = _bilinear_sample(x[i, ..., g * cg:(g + 1) * cg],
                                     ys[g], xs[g])
                if mod is not None:
                    v = v * mod[i, :, :, g, t][..., None]
                per_g.append(v)
            taps.append(torch.cat(per_g, dim=-1))         # (ho, wo, c)
        stacked = torch.stack(taps, dim=2)                # (ho, wo, taps, c)
        outs.append(torch.einsum("hwtc,tco->hwo", stacked, wt))
    out = torch.stack(outs)
    if b is not None:
        out = out + b
    return out


def masked_conv2d(ctx, name: str, x, w: torch.Tensor, mask: torch.Tensor,
                  b: torch.Tensor = None, stride: int = 1, padding: int = 1):
    """``masked_conv2d_cuda`` (``mmdet/ops/masked_conv``): a convolution
    whose output is needed only at masked pixels, computed densely and then
    masked, as the JAX package does (the MAC tally counts the dense cost).
    ``x`` dense NHWC or a ``BlockPack`` (the mask then in its layout)."""
    out = L.conv2d(ctx, name, x, w, b, stride=stride, padding=padding)
    m = mask.float()
    if m.dim() == 3:
        m = m[..., None]
    return L.emap(lambda d: d * m.to(d.dtype), out)
