"""Blocked / dense layer set (counterpart of ``blockcopy_tpu/ops/layers.py``,
the subset on the SwiftNet path).

Every layer takes an ``ExecCtx`` where it needs one and handles both a dense
NHWC tensor and a ``BlockPack``.  Activations are NHWC; conv weights are
OIHW.  ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is a
``channels_last`` NCHW view, so cuDNN convs need no copy.  Convs accumulate
in fp32 and round once to the activation dtype, then add the bias in that
dtype (``layers.py:401-414``).
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from blockcopy_tpu_torch.core.blocked import BlockPack, ExecCtx

Arrayish = Union[torch.Tensor, BlockPack]

# Debug/ablation switch (``layers.py:48``): pad blocked ops with zeros
# instead of the canvas halo exchange.
BLOCKPAD_WITH_ZEROES = os.environ.get("BLOCKCOPY_TPU_ZERO_HALO", "0") == "1"

# Whole ResNet stem in s2d plane form (``layers.py:101``), the JAX default:
# canvases ``backbone.conv1.s2d`` and ``backbone.maxpool.planes``.
STEM_PLANE_POOL = os.environ.get(
    "BLOCKCOPY_TPU_STEM_PLANE_POOL", "1") == "1"


def _data(x: Arrayish) -> torch.Tensor:
    return x.data if isinstance(x, BlockPack) else x


def _rewrap(x: Arrayish, data: torch.Tensor) -> Arrayish:
    return x.with_data(data) if isinstance(x, BlockPack) else data


def emap(fn, x: Arrayish, *rest: Arrayish) -> Arrayish:
    """Apply an elementwise/shape-preserving fn to dense or blocked input."""
    return _rewrap(x, fn(_data(x), *(_data(r) for r in rest)))


def relu(x: Arrayish) -> Arrayish:
    return emap(lambda d: torch.clamp_min(d, 0), x)


def add(a: Arrayish, b: Arrayish) -> Arrayish:
    return emap(lambda x, y: x + y, a, b)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _conv(data, w, b, stride, dilation, padding, groups):
    dt = data.dtype
    out = nhwc(F.conv2d(nchw(data), w.to(dt), None, stride, padding,
                        dilation, groups))
    if b is not None:
        out = out + b.to(dt)
    return out


def conv2d(ctx: ExecCtx, name: str, x: Arrayish, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, stride: int = 1,
           dilation: int = 1, padding: Optional[int] = None,
           groups: int = 1) -> Arrayish:
    """2D convolution, ``w`` OIHW.  Blocked input with padding > 0 goes
    through the canvas halo exchange; ``padding=None`` is
    ``((k-1)//2) * dilation``."""
    kh = w.shape[2]
    if padding is None:
        padding = ((kh - 1) // 2) * dilation
    if isinstance(x, BlockPack) and not ctx.is_dense:
        data = x.data
        if padding > 0:
            if BLOCKPAD_WITH_ZEROES:
                p = padding
                data = F.pad(data, (0, 0, p, p, p, p))
            else:
                data = ctx.exchange(name, x, padding)
        out = x.with_data(_conv(data, w, b, stride, dilation, 0, groups))
    else:
        out = _rewrap(x, _conv(_data(x), w, b, stride, dilation, padding,
                               groups))
    # output elements x (Cin/groups) x taps, as ``layers.py:456-460``
    ctx.add_macs(_data(out).numel() * w.shape[1] * kh * w.shape[3], name)
    return out


def batch_norm(x: Arrayish, scale: torch.Tensor,
               bias: torch.Tensor) -> Arrayish:
    """Inference BatchNorm as a folded affine op in the activation dtype."""
    return emap(lambda d: d * scale.to(d.dtype) + bias.to(d.dtype), x)


def max_pool2d(ctx: ExecCtx, name: str, x: Arrayish, kernel: int = 3,
               stride: int = 2, padding: int = 1) -> Arrayish:
    """Max pooling.  The blocked path pads through the halo exchange (zeros
    past the image, reference blockpad semantics), the dense path with -inf
    (``layers.py:640-657``)."""
    if isinstance(x, BlockPack) and not ctx.is_dense:
        data = ctx.exchange(name, x, padding) if padding > 0 else x.data
        return x.with_data(nhwc(F.max_pool2d(nchw(data), kernel, stride)))
    return _rewrap(x, nhwc(F.max_pool2d(nchw(_data(x)), kernel, stride,
                                        padding)))


def _adaptive_bins(size: int, out: int, device):
    """torch adaptive-pool bin edges: start floor(i*s/o), end ceil((i+1)s/o),
    built on the device."""
    i = torch.arange(out, device=device)
    return (i * size) // out, -((-((i + 1) * size)) // out)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Dense adaptive average pool with torch semantics, summed in fp32."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    if h % oh == 0 and w % ow == 0:
        kh, kw = h // oh, w // ow
        s = x.float().reshape(n, oh, kh, ow, kw, c).sum(dim=(2, 4))
        return (s / (kh * kw)).to(x.dtype)
    integ = torch.cumsum(torch.cumsum(x.float(), dim=1), dim=2)
    integ = F.pad(integ, (0, 0, 1, 0, 1, 0))
    ys, ye = _adaptive_bins(h, oh, x.device)
    xs, xe = _adaptive_bins(w, ow, x.device)
    sums = (integ[:, ye][:, :, xe] - integ[:, ye][:, :, xs]
            - integ[:, ys][:, :, xe] + integ[:, ys][:, :, xs])
    area = ((ye - ys)[:, None] * (xe - xs)[None, :]).float()
    return (sums / area[None, :, :, None]).to(x.dtype)


def adaptive_max_pool2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Dense adaptive max pool with torch semantics."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    if h % oh == 0 and w % ow == 0:
        kh, kw = h // oh, w // ow
        return x.reshape(n, oh, kh, ow, kw, c).amax(dim=(2, 4))
    ys = [(i * h) // oh for i in range(oh)]
    ye = [-((-(i + 1) * h) // oh) for i in range(oh)]
    xs = [(j * w) // ow for j in range(ow)]
    xe = [-((-(j + 1) * w) // ow) for j in range(ow)]
    rows = [torch.stack([x[:, ys[i]:ye[i], xs[j]:xe[j]].amax(dim=(1, 2))
                         for j in range(ow)], dim=1) for i in range(oh)]
    return torch.stack(rows, dim=1)


def _axis_lerp(data: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """Torch-exact bilinear along one axis in fp32: half-pixel centres, edge
    clamp, no antialiasing (``layers.py:761``)."""
    in_size = data.shape[dim]
    src = (torch.arange(out_size, dtype=torch.float32, device=data.device)
           + 0.5) * np.float32(in_size / out_size) - 0.5
    i0 = torch.floor(src)
    frac = src - i0
    i0 = i0.long()
    i0c = i0.clamp(0, in_size - 1)
    i1c = (i0 + 1).clamp(0, in_size - 1)
    a = data.index_select(dim, i0c).float()
    b = data.index_select(dim, i1c).float()
    shape = [1] * data.dim()
    shape[dim] = out_size
    f = frac.reshape(shape)
    return a * (1 - f) + b * f


def resize_bilinear(x: Arrayish, out_hw) -> Arrayish:
    """Bilinear resize, ``F.interpolate(align_corners=False)`` semantics,
    computed in fp32 and cast back; per block on blocked input."""

    def rs(data: torch.Tensor) -> torch.Tensor:
        out = _axis_lerp(data, out_hw[0], 1)
        out = _axis_lerp(out, out_hw[1], 2)
        return out.to(data.dtype)

    return emap(rs, x)


def upsample2x(x: Arrayish) -> Arrayish:
    d = _data(x)
    return resize_bilinear(x, (d.shape[1] * 2, d.shape[2] * 2))


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize matching ``F.interpolate(mode='nearest')``."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    if oh == h and ow == w:
        return x
    ry = torch.arange(oh, device=x.device) * h // oh
    rx = torch.arange(ow, device=x.device) * w // ow
    return x.index_select(1, ry).index_select(2, rx)


@functools.lru_cache(maxsize=None)
def _s2d_tap_map(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """0/1 map of dense 7-tap/stride-2 positions onto space-to-depth-4
    cells: ``m[d, s, a, i] = 1`` iff tap ``i`` of output sub-position ``a``
    reads cell offset ``d-1``, sub-pixel ``s`` (``layers.py:236``).  Cached
    per device: a fresh host-made tensor would be a synchronising copy."""
    m = np.zeros((3, 4, 2, 7), np.float32)
    for a in range(2):
        for i in range(7):
            d, s = divmod(2 * a + i - 3 + 4, 4)
            m[d, s, a, i] = 1.0
    return torch.from_numpy(m).to(device=device, dtype=dtype)


def _s2d_stem_conv_planes(ctx: ExecCtx, name: str, x: BlockPack,
                          w: torch.Tensor) -> torch.Tensor:
    """The 7x7 s2 p3 stem conv in s2d-4 form without depth-to-space
    (``layers.py:286``): ``(K, bs/4, bs/4, 4*Cout)``, channel
    ``(a*2+b)*Cout + o`` holding output pixel ``(2Y+a, 2X+b, o)``."""
    data = x.data
    k_blk, bs, _, c_in = data.shape
    c_out = w.shape[0]
    cells = bs // 4
    s2d = data.reshape(k_blk, cells, 4, cells, 4, c_in) \
              .permute(0, 1, 3, 2, 4, 5) \
              .reshape(k_blk, cells, cells, 16 * c_in)
    padded = ctx.exchange(f"{name}.s2d", x.with_data(s2d), 1)
    m = _s2d_tap_map(w.dtype, w.device)
    w_hwio = w.permute(2, 3, 1, 0)
    # wp[dY, sr, dX, sc, c, a, b, o] in the weight dtype, as the JAX repack
    wp = torch.einsum("dsai,ftbj,ijco->dsftcabo", m, m, w_hwio)
    wp = wp.permute(0, 2, 1, 3, 4, 5, 6, 7).reshape(3, 3, 16 * c_in,
                                                     4 * c_out)
    return _conv(padded, wp.permute(3, 2, 0, 1), None, 1, 1, 0, 1).to(
        data.dtype)


def stem_pool_s2d(ctx: ExecCtx, conv_name: str, pool_name: str,
                  x: BlockPack, w: torch.Tensor, bn_scale: torch.Tensor,
                  bn_bias: torch.Tensor) -> Optional[BlockPack]:
    """ResNet stem fused in s2d plane form (``layers.py:315``): 7x7 s2 p3
    conv + folded BN + ReLU + 3x3 s2 p1 maxpool, returning
    ``(K, bs/4, bs/4, Cout)``.  The pool is the max of 9 shifted (a, b)
    plane views; only the top/left cell halo is read."""
    c_out = w.shape[0]
    cells = x.data.shape[1] // 4
    planes = _s2d_stem_conv_planes(ctx, conv_name, x, w)
    dt = planes.dtype
    planes = planes * bn_scale.repeat(4).to(dt) + bn_bias.repeat(4).to(dt)
    planes = torch.clamp_min(planes, 0)

    pieces = ctx.exchange_pieces(f"{pool_name}.planes", x.with_data(planes),
                                 1)
    if pieces is None:
        return None

    def plane(t, a, b):
        lo = (a * 2 + b) * c_out
        return t[..., lo:lo + c_out]

    def padded_plane(a, b):
        cast = lambda p: plane(p.to(dt), a, b)
        top = torch.cat([cast(pieces["top_left"]), cast(pieces["top"])],
                        dim=2)
        body = torch.cat([cast(pieces["left"]), plane(planes, a, b)], dim=2)
        return torch.cat([top, body], dim=1)

    terms = ((1, 0), (0, 1), (1, 1))   # (a, start): start = 1 + dY
    out = None
    for a, ys in terms:
        for b, xs in terms:
            p = padded_plane(a, b)[:, ys:ys + cells, xs:xs + cells, :]
            out = p if out is None else torch.maximum(out, p)
    return x.with_data(out)
