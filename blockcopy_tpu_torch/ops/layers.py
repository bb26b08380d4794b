"""Blocked / dense layer set (counterpart of ``blockcopy_tpu/ops/layers.py``,
the subset on the SwiftNet and CSP paths).

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

# The JAX package's off-by-default lowerings, under its variables and
# defaults.  Each is read when a layer runs, so a caller may flip the module
# global between frames.
#
# Stride-1 blocked convs whose output blocks are at most this many px run as
# one tall conv over the padded blocks stacked along H, then a row gather
# (``layers.py:54``); 0 is off.
TALL_CONV_MAX_BS = int(os.environ.get("BLOCKCOPY_TPU_TALL_CONV_BS", "0"))
# Blocked 3x3 convs (p == d, s in {1, 2}) and 3x3/p1 max pools read the halo
# as its 8 unassembled pieces and correct the output borders, instead of
# convolving halo-padded blocks (``layers.py:74``).
BORDER_CONV = os.environ.get("BLOCKCOPY_TPU_BORDER_CONV", "0") == "1"
# The 7x7 s2 p3 stem conv on few-channel blocked input as a 3x3 conv over
# space-to-depth-4 cells, then depth-to-space-2 (``layers.py:86``).  Reached
# only where the plane-pool stem does not take the stem.
S2D_STEM = os.environ.get("BLOCKCOPY_TPU_S2D_STEM", "0") == "1"


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


def concat_channels(xs) -> Arrayish:
    """Concatenate along channels; the result wraps like ``xs[0]``."""
    return _rewrap(xs[0], torch.cat([_data(x) for x in xs], dim=-1))


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


def _halo_rows(strip: torch.Tensor, s: int, d: int, bs: int, dim: int,
               bottom: bool):
    """The rows (``dim`` 1) or columns (``dim`` 2) of a ``p``-deep halo
    strip that some output row reads, and the first output row they land
    on.  A padded row ``r`` is read by output row ``y`` through tap row
    ``i`` where ``y*s + i*d == r``; with ``p == d`` and ``s`` in {1, 2} the
    top strip is read only by tap 0 (rows ``0, s, ...`` onto output rows
    ``0, 1, ...``) and the bottom only by tap 2 (rows ``r0, r0 + s, ...``
    with ``(bs - d + r0) % s == 0``, onto output rows from
    ``(bs - d + r0) // s``)."""
    p = strip.shape[dim]
    r0 = (d - bs) % s if bottom else 0
    if r0 >= p:
        return None, 0
    idx = [slice(None)] * strip.dim()
    idx[dim] = slice(r0, None, s)
    return strip[tuple(idx)], ((bs - d + r0) // s if bottom else 0)


def _border_conv(ctx: ExecCtx, name: str, x: BlockPack, w: torch.Tensor,
                 b: Optional[torch.Tensor], s: int, d: int, p: int,
                 groups: int) -> Optional[torch.Tensor]:
    """Blocked 3x3 conv without the halo-padded blocks (``BORDER_CONV``,
    ``layers.py:134``): the conv of the packed centres with zero padding,
    plus strip convs of the halo pieces added to the output borders.

    The top and bottom pieces are full rows (``bs + 2p`` wide, corners
    included) and take tap rows ``W[0]`` / ``W[2]``; the left and right
    pieces are centre rows only, zero-padded by ``p`` above and below, and
    take tap columns ``W[:, 0]`` / ``W[:, 2]``.  Each correction is a matmul
    over the three stacked shifted slices of its strip.  The pieces come
    from the strip canvas ``name`` that ``ctx.exchange`` writes, so the
    carried state is the exchange path's.  Returns ``None`` where the
    canvas is not strip storage.

    Halo rows and columns are placed by ``_halo_rows``, which also covers
    ``s = 2`` at ``p = d = 2``, where the JAX lowering adds the second left
    halo column, which no tap reads, and leaves out the bottom row and the
    right column, which tap 2 reads."""
    pieces = ctx.exchange_pieces(name, x, p)
    if pieces is None:
        return None
    data = x.data
    bs, dt = data.shape[1], data.dtype
    cout, cin_g = w.shape[0], w.shape[1]
    out = _conv(data, w, None, s, d, p, groups).float()
    out_bs = out.shape[1]
    # taps[i, j, c, g, o]: HWIO with the output channels split by group
    wt = w.to(dt).permute(2, 3, 1, 0).reshape(3, 3, cin_g, groups,
                                              cout // groups)
    span = s * (out_bs - 1) + 1

    def tap_dot(stack, taps):
        # stack (K, rows, cols, 3, C) of shifted slices; taps (3, Cg, G, Og)
        k_, r_, c_ = stack.shape[:3]
        stack = stack.reshape(k_, r_, c_, 3, groups, cin_g)
        return torch.einsum("krztgc,tcgo->krzgo", stack, taps) \
            .reshape(k_, r_, c_, cout).float()

    def row_fix(strip, taps):      # strip (K, rows, bs+2p, C)
        return tap_dot(torch.stack(
            [strip[:, :, j * d:j * d + span:s] for j in range(3)], dim=3),
            taps)

    def col_fix(strip, taps):      # strip (K, bs, cols, C)
        col = F.pad(strip, (0, 0, 0, 0, p, p))
        return tap_dot(torch.stack(
            [col[:, i * d:i * d + span:s] for i in range(3)], dim=3), taps)

    cast = {k: v.to(dt) for k, v in pieces.items()}
    # out is this conv's own fresh tensor: the border adds happen in place
    for bottom, tap in ((False, 0), (True, 2)):
        side = "bottom" if bottom else "top"
        row = torch.cat([cast[f"{side}_left"], cast[side],
                         cast[f"{side}_right"]], dim=2)
        row, y0 = _halo_rows(row, s, d, bs, 1, bottom)
        if row is not None:
            fix = row_fix(row, wt[tap])
            out[:, y0:y0 + fix.shape[1]] += fix
        side = "right" if bottom else "left"
        col, x0 = _halo_rows(cast[side], s, d, bs, 2, bottom)
        if col is not None:
            fix = col_fix(col, wt[:, tap])
            out[:, :, x0:x0 + fix.shape[2]] += fix
    if b is not None:
        out = out + b.float()
    return out.to(dt)


def _s2d_stem_conv(ctx: ExecCtx, name: str, x: BlockPack, w: torch.Tensor,
                   b: Optional[torch.Tensor]) -> torch.Tensor:
    """The 7x7 s2 p3 stem conv as a 3x3 conv over s2d-4 cells giving the
    four output sub-positions as channels, then depth-to-space-2 and the
    bias (``S2D_STEM``, ``layers.py:249``).  The halo moves to the cells at
    pad 1, through the canvas ``<name>.s2d``."""
    k_blk, cells = x.data.shape[0], x.data.shape[1] // 4
    c_out = w.shape[0]
    out = _s2d_stem_conv_planes(ctx, name, x, w)
    out = out.reshape(k_blk, cells, cells, 2, 2, c_out) \
             .permute(0, 1, 3, 2, 4, 5) \
             .reshape(k_blk, 2 * cells, 2 * cells, c_out)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def _tall_conv(data, w, b, dilation, groups, bs_out):
    """Stride-1 conv of halo-padded square blocks ``(K, hp, hp, C)`` as one
    image ``(1, K*hp, hp, C)`` (``TALL_CONV_MAX_BS``, ``layers.py:441``):
    output rows that straddle two blocks are dropped by a row gather."""
    k_blk, hp, wp, c = data.shape
    o = _conv(data.reshape(1, k_blk * hp, wp, c), w, b, 1, dilation, 0,
              groups)
    o = o.reshape(-1, o.shape[2], o.shape[3])
    dev = data.device
    rows = (torch.arange(k_blk, device=dev)[:, None] * hp
            + torch.arange(bs_out, device=dev)[None, :]).reshape(-1)
    return o.index_select(0, rows).reshape(k_blk, bs_out, o.shape[1],
                                           o.shape[2])


def conv2d(ctx: ExecCtx, name: str, x: Arrayish, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, stride: int = 1,
           dilation: int = 1, padding: Optional[int] = None,
           groups: int = 1) -> Arrayish:
    """2D convolution, ``w`` OIHW.  Blocked input with padding > 0 goes
    through the canvas halo exchange, or one of the lowerings
    ``S2D_STEM``, ``BORDER_CONV``, ``TALL_CONV_MAX_BS`` under the conditions
    of ``layers.py:417-453``; ``padding=None`` is ``((k-1)//2) * dilation``."""
    kh, kw, cin = w.shape[2], w.shape[3], w.shape[1]
    if padding is None:
        padding = ((kh - 1) // 2) * dilation
    s, d, p = stride, dilation, padding
    if isinstance(x, BlockPack) and not ctx.is_dense:
        data = x.data
        bs = data.shape[1]
        o = None
        if p > 0 and S2D_STEM and not BLOCKPAD_WITH_ZEROES and kh == kw == 7 \
                and s == 2 and p == 3 and d == 1 and groups == 1 \
                and cin <= 4 and bs % 4 == 0 and bs >= 8:
            o = _s2d_stem_conv(ctx, name, x, w, b)
        elif p > 0 and BORDER_CONV and not BLOCKPAD_WITH_ZEROES \
                and kh == kw == 3 and p == d and s in (1, 2) \
                and (s == 1 or bs % 2 == 0):
            o = _border_conv(ctx, name, x, w, b, s, d, p, groups)
        if o is not None:
            out = x.with_data(o)
        else:
            if p > 0:
                data = F.pad(data, (0, 0, p, p, p, p)) \
                    if BLOCKPAD_WITH_ZEROES else ctx.exchange(name, x, p)
            bs_out = (bs + 2 * p - d * (kh - 1) - 1) // s + 1
            if p > 0 and TALL_CONV_MAX_BS and s == 1 \
                    and bs_out <= TALL_CONV_MAX_BS \
                    and data.shape[1] == data.shape[2]:
                out = x.with_data(_tall_conv(data, w, b, d, groups, bs_out))
            else:
                out = x.with_data(_conv(data, w, b, s, d, 0, groups))
    else:
        out = _rewrap(x, _conv(_data(x), w, b, stride, dilation, padding,
                               groups))
    # output elements x (Cin/groups) x taps, as ``layers.py:456-460``
    ctx.add_macs(_data(out).numel() * cin * kh * kw, name)
    return out


def conv_transpose2d(ctx: ExecCtx, name: str, x: Arrayish, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, stride: int = 2,
                     padding: int = 0) -> Arrayish:
    """Transposed convolution (the CSP neck's upsampling heads,
    ``layers.py:464``), ``w`` in torch's (in, out, kh, kw) layout: JAX's HWIO
    kernel permuted (2, 3, 0, 1), with no spatial flip (JAX flips because it
    lowers the op as an input-dilated conv).

    Blocked input runs per block with no halo, as the reference does: for
    padding > 0 the blocked output differs from the dense one along block
    seams.  That quirk is kept deliberately."""
    def run(data: torch.Tensor) -> torch.Tensor:
        dt = data.dtype
        out = nhwc(F.conv_transpose2d(nchw(data), w.to(dt), None, stride,
                                      padding))
        if b is not None:
            out = out + b.to(dt)
        return out

    out = _rewrap(x, run(_data(x)))
    cin, kh, kw = w.shape[0], w.shape[2], w.shape[3]
    ctx.add_macs(_data(out).numel() * cin * kh * kw / (stride * stride), name)
    return out


def group_norm(x: Arrayish, num_groups: int, gamma: torch.Tensor,
               beta: torch.Tensor, eps: float = 1e-5) -> Arrayish:
    """GroupNorm with statistics over the whole image, per image
    (``layers.py:525``), moments in fp32, the output cast back to the
    activation dtype.  On a ``BlockPack`` the statistics are joint over the
    image's executed blocks, segmented per image; padding slots
    (``idx == total``) are left out."""
    g = num_groups
    if isinstance(x, BlockPack):
        d = x.data.float()
        k, bs, _, c = d.shape
        dev = d.device
        valid = (x.idx < x.total).float()
        img = (x.idx // (x.gh * x.gw)).clamp(0, x.n - 1)
        dg = d.reshape(k, bs, bs, g, c // g)
        blk_sum = dg.sum(dim=(1, 2, 4)) * valid[:, None]
        img_sum = torch.zeros((x.n, g), device=dev).index_add_(0, img,
                                                               blk_sum)
        cnt = torch.zeros((x.n,), device=dev).index_add_(0, img, valid) \
            * (bs * bs * (c // g))
        cnt = cnt.clamp_min(1.0)
        mean = img_sum / cnt[:, None]
        cent = dg - mean.index_select(0, img)[:, None, None, :, None]
        blk_sq = (cent * cent).sum(dim=(1, 2, 4)) * valid[:, None]
        var = torch.zeros((x.n, g), device=dev).index_add_(0, img, blk_sq) \
            / cnt[:, None]
        inv = torch.rsqrt(var + eps).index_select(0, img)
        out = cent * inv[:, None, None, :, None]
        out = out.reshape(k, bs, bs, c) * gamma + beta
        return x.with_data(out.to(x.data.dtype))
    d = x.float()
    n, h, w, c = d.shape
    dg = d.reshape(n, h, w, g, c // g)
    mean = dg.mean(dim=(1, 2, 4), keepdim=True)
    var = ((dg - mean) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    out = (dg - mean) * torch.rsqrt(var + eps)
    out = out.reshape(n, h, w, c) * gamma + beta
    return out.to(x.dtype)


def batch_norm(x: Arrayish, scale: torch.Tensor,
               bias: torch.Tensor) -> Arrayish:
    """Inference BatchNorm as a folded affine op in the activation dtype."""
    return emap(lambda d: d * scale.to(d.dtype) + bias.to(d.dtype), x)


def _border_max_pool(ctx: ExecCtx, name: str, x: BlockPack,
                     s: int) -> Optional[torch.Tensor]:
    """Blocked 3x3/p1 max pool without the halo-padded blocks
    (``BORDER_CONV``, ``layers.py:574``): pool the centres with -inf
    padding, then take the max of the border rows and columns with window
    maxima of the halo pieces (zeros past the image, as the exchange path
    reads).  Under stride 2 the bottom/right halo is never read."""
    pieces = ctx.exchange_pieces(name, x, 1)
    if pieces is None:
        return None
    dt = x.data.dtype
    out = nhwc(F.max_pool2d(nchw(x.data), 3, s, 1))
    out_bs = out.shape[1]
    cast = {k: v.to(dt) for k, v in pieces.items()}

    def row_max(side):              # (K, 1, bs+2, C) -> (K, 1, out_bs, C)
        row = torch.cat([cast[f"{side}_left"], cast[side],
                         cast[f"{side}_right"]], dim=2)
        return nhwc(F.max_pool2d(nchw(row), (1, 3), (1, s)))

    def col_max(side):              # (K, bs, 1, C) -> (K, out_bs, 1, C)
        return nhwc(F.max_pool2d(nchw(cast[side]), (3, 1), (s, 1), (1, 0)))

    # out is this pool's own fresh tensor: the border maxima go in place
    out[:, :1] = torch.maximum(out[:, :1], row_max("top"))
    out[:, :, :1] = torch.maximum(out[:, :, :1], col_max("left"))
    if s == 1:
        out[:, out_bs - 1:] = torch.maximum(out[:, out_bs - 1:],
                                            row_max("bottom"))
        out[:, :, out_bs - 1:] = torch.maximum(out[:, :, out_bs - 1:],
                                               col_max("right"))
    return out


def max_pool2d(ctx: ExecCtx, name: str, x: Arrayish, kernel: int = 3,
               stride: int = 2, padding: int = 1) -> Arrayish:
    """Max pooling.  The blocked path pads through the halo exchange (zeros
    past the image, reference blockpad semantics), the dense path with -inf
    (``layers.py:640-657``); under ``BORDER_CONV`` a 3x3/p1 pool corrects
    its borders from the halo pieces instead."""
    if isinstance(x, BlockPack) and not ctx.is_dense:
        if BORDER_CONV and kernel == 3 and padding == 1 \
                and stride in (1, 2) \
                and (stride == 1 or x.data.shape[1] % 2 == 0):
            o = _border_max_pool(ctx, name, x, stride)
            if o is not None:
                return x.with_data(o)
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
