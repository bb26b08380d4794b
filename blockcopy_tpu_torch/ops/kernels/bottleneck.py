"""Fused bottleneck tail: the CUDA kernel ``csrc/bottleneck.cu`` with its
plain version.

Replaces the Pallas kernel ``blockcopy_tpu/ops/pallas/bottleneck.py``
(``bottleneck_tail`` :92):

    y = relu(bn3(conv1x1(relu(bn2(conv3x3(pad(h1)))))) + x)

with the padded 3x3 input built from ``h1`` and the halo site's edge strips
at pad 1, as ``ExecCtx.exchange_strips`` leaves them (a ``StripHalo``): the
kernel reads each halo pixel from its neighbour's strip, so the 8 pieces the
JAX package gathers first never exist on the card.  A CPU tensor takes the
plain version (the pieces by ``gather_halo_strips_plain``, then
``bottleneck_tail_plain``); a CUDA tensor launches the kernel or raises.

The kernel has three routes, each counted under its own key of
``kernels.launches``: bf16 blocks of ``BF16_BLOCKS`` with Co a multiple of
256 run the ``wgmma`` route (``bottleneck_tail``); every other bf16 block
runs the row route (``bottleneck_tail_rows``: one launch over bands of a
block's rows, h2 kept on chip, laid out by ``row_plan``); fp32 runs the
3xTF32 route (``bottleneck_tail_f32``).  Between them the kernel takes any
block with Cm and Co multiples of 64 (on the row route bs up to 128 and Cm
up to 1024), a superset of what the JAX gate fuses.

The kernel reads its weights in the layouts of ``prepare_tail_weights``.
The wrapper prepares each parameter set once (``prepared_tail_weights``,
cached on the tensors' identity and version), not on every launch.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import build
from blockcopy_tpu_torch.ops.kernels.halo import (PIECES,
                                                  gather_halo_strips_plain)

# (bs, Cm) of the blocks the bf16 wgmma route holds in shared memory, at
# Co a multiple of 256; the row route takes the other bf16 blocks
BF16_BLOCKS = ((16, 128), (8, 256), (8, 128))
# the column tile and depth chunk of the row and fp32 routes
TILE = 64
# shared memory a row-route CTA may take: the card's 232,448 bytes less 1 KB
# for its static barriers
ROW_SMEM_MAX = 232448 - 1024
# (ring stages, x / y buffers) of a row-route plan, the first that fits
RING_FITS = ((8, 2), (8, 1), (6, 2), (6, 1), (4, 2), (4, 1), (3, 2), (3, 1),
             (2, 1))


def kernel_takes(dtype, bs: int, cm: int, co: int) -> bool:
    """Whether the kernel of ``dtype`` takes a (K, bs, bs, Cm) -> Co block:
    bf16 and fp32 at any bs with Cm and Co multiples of ``TILE``.  Pure in
    dtype and shape, so a CPU run routes blocks as the card does."""
    return (dtype in (torch.bfloat16, torch.float32) and bs >= 1
            and cm % TILE == 0 and co % TILE == 0)


def route(dtype, bs: int, cm: int, co: int) -> str:
    """The route a block the kernel takes runs on: its key in
    ``kernels.launches``."""
    if dtype == torch.float32:
        return "bottleneck_tail_f32"
    if (bs, cm) in BF16_BLOCKS and co % 256 == 0:
        return "bottleneck_tail"
    return "bottleneck_tail_rows"


def _row_smem(bs, cm, mt, rows, np_, nt, stages, xbuf):
    m = 64 * mt
    band = -(-(rows + 2) * (bs + 2) * 144 // 1024) * 1024
    return (stages * max(np_, 128) * 128 + cm * m * 2 + xbuf * nt * m * 2
            + 2 * band + 1024)



def row_plan(k: int, bs: int, cm: int, co: int, sms: int):
    """The row route's launch plan (``csrc/bottleneck.cu`` ``band_plan``,
    whose ``bottleneck_rows_plan`` entry the GPU tests hold this against):
    a dict of ``mt`` (m64 tiles a band), ``rows`` (image rows a band),
    ``bands`` (a block), ``cs`` (CTAs a cluster, splitting h2's and y's
    channels), ``np`` (channels of a 3x3 pass), ``nt`` (of a 1x1 tile),
    ``stages`` (weight ring), ``xbuf`` (x / y tile buffers) and ``smem``
    (bytes), or None where no plan fits.  Of the (mt, cs) pairs whose
    buffers fit, the one with the fewest product rows x columns a CTA issues
    times waves of CTAs on ``sms`` SMs; ties to the smaller cs, then the
    larger mt."""
    best, best_cost = None, None
    for cs in (1, 2, 4):
        if cm % (64 * cs) or co % (64 * cs):
            continue
        for mt in (2, 1):
            m = 64 * mt
            rows = min(bs, m // bs)
            if rows == 0 or (mt == 2 and bs * bs <= 64):
                continue
            n3, cap = cm // cs, 256 if mt == 1 else 128
            widest = 64
            while 2 * widest <= min(n3, cap):
                widest *= 2
            # the widest 3x3 pass, then 1x1 tiles of 128 channels a
            # warpgroup, then the deepest ring, then two x / y buffers
            fit = next(((np_, nt, st, xb)
                        for np_ in (widest, widest // 2, widest // 4)
                        if np_ >= 64
                        for nt in ((256, 128) if mt == 1 else (128,))
                        for st, xb in RING_FITS
                        # a chunk's stages are released one chunk late
                        if st >= 2 * (nt // 128)
                        and _row_smem(bs, cm, mt, rows, np_, nt, st, xb)
                        <= ROW_SMEM_MAX), None)
            if fit is None:
                continue
            np_, nt = fit[:2]
            bands = -(-bs // rows)
            ctas = k * bands * cs
            passes, tiles = -(-n3 // np_), -(-(co // cs) // nt)
            cost = (-(-ctas // sms) * m
                    * (9 * cm * passes * np_ + cm * tiles * nt))
            if best_cost is None or cost < best_cost:
                best_cost = cost
                best = {"mt": mt, "rows": rows, "bands": bands, "cs": cs,
                        "np": np_, "nt": nt, "stages": fit[2],
                        "xbuf": fit[3],
                        "smem": _row_smem(bs, cm, mt, rows, *fit)}
    return best


def row_plan_c(k: int, bs: int, cm: int, co: int, sms: int):
    """``row_plan`` as the CUDA library computes it (card only)."""
    out = (ctypes.c_int * 9)()
    _lib().bottleneck_rows_plan(k, bs, cm, co, sms, out)
    keys = ("mt", "rows", "bands", "cs", "np", "nt", "stages", "xbuf",
            "smem")
    return dict(zip(keys, out)) if out[8] else None


def _padded(h1: torch.Tensor, pieces: Dict[str, torch.Tensor]) -> torch.Tensor:
    dt = h1.dtype
    c = {name: pieces[name].to(dt) for name in PIECES}
    top = torch.cat([c["top_left"], c["top"], c["top_right"]], dim=2)
    mid = torch.cat([c["left"], h1, c["right"]], dim=2)
    bot = torch.cat([c["bottom_left"], c["bottom"], c["bottom_right"]], dim=2)
    return torch.cat([top, mid, bot], dim=1)            # (K, bs+2, bs+2, Cm)


def bottleneck_tail_plain(h1, x, pieces, w2, s2, b2, w3, s3, b3):
    """Plain version with the kernel's cast order (``bottleneck.py:82-89``):
    fp32 accumulation, cast to the activation dtype, BN multiply and add
    each in that dtype, ReLU; ``w2`` (Cm, Cm, 3, 3), ``w3`` (Co, Cm, 1, 1)."""
    dt = h1.dtype
    full = _padded(h1, pieces).permute(0, 3, 1, 2).float()
    acc = F.conv2d(full, w2.to(dt).float())              # fp32 accumulation
    h2 = acc.permute(0, 2, 3, 1).to(dt) * s2.to(dt) + b2.to(dt)
    h2 = torch.clamp_min(h2, 0)
    y = torch.matmul(h2.float(), w3.to(dt)[:, :, 0, 0].t().float())
    y = y.to(dt) * s3.to(dt) + b3.to(dt)
    y = y + x.to(dt)
    return torch.clamp_min(y, 0)


def bottleneck_tail_strips_plain(h1, x, halo, w2, s2, b2, w3, s3, b3):
    """Plain version of ``bottleneck_tail``: the 8 pieces of ``halo`` (a
    ``StripHalo``) by ``gather_halo_strips_plain``, then
    ``bottleneck_tail_plain``."""
    pieces = gather_halo_strips_plain(halo.strips, halo.idx, halo.pad,
                                      halo.n, halo.gh, halo.gw)
    return bottleneck_tail_plain(h1, x, pieces, w2, s2, b2, w3, s3, b3)


def prepare_tail_weights(w2, s2, b2, w3, s3, b3, dtype=None) -> Tuple:
    """The layouts the kernels read, from the JAX-side ones: ``w2`` (Cm, Cm,
    3, 3) as (3, 3, Cm_out, Cm_in) ([dy][dx][co][ci]: each tap's rows are
    output channels, k-contiguous), ``w3`` (Co, Cm, 1, 1) as (Co, Cm), the
    BN vectors as they are; all in ``dtype`` (``w2``'s by default) and
    contiguous.  Returns ``(w2, s2, b2, w3, s3, b3)``."""
    dt = dtype or w2.dtype
    return (w2.to(dt).permute(2, 3, 0, 1).contiguous(),
            s2.to(dt).contiguous(), b2.to(dt).contiguous(),
            w3.to(dt)[:, :, 0, 0].contiguous(),
            s3.to(dt).contiguous(), b3.to(dt).contiguous())


_prepared: Dict[tuple, tuple] = {}


def prepared_tail_weights(w2, s2, b2, w3, s3, b3, dtype) -> Tuple:
    """``prepare_tail_weights`` once per parameter set and dtype: cached on
    the tensors' identity and ``_version``, so an in-place update of any of
    them prepares the set again."""
    params = (w2, s2, b2, w3, s3, b3)
    key = tuple(id(t) for t in params) + (dtype,)
    versions = tuple(t._version for t in params)
    hit = _prepared.get(key)
    if (hit is not None and hit[1] == versions
            and all(ref() is t for ref, t in zip(hit[0], params))):
        return hit[2]
    for stale in [k for k, (refs, _, _) in _prepared.items()
                  if any(ref() is None for ref in refs)]:
        del _prepared[stale]
    out = prepare_tail_weights(*params, dtype=dtype)
    _prepared[key] = ([weakref.ref(t) for t in params], versions, out)
    return out


def _lib():
    lib = build.library("bottleneck")
    if not getattr(lib, "_typed", False):
        lib.bottleneck_tail.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        lib.bottleneck_tail.restype = ctypes.c_int
        lib.bottleneck_rows_plan.argtypes = [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.bottleneck_rows_plan.restype = None
        lib._typed = True
    return lib


def _expect(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"{dtype} on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def bottleneck_tail(h1, x, halo, w2, s2, b2, w3, s3, b3):
    """Fused tail.  ``h1`` (K, bs, bs, Cm) post-conv1 activations, ``x``
    (K, bs, bs, Co) identity, ``halo`` the ``StripHalo`` of ``h1``'s strip
    exchange at pad 1 (strips ``rows`` (T+1, 2, bs, Cm) and ``cols`` (T+1,
    bs, 2, Cm), the K blocks' indices ``idx``), ``w2`` (Cm, Cm, 3, 3),
    ``w3`` (Co, Cm, 1, 1), BN folded (C,).  Output (K, bs, bs, Co) in
    ``h1.dtype``."""
    if h1.device.type == "cpu":
        return bottleneck_tail_strips_plain(h1, x, halo, w2, s2, b2, w3, s3,
                                            b3)
    return _launch(h1, x, halo, (w2, s2, b2, w3, s3, b3), rows=False)


def _bottleneck_tail_rows(h1, x, halo, w2, s2, b2, w3, s3, b3):
    """``bottleneck_tail`` in bf16 on the row route whatever the block, so
    that ``chip_smoke.py`` can time it at the wgmma route's blocks too.  No
    path of the port calls it."""
    if h1.dtype != torch.bfloat16:
        raise ValueError(f"the row route is bf16, got {h1.dtype}")
    return _launch(h1, x, halo, (w2, s2, b2, w3, s3, b3), rows=True)


def _launch(h1, x, halo, weights, rows):
    dev, dt = h1.device, h1.dtype
    if dev.type != "cuda":
        raise ValueError(f"bottleneck kernel needs CUDA tensors, got {dev}")
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {dt}")
    k, bs, _, cm = h1.shape
    co = x.shape[-1]
    if not kernel_takes(dt, bs, cm, co):
        raise ValueError(f"the {dt} kernel takes Cm and Co multiples of "
                         f"{TILE}, got (bs {bs}, Cm {cm}), Co {co}")
    key = "bottleneck_tail_rows" if rows else route(dt, bs, cm, co)
    if key == "bottleneck_tail_rows" and row_plan(k, bs, cm, co, 1) is None:
        raise ValueError(f"the row route has no plan for (bs {bs}, Cm {cm}) "
                         f"-> Co {co}: bs above 128 or Cm above 1024")
    if halo.pad != 1:
        raise ValueError(f"the tail's halo is at pad 1, got {halo.pad}")
    x = x.to(dt).contiguous()
    strips = {name: t.to(dt).contiguous()
              for name, t in halo.strips.items()}
    w2p, s2p, b2p, w3p, s3p, b3p = prepared_tail_weights(*weights, dt)
    bn = [s2p, b2p, s3p, b3p]
    total = halo.n * halo.gh * halo.gw
    _expect("h1", h1, (k, bs, bs, cm), dt, dev)
    _expect("x", x, (k, bs, bs, co), dt, dev)
    _expect("rows", strips["rows"], (total + 1, 2, bs, cm), dt, dev)
    _expect("cols", strips["cols"], (total + 1, bs, 2, cm), dt, dev)
    _expect("idx", halo.idx, (k,), torch.int64, dev)
    _expect("w2", w2p, (3, 3, cm, cm), dt, dev)
    _expect("w3", w3p, (co, cm), dt, dev)
    for name, v, c in zip(("s2", "b2", "s3", "b3"), bn, (cm, cm, co, co)):
        _expect(name, v, (c,), dt, dev)
    y = torch.empty_like(x)
    # h2 between the two launches of the fp32 route
    scratch = None if key != "bottleneck_tail_f32" else torch.empty(
        (k, bs * bs, cm), dtype=dt, device=dev)
    tensors = [h1, x, strips["rows"], strips["cols"], halo.idx, w2p, w3p,
               *bn, y]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    # the C entry's dtype: 0 fp32; 1 bf16, whose route it picks by the rule
    # of ``route``; 2 bf16 on the row route whatever the block
    code = 0 if dt == torch.float32 else 2 if rows else 1
    err = _lib().bottleneck_tail(
        ptrs, ctypes.c_void_p(0 if scratch is None else scratch.data_ptr()),
        k, bs, cm, co, halo.n, halo.gh, halo.gw, code,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    build.check(err, "bottleneck_tail")
    kernels.launches[key] += 1
    return y
