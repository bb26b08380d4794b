"""Bottleneck-tail kernel module: the plain version held against the Pallas
``bottleneck_tail`` (interpret mode), and the port's fused block against the
JAX unfused path over 3-frame partial-grid clips.  The CUDA kernel is held
against the plain version in ``test_torch_kernels_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockcopy_tpu.models.swiftnet as JS
import blockcopy_tpu_torch.models.swiftnet as TS
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.core.blocked import ExecCtx as JCtx, split_dense as jsplit
from blockcopy_tpu.ops.pallas.bottleneck import bottleneck_tail as jtail
from blockcopy_tpu_torch.core import grid as TG
from blockcopy_tpu_torch.core.blocked import ExecCtx as TCtx
from blockcopy_tpu_torch.core.blocked import split_dense as tsplit
from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
from blockcopy_tpu_torch.utils.convert import params_from_jax
from torch_port_util import (assert_close, assert_same, assert_tree, jtree,
                             tol, tt)
from torch_port_util import two_torch_threads  # noqa: F401


def bottleneck_params(cin, planes, seed=0):
    """The JAX suite's bottleneck parameters (test_fused_bottleneck.py)."""
    rs = np.random.RandomState(seed)

    def conv(kh, kw, ci, co):
        return {"w": jnp.asarray(rs.randn(kh, kw, ci, co).astype(np.float32)
                                 * 0.1)}

    def bn(c):
        return {"scale": jnp.asarray(1.0 + 0.1 * rs.randn(c)
                                     .astype(np.float32)),
                "bias": jnp.asarray(0.1 * rs.randn(c).astype(np.float32))}

    return {"conv1": conv(1, 1, cin, planes), "bn1": bn(planes),
            "conv2": conv(3, 3, planes, planes), "bn2": bn(planes),
            "conv3": conv(1, 1, planes, cin), "bn3": bn(cin)}


PIECE_SHAPES = {"top": (1, "bs"), "bottom": (1, "bs"), "left": ("bs", 1),
                "right": ("bs", 1)}


def _tail_inputs(rs, k, bs, cm, co, dtype):
    def arr(*shape, relu=False):
        a = rs.randn(*shape).astype(np.float32)
        return (np.maximum(a, 0) if relu else a).astype(dtype)

    pieces = {}
    for name in BT.PIECES:
        hw = [bs if d == "bs" else d for d in PIECE_SHAPES.get(name, (1, 1))]
        pieces[name] = arr(k, *hw, cm, relu=True)
    return (arr(k, bs, bs, cm, relu=True), arr(k, bs, bs, co), pieces,
            arr(3, 3, cm, cm) * 0.05, 1 + 0.1 * arr(cm), 0.1 * arr(cm),
            arr(cm, co) * 0.05, 1 + 0.1 * arr(co), 0.1 * arr(co))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("bs", [8, 16])
def test_plain_matches_pallas(bs, dtype):
    rs = np.random.RandomState(bs)
    h1, x, pieces, w2, s2, b2, w3, s3, b3 = _tail_inputs(rs, 4, bs, 128,
                                                         256, dtype)
    ref = jtail(jnp.asarray(h1), jnp.asarray(x),
                {k: jnp.asarray(v) for k, v in pieces.items()},
                *map(jnp.asarray, (w2, s2, b2, w3, s3, b3)))
    oihw = lambda w: tt(w).permute(3, 2, 0, 1)
    got = BT.bottleneck_tail(tt(h1), tt(x), {k: tt(v) for k, v in
                                             pieces.items()},
                             oihw(w2), tt(s2), tt(b2),
                             oihw(w3[None, None]), tt(s3), tt(b3))
    assert got.dtype == tt(h1).dtype
    assert_close(ref, got, tol(dtype))


def _plain_prepared(h1, x, pieces, prep):
    """The tail computed from the prepared layouts, read as the kernel reads
    them: w2 [dy][dx][co][ci] tap by tap, w3 (Co, Cm); cast order of
    ``bottleneck.py:82-89``."""
    w2p, s2, b2, w3p, s3, b3 = prep
    dt, (k, bs, _, cm) = h1.dtype, h1.shape
    full = BT._padded(h1, pieces).float()                # (K, bs+2, bs+2, Cm)
    acc = torch.zeros((k, bs, bs, cm))
    for dy in range(3):
        for dx in range(3):
            acc += full[:, dy:dy + bs, dx:dx + bs] @ w2p[dy, dx].float().t()
    h2 = torch.clamp_min(acc.to(dt) * s2 + b2, 0)
    y = (h2.float() @ w3p.float().t()).to(dt) * s3 + b3
    return torch.clamp_min(y + x, 0)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_prepared_weights_round_trip(dtype):
    """``prepare_tail_weights`` lays out w2 as [dy][dx][co][ci] and w3 as
    (Co, Cm): undoing the layouts gives the JAX-side (HWIO) weights back,
    bit for bit, and the BN vectors unchanged."""
    rs = np.random.RandomState(3)
    _, _, _, w2, s2, b2, w3, s3, b3 = _tail_inputs(rs, 1, 8, 128, 256, dtype)
    oihw = lambda w: tt(w).permute(3, 2, 0, 1)
    prep = BT.prepare_tail_weights(oihw(w2), tt(s2), tt(b2),
                                   oihw(w3[None, None]), tt(s3), tt(b3))
    w2p, s2p, b2p, w3p, s3p, b3p = prep
    assert all(t.is_contiguous() and t.dtype == tt(w2).dtype for t in prep)
    assert w2p.shape == (3, 3, 128, 128) and w3p.shape == (256, 128)
    assert_same(w2, w2p.permute(0, 1, 3, 2))             # back to HWIO
    assert_same(w3, w3p.t())
    for ref, got in zip((s2, b2, s3, b3), (s2p, b2p, s3p, b3p)):
        assert_same(ref, got)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("bs", [8, 16])
def test_prepared_reader_matches_plain_and_pallas(bs, dtype):
    """A plain reader of the prepared layouts equals ``bottleneck_tail_plain``
    and, through it, the Pallas ``bottleneck_tail`` in interpret mode."""
    rs = np.random.RandomState(bs + 1)
    h1, x, pieces, w2, s2, b2, w3, s3, b3 = _tail_inputs(rs, 3, bs, 128,
                                                         256, dtype)
    ref = jtail(jnp.asarray(h1), jnp.asarray(x),
                {k: jnp.asarray(v) for k, v in pieces.items()},
                *map(jnp.asarray, (w2, s2, b2, w3, s3, b3)))
    oihw = lambda w: tt(w).permute(3, 2, 0, 1)
    tpieces = {k: tt(v) for k, v in pieces.items()}
    weights = (oihw(w2), tt(s2), tt(b2), oihw(w3[None, None]), tt(s3),
               tt(b3))
    got = _plain_prepared(tt(h1), tt(x), tpieces,
                          BT.prepare_tail_weights(*weights))
    plain = BT.bottleneck_tail_plain(tt(h1), tt(x), tpieces, *weights)
    assert_close(plain, got, tol(dtype))
    assert_close(ref, got, tol(dtype))


def test_prepared_cache_follows_in_place_updates(monkeypatch):
    """``prepared_tail_weights`` prepares a parameter set once; an in-place
    update of any of its tensors, or another dtype, prepares it again."""
    calls = []
    real = BT.prepare_tail_weights
    monkeypatch.setattr(BT, "prepare_tail_weights",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(BT, "_prepared", {})
    rs = np.random.RandomState(5)
    _, _, _, w2, s2, b2, w3, s3, b3 = _tail_inputs(rs, 1, 8, 128, 256,
                                                   np.float32)
    params = [tt(w2).permute(3, 2, 0, 1), tt(s2), tt(b2),
              tt(w3[None, None]).permute(3, 2, 0, 1), tt(s3), tt(b3)]
    first = BT.prepared_tail_weights(*params, torch.float32)
    again = BT.prepared_tail_weights(*params, torch.float32)
    assert len(calls) == 1 and all(a is b for a, b in zip(first, again))
    params[0].mul_(2.0)                       # in place: w2's version moves
    updated = BT.prepared_tail_weights(*params, torch.float32)
    assert len(calls) == 2
    assert torch.equal(updated[0], first[0] * 2.0)
    params[4].add_(1.0)
    BT.prepared_tail_weights(*params, torch.float32)
    BT.prepared_tail_weights(*params, torch.bfloat16)
    assert len(calls) == 4
    BT.prepared_tail_weights(*params, torch.float32)
    BT.prepared_tail_weights(*params, torch.bfloat16)
    assert len(calls) == 4


def _run(pkg, fused, frames, grids, params, n=1, gh=2, gw=4):
    """One bottleneck over a clip: outputs and strip canvases per frame."""
    S, G, Ctx, split, to = pkg
    old = S.FUSED_BOTTLENECK
    S.FUSED_BOTTLENECK = fused
    try:
        outs, canv = [], []
        canvases = {}
        for t, (frame, grid) in enumerate(zip(frames, grids)):
            idx = G.exec_indices(to(grid), int(grid.sum()))
            ctx = Ctx.blocked(idx, n, gh, gw, canvases, building=t == 0)
            out = S._bottleneck_block(ctx, "bn", split(to(frame), idx, n, gh,
                                                        gw), params, stride=1)
            outs.append(out.data)
            canvases = ctx.canvases
            canv.append({k: np.array(v) if not isinstance(v, torch.Tensor)
                         else v.clone() for k, v in canvases["bn.conv2"]
                         .items()})
        return outs, canv
    finally:
        S.FUSED_BOTTLENECK = old


JAX = (JS, JG, JCtx, jsplit, jnp.asarray)
PORT = (TS, TG, TCtx, tsplit, tt)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("bs", [8, 16])
def test_fused_block_matches_jax_unfused(bs, dtype):
    n, gh, gw = 1, 2, 4
    cin, planes = 256, 128
    rs = np.random.RandomState(0)
    frames = [rs.randn(n, gh * bs, gw * bs, cin).astype(dtype)
              for _ in range(3)]
    grids = [np.ones((n, gh, gw), bool), np.zeros((n, gh, gw), bool),
             np.zeros((n, gh, gw), bool)]
    grids[1][0, 0, ::2] = grids[1][0, 1, 1] = True
    grids[2][0, 1, :] = True
    jp = bottleneck_params(cin, planes)
    tp = params_from_jax(jtree(jp), device="cpu")

    ref, ref_canv = _run(JAX, False, frames, grids, jp)
    launches = dict(kernels.launches)
    got, got_canv = _run(PORT, True, frames, grids, tp)
    unfused, unfused_canv = _run(PORT, False, frames, grids, tp)
    assert kernels.launches == launches    # CPU: plain version only
    for t in range(3):
        assert_close(ref[t], got[t], tol(dtype), msg=f"frame {t}")
        # the same strips whichever path runs the tail
        assert_tree(unfused_canv[t], got_canv[t], assert_same)
        assert_tree(ref_canv[t], got_canv[t],
                    lambda a, b, m: assert_close(a, b, tol(dtype), msg=m))


@pytest.mark.parametrize("planes,fused", [(64, False), (128, True)])
def test_gate(planes, fused, monkeypatch):
    """The default gate fuses stride-1 identity bottlenecks of 128-aligned
    width only (planes 64, RN50 layer1, stays unfused), and never in the
    building pass."""
    n, gh, gw, bs = 1, 2, 2, 8
    rs = np.random.RandomState(1)
    frame = torch.from_numpy(rs.randn(n, gh * bs, gw * bs, 4 * planes)
                             .astype(np.float32))
    p = params_from_jax(jtree(bottleneck_params(4 * planes, planes)),
                        device="cpu")
    calls = []
    monkeypatch.setattr(TS, "bottleneck_tail",
                        lambda h1, x, *a: calls.append(1) or x)
    monkeypatch.setattr(TS, "FUSED_BOTTLENECK", None)   # port default: on
    idx = TG.exec_indices(torch.ones((n, gh, gw), dtype=torch.bool), gh * gw)
    pack = tsplit(frame, idx, n, gh, gw)
    ctx = TCtx.blocked(idx, n, gh, gw, {}, building=True)
    TS._bottleneck_block(ctx, "bn", pack, p, stride=1)
    assert not calls
    ctx.building = False
    out = TS._bottleneck_block(ctx, "bn", pack, p, stride=1)
    assert out.data.shape == (gh * gw, bs, bs, 4 * planes)
    assert calls == ([1] if fused else [])
