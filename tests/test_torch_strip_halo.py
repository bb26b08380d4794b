"""The fused tail's halo in strip form, on the CPU, against the JAX package:
``StripHalo.pieces`` bitwise against JAX's ``gather_halo_strips``, the
port's ``bottleneck_tail`` on a ``StripHalo`` against the Pallas
``bottleneck_tail`` (interpret mode) fed JAX's pieces, and
``_fused_bottleneck`` through an ``ExecCtx`` over 2 frames against JAX's,
outputs and carried strip canvases bit for bit.  The CUDA kernel, which
reads the strips in place, is held against the same plain version in
``test_torch_kernels_gpu.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockcopy_tpu.core.blocked as JB
import blockcopy_tpu.models.swiftnet as JS
import blockcopy_tpu_torch.core.blocked as TB
import blockcopy_tpu_torch.models.swiftnet as TS
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.ops.pallas.bottleneck import bottleneck_tail as jtail
from blockcopy_tpu_torch.core import grid as TG
from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
from blockcopy_tpu_torch.utils.convert import params_from_jax
from torch_port_util import assert_close, assert_same, assert_tree, jtree, \
    tol, tt
from torch_port_util import two_torch_threads  # noqa: F401

N, GH, GW = 2, 3, 4
# the JAX side jitted (eager JAX compiles every op)
jgather = jax.jit(JB.gather_halo_strips, static_argnums=(2, 3, 4, 5))


def _halo(rs, bs, c, pad, dtype, relu=False):
    """Random strips of an (N, GH, GW) grid (zero sentinels) and a partial
    grid's indices with 3 padding slots; most executed blocks lie on the
    image's edge.  Returns the numpy strips, JAX's indices and the port's
    ``StripHalo`` of the same values."""
    total = N * GH * GW

    def strip(*shape):
        a = rs.randn(*shape).astype(np.float32)
        a = (np.maximum(a, 0) if relu else a).astype(dtype)
        a[-1] = 0
        return a

    rows = strip(total + 1, 2 * pad, bs, c)
    cols = strip(total + 1, bs, 2 * pad, c)
    grid = rs.rand(N, GH, GW) < 0.6
    grid[0, 0, 0] = grid[1, GH - 1, GW - 1] = True     # two image corners
    jidx = JG.exec_indices(jnp.asarray(grid), int(grid.sum()) + 3)
    halo = TB.StripHalo(rows=tt(rows), cols=tt(cols), idx=tt(jidx).long(),
                        n=N, gh=GH, gw=GW, pad=pad)
    return {"rows": rows, "cols": cols}, jidx, halo


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("pad", [1, 3])
def test_pieces_match_jax(pad, dtype):
    """``StripHalo.pieces`` (the halo kernel's plain version on the CPU)
    equals JAX's ``gather_halo_strips`` bit for bit, in the strips' dtype,
    padding slots and image-edge neighbours reading the zero sentinel."""
    strips, jidx, halo = _halo(np.random.RandomState(pad), 8, 16, pad, dtype)
    ref = jgather({k: jnp.asarray(v) for k, v in strips.items()}, jidx, pad,
                  N, GH, GW)
    launches = dict(kernels.launches)
    got = halo.pieces()
    assert kernels.launches == launches        # CPU: plain version only
    assert all(v.dtype == halo.rows.dtype for v in got.values())
    assert_tree(ref, got, assert_same)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("bs,cm,co", [(8, 128, 256), (4, 128, 512)])
def test_tail_matches_pallas(bs, cm, co, dtype):
    """The port's ``bottleneck_tail`` on a ``StripHalo`` against the Pallas
    ``bottleneck_tail`` (interpret mode) fed JAX's 8 pieces of the same
    strips: within 1e-4 in fp32, 3e-2 in bf16."""
    rs = np.random.RandomState(bs + co)
    strips, jidx, halo = _halo(rs, bs, cm, 1, dtype, relu=True)
    k = halo.idx.shape[0]

    def arr(*shape, relu=False):
        a = rs.randn(*shape).astype(np.float32)
        return (np.maximum(a, 0) if relu else a).astype(dtype)

    h1, x = arr(k, bs, bs, cm, relu=True), arr(k, bs, bs, co)
    w2, w3 = arr(3, 3, cm, cm) * 0.05, arr(cm, co) * 0.05
    s2, b2 = 1 + 0.1 * arr(cm), 0.1 * arr(cm)
    s3, b3 = 1 + 0.1 * arr(co), 0.1 * arr(co)
    pieces = jgather({n: jnp.asarray(v) for n, v in strips.items()}, jidx, 1,
                     N, GH, GW)
    ref = jax.jit(jtail)(jnp.asarray(h1), jnp.asarray(x), pieces,
                         *map(jnp.asarray, (w2, s2, b2, w3, s3, b3)))
    oihw = lambda w: tt(w).permute(3, 2, 0, 1)
    launches = dict(kernels.launches)
    got = BT.bottleneck_tail(tt(h1), tt(x), halo, oihw(w2), tt(s2), tt(b2),
                             oihw(w3[None, None]), tt(s3), tt(b3))
    assert kernels.launches == launches
    assert got.dtype == tt(h1).dtype and got.shape == (k, bs, bs, co)
    assert_close(ref, got, tol(dtype))


def _dyadic_params(cin, planes, seed):
    """Bottleneck parameters on a grid of small dyadic values (weights in
    eighths, BN scales and biases in quarters): with the frames' small
    integers every sum of products is exact in fp32 whatever its order, so
    the two packages' results agree bit for bit."""
    rs = np.random.RandomState(seed)

    def conv(kh, kw, ci, co):
        return {"w": jnp.asarray(rs.randint(-1, 2, (kh, kw, ci, co))
                                 .astype(np.float32) / 8)}

    def bn(c):
        return {"scale": jnp.asarray(rs.randint(2, 6, c)
                                     .astype(np.float32) / 4),
                "bias": jnp.asarray(rs.randint(-2, 3, c)
                                    .astype(np.float32) / 4)}

    return {"conv1": conv(1, 1, cin, planes), "bn1": bn(planes),
            "conv2": conv(3, 3, planes, planes), "bn2": bn(planes),
            "conv3": conv(1, 1, planes, cin), "bn3": bn(cin)}


def _fused_frame(S, G, B, to, params, frame, grid, canvases, cap, building,
                 n, gh, gw):
    idx = G.exec_indices(to(grid), cap)
    ctx = B.ExecCtx.blocked(idx, n, gh, gw, canvases, building=building)
    out = S._fused_bottleneck(ctx, "bn", B.split_dense(to(frame), idx, n, gh,
                                                       gw), params)
    return out.data, ctx.canvases


def _fused_clip(pkg, params, frames, grids, n, gh, gw):
    """``_fused_bottleneck`` over a clip, frame 1 building the canvases:
    the output and a copy of the carried strips after every frame.  JAX's
    frame is jitted."""
    step = functools.partial(_fused_frame, *pkg)
    if pkg[0] is JS:
        step = jax.jit(step, static_argnames=("cap", "building", "n", "gh",
                                              "gw"))
    outs, kept, canvases = [], [], {}
    for t, (frame, grid) in enumerate(zip(frames, grids)):
        out, canvases = step(params, frame, grid, canvases,
                             cap=int(grid.sum()) + (t > 0),
                             building=t == 0, n=n, gh=gh, gw=gw)
        outs.append(out)
        kept.append({k: np.array(v) if not isinstance(v, torch.Tensor)
                     else v.clone() for k, v in canvases["bn.conv2"].items()})
    return outs, kept


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_fused_bottleneck_clip_matches_jax(dtype, monkeypatch):
    """``_fused_bottleneck`` over 2 frames (every block, then a partial grid
    with a padding slot) through an ``ExecCtx``, the port's reading its halo
    as a ``StripHalo`` from the strips it just scattered, against JAX's
    (exchange_pieces, then the Pallas tail): outputs and the carried strip
    canvases equal bit for bit."""
    n, gh, gw, bs, cin, planes = 1, 2, 3, 8, 128, 128
    rs = np.random.RandomState(4)
    frames = [rs.randint(-2, 3, (n, gh * bs, gw * bs, cin)).astype(dtype)
              for _ in range(2)]
    grids = [np.ones((n, gh, gw), bool), np.zeros((n, gh, gw), bool)]
    grids[1][0, 0, 1] = grids[1][0, 1, 2] = True
    jp = jax.tree.map(lambda a: a.astype(dtype), _dyadic_params(cin, planes,
                                                                5))
    tp = params_from_jax(jtree(jp), device="cpu")
    monkeypatch.setattr(JB, "HALO_IMPL", "strips")
    monkeypatch.setattr(TB, "HALO_IMPL", "strips")
    ref, ref_strips = _fused_clip((JS, JG, JB, jnp.asarray), jp, frames,
                                  grids, n, gh, gw)
    launches = dict(kernels.launches)
    got, got_strips = _fused_clip((TS, TG, TB, tt), tp, frames, grids, n, gh,
                                  gw)
    assert kernels.launches == launches
    for t in range(2):
        assert_same(ref[t], got[t], msg=f"frame {t + 1}")
        assert_tree(ref_strips[t], got_strips[t], assert_same)


def test_exchange_strips_is_the_exchange_state(monkeypatch):
    """``exchange_strips`` scatters what ``exchange`` scatters and hands
    back the canvas's own strips (no copy) with the context's grid and the
    blocks' indices; ``exchange_pieces`` is its pieces; under a full-canvas
    mode it returns None."""
    rs = np.random.RandomState(6)
    n, gh, gw, bs = 1, 2, 3, 4
    frame = tt(rs.randn(n, gh * bs, gw * bs, 8).astype(np.float32))
    idx = TG.exec_indices(torch.tensor([[[True, False, True],
                                         [False, True, False]]]), 4)
    pack = TB.split_dense(frame, idx, n, gh, gw)
    monkeypatch.setattr(TB, "HALO_IMPL", "strips")
    a = TB.ExecCtx.blocked(idx, n, gh, gw, {}, building=True)
    b = TB.ExecCtx.blocked(idx, n, gh, gw, {}, building=True)
    halo = a.exchange_strips("c", pack, 2)
    padded = b.exchange("c", pack, 2)
    assert halo.rows is a.canvases["c"]["rows"]
    assert halo.cols is a.canvases["c"]["cols"]
    assert (halo.n, halo.gh, halo.gw, halo.pad) == (n, gh, gw, 2)
    assert halo.idx is idx
    assert_tree(b.canvases["c"], a.canvases["c"], assert_same)
    pieces = halo.pieces()
    assert_same(padded[:, :2, 2:-2], pieces["top"])
    assert_same(padded[:, 2:-2, -2:], pieces["right"])
    assert_tree(pieces, a.exchange_pieces("c", pack, 2), assert_same)
    monkeypatch.setattr(TB, "HALO_IMPL", "full")
    assert a.exchange_strips("d", pack, 1) is None
