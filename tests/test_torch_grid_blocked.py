"""Port of core/grid.py and core/blocked.py held bitwise against the JAX
package: index maths, split/scatter, strips, halo gathers and the exchange
over 3-frame partial-grid clips (canvases compared every frame)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockcopy_tpu.core.blocked as JB
import blockcopy_tpu_torch.core.blocked as TB
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu_torch.core import grid as TG
from torch_port_util import assert_same, assert_tree, npf, tt
from torch_port_util import two_torch_threads  # noqa: F401


def _grids(rs, n, gh, gw, count):
    return [rs.rand(n, gh, gw) < q for q in np.linspace(0.0, 1.0, count)]


@pytest.mark.parametrize("n", [1, 2])
def test_grid_functions(n):
    rs = np.random.RandomState(n)
    gh, gw = 3, 5
    total = n * gh * gw
    assert TG.grid_shape(96, 160, 32) == JG.grid_shape(96, 160, 32)
    assert TG.num_blocks(n, gh, gw) == JG.num_blocks(n, gh, gw) == total
    with pytest.raises(ValueError):
        TG.grid_shape(100, 160, 32)
    # JAX's side jitted per capacity (eager JAX compiles every op)
    jexec = jax.jit(JG.exec_indices, static_argnums=1)
    jneigh = jax.jit(JG.neighbor_indices, static_argnums=(1, 2, 3))
    for grid in _grids(rs, n, gh, gw, 7):
        count = int(grid.sum())
        for cap in {max(count, 1), count + 3, total, total + 2}:
            ref = jexec(jnp.asarray(grid), cap)
            got = TG.exec_indices(torch.from_numpy(grid), cap)
            assert got.dtype == torch.int64
            assert_same(ref, got, f"cap {cap}")
            assert_same(jneigh(ref, n, gh, gw),
                        TG.neighbor_indices(got, n, gh, gw))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_layout_split_scatter(dtype):
    rs = np.random.RandomState(0)
    n, gh, gw, bs, c = 2, 2, 3, 4, 5
    x = rs.randn(n, gh * bs, gw * bs, c).astype(dtype)
    assert_same(JB.dense_to_block_layout(jnp.asarray(x), gh, gw),
                TB.dense_to_block_layout(tt(x), gh, gw))
    grid = np.zeros((n, gh, gw), bool)
    grid[0, 1, ::2] = grid[1, 0, 1] = True
    jidx = JG.exec_indices(jnp.asarray(grid), 5)      # 2 padding slots
    tidx = tt(jidx).long()
    jpack = JB.split_dense(jnp.asarray(x), jidx, n, gh, gw)
    tpack = TB.split_dense(tt(x), tidx, n, gh, gw)
    assert_same(jpack.data, tpack.data)
    canvas = rs.randn(n * gh * gw + 1, bs, bs, c).astype(dtype)
    canvas[-1] = 0
    jc = JB.scatter_pack(jnp.asarray(canvas), jpack)
    tc = TB.scatter_pack(tt(canvas), tpack)
    assert_same(jc, tc)
    assert_same(JB.block_layout_to_dense(jc, n, gh, gw),
                TB.block_layout_to_dense(tc, n, gh, gw))
    for p in (1, 2):
        js = JB.scatter_strips(JB.alloc_strip_canvas(n, gh, gw, bs, c, p,
                                                     dtype), jpack, p)
        ts = TB.scatter_strips(TB.alloc_strip_canvas(
            n, gh, gw, bs, c, p, tpack.data.dtype, "cpu"), tpack, p)
        assert_tree(js, ts, assert_same)
        assert_tree(JB.gather_halo_strips(js, jidx, p, n, gh, gw),
                    TB.gather_halo_strips(ts, tidx, p, n, gh, gw),
                    assert_same)
        assert_same(JB.halo_gather(jc, jidx, p, n, gh, gw),
                    TB.halo_gather(tc, tidx, p, n, gh, gw))


def _snap(tree):
    """Copy of a canvas tree as fp32 numpy (torch canvases change in place)."""
    if isinstance(tree, dict):
        return {k: _snap(v) for k, v in tree.items()}
    return np.array(npf(tree))


def _clip_frame(B, G, to, pad, n, gh, gw, form, frame, grid, canvases,
                cap, building):
    idx = G.exec_indices(to(grid), cap)
    ctx = B.ExecCtx.blocked(idx, n, gh, gw, canvases, building=building)
    pack = B.split_dense(to(frame), idx, n, gh, gw)
    if form == "padded":
        exchange = ctx.exchange
    elif form == "pieces" or B is JB:
        exchange = ctx.exchange_pieces
    else:       # the port's strip form, gathered: JAX's exchange_pieces
        exchange = lambda *a: ctx.exchange_strips(*a).pieces()
    return exchange("c", pack, pad), ctx.canvases


def _run_clip(B, G, to, impl, frames, grids, pad, n, gh, gw, form):
    """Exchange (padded, pieces, or the port's ``exchange_strips`` then
    ``StripHalo.pieces``) over a clip through one package; JAX's frame
    jitted, traced with the mode set (eager JAX compiles every op)."""
    step = functools.partial(_clip_frame, B, G, to, pad, n, gh, gw, form)
    if B is JB:
        step = jax.jit(step, static_argnames=("cap", "building"))
    old = B.HALO_IMPL
    B.HALO_IMPL = impl
    try:
        outs, states = [], []
        canvases = {}
        for t, (frame, grid) in enumerate(zip(frames, grids)):
            out, canvases = step(frame, grid, canvases,
                                 cap=int(grid.sum()) + 1, building=t == 0)
            outs.append(out)
            states.append(_snap(canvases))
        return outs, states
    finally:
        B.HALO_IMPL = old


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("pad", [1, 3])
@pytest.mark.parametrize("impl,form", [("strips", "padded"),
                                       ("strips", "pieces"),
                                       ("strips", "strip_halo"),
                                       ("full", "padded"),
                                       ("pallas", "padded")])
def test_exchange_clip(impl, form, pad, dtype):
    n, gh, gw, bs, c = 2, 3, 4, 8, 16
    rs = np.random.RandomState(pad)
    frames = [rs.randn(n, gh * bs, gw * bs, c).astype(dtype)
              for _ in range(3)]
    grids = [np.ones((n, gh, gw), bool)]
    grids += [rs.rand(n, gh, gw) < 0.4 for _ in range(2)]
    ref, ref_state = _run_clip(JB, JG, jnp.asarray, impl, frames, grids, pad, n,
                               gh, gw, form)
    got, got_state = _run_clip(TB, TG, tt, impl, frames, grids, pad, n,
                               gh, gw, form)
    for t in range(3):
        assert_tree(ref[t], got[t], assert_same)
        assert_tree(ref_state[t], got_state[t], assert_same)


def test_exchange_pieces_none_under_canvas_modes(monkeypatch):
    monkeypatch.setattr(TB, "HALO_IMPL", "full")
    idx = torch.arange(2)
    ctx = TB.ExecCtx.blocked(idx, 1, 1, 2, {}, building=True)
    pack = TB.split_dense(torch.zeros(1, 4, 8, 3), idx, 1, 1, 2)
    assert ctx.exchange_pieces("c", pack, 1) is None


def test_missing_canvas_and_reused_name():
    idx = torch.arange(2)
    pack = TB.split_dense(torch.zeros(1, 4, 8, 3), idx, 1, 1, 2)
    ctx = TB.ExecCtx.blocked(idx, 1, 1, 2, {})
    with pytest.raises(KeyError, match="op sequence"):
        ctx.exchange("never_built", pack, 1)
    with pytest.raises(KeyError):
        ctx.store_dense("never_built", pack)
    ctx = TB.ExecCtx.blocked(idx, 1, 1, 2, {}, building=True)
    ctx.store_dense("out", pack)
    with pytest.raises(ValueError, match="already stored"):
        ctx.store_dense("out", pack)


def test_store_dense_does_not_alias_canvas():
    """With one block column the dense rebuild would be a view of the
    canvas, which the next frame updates in place."""
    idx = torch.arange(2)
    canvases, outs = {}, []
    for t in range(2):
        ctx = TB.ExecCtx.blocked(idx, 1, 2, 1, canvases, building=t == 0)
        pack = TB.split_dense(torch.full((1, 8, 4, 3), float(t)), idx, 1, 2,
                              1)
        outs.append(ctx.store_dense("out", pack))
        canvases = ctx.canvases
    assert float(outs[0].abs().max()) == 0.0
    assert float(outs[1].min()) == 1.0
