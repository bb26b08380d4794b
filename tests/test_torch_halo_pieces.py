"""The halo kernel's ``halo_pieces`` entry and the bf16 row route's launch
plan, on the CPU: the entry's plain version bitwise against JAX's
``gather_halo_strips``, ``ExecCtx.exchange_pieces`` through the entry over a
3-frame clip against JAX's, and ``row_plan`` over every shape and capacity
``chip_smoke.py`` phase 3 runs."""

import jax.numpy as jnp
import numpy as np
import pytest

import blockcopy_tpu.core.blocked as JB
import blockcopy_tpu_torch.core.blocked as TB
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu_torch.core import grid as TG
from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
from blockcopy_tpu_torch.ops.kernels import halo as H
from torch_port_util import assert_same, assert_tree, npf, tt
from torch_port_util import two_torch_threads  # noqa: F401


def _strips(rs, total, bs, c, p, dtype):
    """Random strip storage of ``total`` blocks with its zero sentinel."""
    rows = rs.randn(total + 1, 2 * p, bs, c).astype(dtype)
    cols = rs.randn(total + 1, bs, 2 * p, c).astype(dtype)
    rows[-1] = 0
    cols[-1] = 0
    return rows, cols


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("pad", [1, 3])
def test_halo_pieces_plain_matches_jax(pad, dtype):
    """Two batch images on a partial 3x4 grid, 3 padding slots: every piece
    equal bit for bit, in the strips' dtype."""
    rs = np.random.RandomState(pad)
    n, gh, gw, bs, c = 2, 3, 4, 8, 16
    rows, cols = _strips(rs, n * gh * gw, bs, c, pad, dtype)
    grid = rs.rand(n, gh, gw) < 0.5
    jidx = JG.exec_indices(jnp.asarray(grid), int(grid.sum()) + 3)
    tidx = tt(jidx).long()
    ref = JB.gather_halo_strips({"rows": jnp.asarray(rows),
                                 "cols": jnp.asarray(cols)}, jidx, pad, n,
                                gh, gw)
    got = H.halo_pieces({"rows": tt(rows), "cols": tt(cols)}, tidx, pad, n,
                        gh, gw)
    assert set(got) == set(H.PIECES)
    assert all(v.dtype == tt(rows).dtype for v in got.values())
    assert_tree(ref, got, assert_same)


def _pieces_clip(B, G, to, frames, grids, pad, n, gh, gw):
    """``exchange_pieces`` over a clip: the pieces and a snapshot of the
    carried strip canvases after every frame."""
    old = B.HALO_IMPL
    B.HALO_IMPL = "strips"
    try:
        outs, states, canvases = [], [], {}
        for t, (frame, grid) in enumerate(zip(frames, grids)):
            idx = G.exec_indices(to(grid), int(grid.sum()) + 2)
            ctx = B.ExecCtx.blocked(idx, n, gh, gw, canvases,
                                    building=t == 0)
            pack = B.split_dense(to(frame), idx, n, gh, gw)
            outs.append(ctx.exchange_pieces("c", pack, pad))
            canvases = ctx.canvases
            states.append({k: np.array(npf(v))
                           for k, v in canvases["c"].items()})
        return outs, states
    finally:
        B.HALO_IMPL = old


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("pad", [1, 3])
def test_exchange_pieces_clip_matches_jax(pad, dtype):
    """Frame 1 executes every block, frames 2-3 a partial grid with 2
    padding slots: the pieces come from this frame's strips where the
    neighbour ran, the carried ones elsewhere; both equal JAX's bit for
    bit, the carried canvases too."""
    rs = np.random.RandomState(10 + pad)
    n, gh, gw, bs, c = 2, 3, 4, 8, 16
    frames = [rs.randn(n, gh * bs, gw * bs, c).astype(dtype)
              for _ in range(3)]
    grids = [np.ones((n, gh, gw), bool)]
    grids += [rs.rand(n, gh, gw) < 0.4 for _ in range(2)]
    ref, ref_state = _pieces_clip(JB, JG, jnp.asarray, frames, grids, pad, n,
                                  gh, gw)
    got, got_state = _pieces_clip(TB, TG, tt, frames, grids, pad, n, gh, gw)
    for t in range(3):
        assert_tree(ref[t], got[t], assert_same)
        assert_tree(ref_state[t], got_state[t], assert_same)


# chip_smoke.py phase 3's row-route shapes: RN50 at block 256,
# wide_resnet50_2 at block 128, Co 640, and the wgmma route's blocks (the
# row route forced there)
PLAN_SHAPES = [(32, 128, 512), (16, 256, 1024), (8, 512, 2048),
               (32, 128, 256), (16, 256, 512), (8, 512, 1024),
               (16, 128, 640), (16, 128, 512), (8, 256, 1024), (8, 128, 512)]


@pytest.mark.parametrize("bs,cm,co", PLAN_SHAPES)
@pytest.mark.parametrize("k", [1, 2, 16, 32, 64, 128])
def test_row_plan(k, bs, cm, co):
    """A plan exists (every one fuses the 1x1 stage) within the card's
    232,448 bytes of shared memory; its bands tile each block's rows
    exactly and hold at most its m64 tiles' rows; its cluster splits h2's
    and y's channels evenly; its launch fills the 132 SMs (all but an
    eighth) where the shortest bands and the widest cluster could."""
    sms = 132
    plan = BT.row_plan(k, bs, cm, co, sms)
    assert plan is not None
    assert plan["smem"] <= 232448
    rows, bands = plan["rows"], plan["bands"]
    assert rows * bs <= 64 * plan["mt"]
    assert (bands - 1) * rows < bs <= bands * rows
    covered = sum(min(rows, bs - b * rows) * bs for b in range(bands))
    assert k * covered == k * bs * bs
    cs = plan["cs"]
    assert cs in (1, 2, 4) and cm % (64 * cs) == 0 and co % (64 * cs) == 0
    assert plan["np"] in (64, 128, 256) and plan["np"] <= cm // cs
    widest = max(c for c in (1, 2, 4)
                 if cm % (64 * c) == 0 and co % (64 * c) == 0)
    most = k * -(-bs // max(1, 64 // bs)) * widest
    assert k * bands * cs >= min(most, sms - sms // 8), plan
