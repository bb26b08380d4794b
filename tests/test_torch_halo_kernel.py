"""Halo-gather kernel module: both plain versions held bitwise against
``halo_gather``, ``halo_gather_strips`` and the Pallas ``halo_gather_pallas``
(interpret mode), and the inputs gathered in ``halo_plan``'s order as the
CUDA kernel addresses them against JAX's two.  The CUDA kernel is held
against the plain versions in ``test_torch_kernels_gpu.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blockcopy_tpu.core import blocked as JB
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.ops.pallas.halo import halo_gather_pallas
from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import halo as H
from test_torch_halo_plan import gather_by_plan
from torch_port_util import assert_same, tt
from torch_port_util import two_torch_threads  # noqa: F401


def _case(pad, partial, dtype, n=1, gh=3, gw=4, bs=8, c=16, seed=0):
    rs = np.random.RandomState(seed)
    prev = jnp.asarray(rs.randn(n, gh * bs, gw * bs, c).astype(dtype))
    cur = jnp.asarray(rs.randn(n, gh * bs, gw * bs, c).astype(dtype))
    return _jax_case(prev, cur, pad, partial, n, gh, gw) + ((n, gh, gw),)


# JAX jitted (eager JAX compiles every op)
@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _jax_case(prev, cur, pad, partial, n, gh, gw):
    bs, c = prev.shape[1] // gh, prev.shape[-1]
    total = n * gh * gw
    idx_all = JG.exec_indices(jnp.ones((n, gh, gw), bool), total)
    canvas = JB.scatter_pack(JB.alloc_canvas(n, gh, gw, bs, c, prev.dtype),
                             JB.split_dense(prev, idx_all, n, gh, gw))
    strips = JB.scatter_strips(
        JB.alloc_strip_canvas(n, gh, gw, bs, c, pad, prev.dtype),
        JB.split_dense(prev, idx_all, n, gh, gw), pad)
    if partial:
        grid = jnp.zeros((n, gh, gw), bool).at[0, ::2, 1::2].set(True)
        idx = JG.exec_indices(grid, 6)               # with padding slots
    else:
        idx = idx_all
    pack = JB.split_dense(cur, idx, n, gh, gw)
    canvas = JB.scatter_pack(canvas, pack)
    strips = JB.scatter_strips(strips, pack, pad)
    return canvas, strips, idx, pack.data


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("pad", [1, 3])
def test_plain_versions_match_jax(pad, partial, dtype):
    canvas, strips, idx, center, geo = _case(pad, partial, dtype)
    static = (2, 3, 4, 5)
    ref = jax.jit(JB.halo_gather, static_argnums=static)(
        canvas, idx, pad, *geo, center=center)
    assert_same(ref, jax.jit(JB.halo_gather_strips, static_argnums=static)(
        strips, idx, pad, *geo, center))
    assert_same(ref, jax.jit(halo_gather_pallas, static_argnums=static)(
        canvas, idx, pad, *geo, center))
    tidx = tt(idx).long()
    tstrips = {k: tt(v) for k, v in strips.items()}
    before = dict(kernels.launches)
    assert_same(ref, H.halo_gather_canvas_plain(tt(canvas), tidx, pad, *geo,
                                                center=tt(center)))
    assert_same(ref, H.halo_gather_strips_plain(tstrips, tidx, pad, *geo,
                                                tt(center)))
    # CPU tensors: the wrappers take the plain versions and launch nothing
    assert_same(ref, H.halo_gather_canvas(tt(canvas), tidx, pad, *geo,
                                          tt(center)))
    assert_same(ref, H.halo_gather_strips(tstrips, tidx, pad, *geo,
                                          tt(center)))
    assert kernels.launches == before


def test_strip_width_must_match_pad():
    _, strips, idx, center, geo = _case(1, True, np.float32)
    with pytest.raises(ValueError, match="strip width"):
        H.halo_gather_strips_plain({k: tt(v) for k, v in strips.items()},
                                   tt(idx).long(), 2, *geo, tt(center))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("c", [5, 256])
@pytest.mark.parametrize("pad", [1, 2, 3])
def test_plan_order_matches_jax(pad, c, dtype):
    """The canvas and the strips gathered piece by piece in the order of
    ``halo_plan`` at 1, 3 and 132 SMs (the kernel's three segments a padded
    row; at C = 256 rows cut into pieces, at C = 5 its 2- or 4-byte units),
    bitwise against JAX's ``halo_gather`` and ``halo_gather_strips`` on a
    partial grid with padding slots."""
    canvas, strips, idx, center, geo = _case(pad, True, dtype, c=c, seed=pad)
    static = (2, 3, 4, 5)
    ref = jax.jit(JB.halo_gather, static_argnums=static)(
        canvas, idx, pad, *geo, center=center)
    assert_same(ref, jax.jit(JB.halo_gather_strips, static_argnums=static)(
        strips, idx, pad, *geo, center))
    tcenter, tidx = tt(center), tt(idx).long()
    for sms in (1, 3, 132):
        plan = H.halo_plan(tidx.shape[0], 8, c * tcenter.element_size(), pad,
                           sms)
        for store in (tt(canvas), {k: tt(v) for k, v in strips.items()}):
            assert_same(ref, gather_by_plan(plan, store, tcenter, tidx, pad,
                                            *geo))
