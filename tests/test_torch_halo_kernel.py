"""Halo-gather kernel module: both plain versions held bitwise against
``halo_gather``, ``halo_gather_strips`` and the Pallas ``halo_gather_pallas``
(interpret mode).  The CUDA kernel is held against the plain versions in
``test_torch_kernels_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

from blockcopy_tpu.core import blocked as JB
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.ops.pallas.halo import halo_gather_pallas
from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import halo as H
from torch_port_util import assert_same, tt
from torch_port_util import two_torch_threads  # noqa: F401


def _case(pad, partial, dtype, n=1, gh=3, gw=4, bs=8, c=16, seed=0):
    rs = np.random.RandomState(seed)
    total = n * gh * gw
    prev = jnp.asarray(rs.randn(n, gh * bs, gw * bs, c).astype(dtype))
    cur = jnp.asarray(rs.randn(n, gh * bs, gw * bs, c).astype(dtype))
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
    return canvas, strips, idx, pack.data, (n, gh, gw)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("pad", [1, 3])
def test_plain_versions_match_jax(pad, partial, dtype):
    canvas, strips, idx, center, geo = _case(pad, partial, dtype)
    ref = JB.halo_gather(canvas, idx, pad, *geo, center=center)
    assert_same(ref, JB.halo_gather_strips(strips, idx, pad, *geo, center))
    assert_same(ref, halo_gather_pallas(canvas, idx, pad, *geo, center))
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
