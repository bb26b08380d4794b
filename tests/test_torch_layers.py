"""Port of ops/layers.py (the SwiftNet-path subset) held against the JAX
package: convs dense and blocked, pools, resizes, and the s2d plane stem
over a 3-frame clip."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockcopy_tpu.ops.layers as JL
import blockcopy_tpu_torch.ops.layers as TL
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.core.blocked import ExecCtx as JCtx, split_dense as jsplit
from blockcopy_tpu_torch.core import grid as TG
from blockcopy_tpu_torch.core.blocked import ExecCtx as TCtx
from blockcopy_tpu_torch.core.blocked import split_dense as tsplit
from torch_port_util import assert_close, assert_same, assert_tree, tol, tt
from torch_port_util import two_torch_threads  # noqa: F401

DTYPES = [np.float32, jnp.bfloat16]


def _w(rs, kh, cin, cout, dtype):
    w = (rs.randn(kh, kh, cin, cout) / np.sqrt(kh * kh * cin))
    return w.astype(np.float32).astype(dtype)


def oihw(w):
    return tt(w).permute(3, 2, 0, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,stride,dilation,groups,bias", [
    (3, 1, 1, 1, True), (3, 2, 1, 1, False), (3, 1, 2, 1, False),
    (3, 1, 1, 4, False), (1, 2, 1, 1, True), (7, 2, 1, 1, False)])
def test_conv2d_dense_and_blocked(k, stride, dilation, groups, bias, dtype):
    rs = np.random.RandomState(k + stride + dilation + groups)
    n, gh, gw, bs, cin, cout = 1, 2, 3, 8, 8, 12
    x = rs.randn(n, gh * bs, gw * bs, cin).astype(dtype)
    w = _w(rs, k, cin // groups, cout, dtype)
    b = (0.1 * rs.randn(cout)).astype(np.float32).astype(dtype) \
        if bias else None
    pad = 3 if k == 7 else None
    kw = dict(stride=stride, dilation=dilation, groups=groups, padding=pad)
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else tt(b)
    ref = JL.conv2d(JCtx.dense(), "c", jnp.asarray(x), jnp.asarray(w), jb,
                    **kw)
    got = TL.conv2d(TCtx.dense(), "c", tt(x), oihw(w), tb, **kw)
    assert got.dtype == tt(x).dtype
    assert_close(ref, got, tol(dtype))

    grid = np.zeros((n, gh, gw), bool)
    grid[0, :, 1:] = True
    jidx = JG.exec_indices(jnp.asarray(grid), 5)     # one padding slot
    jctx = JCtx.blocked(jidx, n, gh, gw, {}, building=True)
    tctx = TCtx.blocked(tt(jidx).long(), n, gh, gw, {}, building=True)
    ref = JL.conv2d(jctx, "c", jsplit(jnp.asarray(x), jidx, n, gh, gw),
                    jnp.asarray(w), jb, **kw)
    got = TL.conv2d(tctx, "c", tsplit(tt(x), tt(jidx).long(), n, gh, gw),
                    oihw(w), tb, **kw)
    assert_close(ref.data, got.data, tol(dtype))
    assert_tree(jctx.canvases, tctx.canvases, assert_same)


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_norm_relu_add_zero_halo(dtype, monkeypatch):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 6, 8, 5).astype(dtype)
    s, b = (1 + 0.1 * rs.randn(5)).astype(np.float32), \
        (0.1 * rs.randn(5)).astype(np.float32)
    ref = JL.add(JL.relu(JL.batch_norm(jnp.asarray(x), jnp.asarray(s),
                                       jnp.asarray(b))), jnp.asarray(x))
    got = TL.add(TL.relu(TL.batch_norm(tt(x), tt(s), tt(b))), tt(x))
    assert_same(ref, got)
    # BLOCKPAD_WITH_ZEROES: zero halos instead of the exchange
    monkeypatch.setattr(JL, "BLOCKPAD_WITH_ZEROES", True)
    monkeypatch.setattr(TL, "BLOCKPAD_WITH_ZEROES", True)
    n, gh, gw = 2, 2, 2
    xb = rs.randn(n, 8, 8, 4).astype(dtype)
    w = _w(rs, 3, 4, 4, dtype)
    jidx = JG.exec_indices(jnp.ones((n, gh, gw), bool), 8)
    ref = JL.conv2d(JCtx.blocked(jidx, n, gh, gw, {}), "c",
                    jsplit(jnp.asarray(xb), jidx, n, gh, gw), jnp.asarray(w))
    got = TL.conv2d(TCtx.blocked(tt(jidx).long(), n, gh, gw, {}), "c",
                    tsplit(tt(xb), tt(jidx).long(), n, gh, gw), oihw(w))
    assert_close(ref.data, got.data, tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_max_pool(dtype):
    rs = np.random.RandomState(1)
    n, gh, gw, bs, c = 1, 2, 3, 8, 4
    x = np.maximum(rs.randn(n, gh * bs, gw * bs, c), 0).astype(dtype)
    assert_same(JL.max_pool2d(JCtx.dense(), "p", jnp.asarray(x)),
                TL.max_pool2d(TCtx.dense(), "p", tt(x)))
    jidx = JG.exec_indices(jnp.ones((n, gh, gw), bool), 6)
    jctx = JCtx.blocked(jidx, n, gh, gw, {}, building=True)
    tctx = TCtx.blocked(tt(jidx).long(), n, gh, gw, {}, building=True)
    for stride in (1, 2):
        assert_same(JL.max_pool2d(jctx, f"p{stride}", jsplit(
            jnp.asarray(x), jidx, n, gh, gw), stride=stride).data,
            TL.max_pool2d(tctx, f"p{stride}", tsplit(
                tt(x), tt(jidx).long(), n, gh, gw), stride=stride).data)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("out_hw", [(4, 8), (3, 5), (1, 1)])
def test_adaptive_pools(out_hw, dtype):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 8, 16, 3).astype(dtype)
    assert_close(JL.adaptive_avg_pool2d(jnp.asarray(x), out_hw),
                 TL.adaptive_avg_pool2d(tt(x), out_hw), tol(dtype))
    assert_same(JL.adaptive_max_pool2d(jnp.asarray(x), out_hw),
                TL.adaptive_max_pool2d(tt(x), out_hw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("out_hw", [(16, 32), (3, 5), (24, 40), (8, 16)])
def test_resizes(out_hw, dtype):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 16, 3).astype(dtype)
    assert_close(JL.resize_bilinear(jnp.asarray(x), out_hw),
                 TL.resize_bilinear(tt(x), out_hw), tol(dtype), atol=1e-6)
    assert_same(JL.resize_nearest(jnp.asarray(x), out_hw),
                TL.resize_nearest(tt(x), out_hw))
    assert_close(JL.upsample2x(jnp.asarray(x)), TL.upsample2x(tt(x)),
                 tol(dtype), atol=1e-6)


def _snap(tree):
    if isinstance(tree, dict):
        return {k: _snap(v) for k, v in tree.items()}
    return np.array(tree.float() if isinstance(tree, torch.Tensor)
                    else tree.astype(jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_stem_pool_s2d_clip(dtype):
    """The fused s2d plane stem over 3 frames with partial grids: outputs
    and both canvases (s2d input strips bitwise, plane strips to tol)."""
    rs = np.random.RandomState(4)
    n, gh, gw, bs, cout = 1, 2, 3, 16, 16
    w = _w(rs, 7, 3, cout, dtype)
    s = (1 + 0.1 * rs.randn(cout)).astype(np.float32).astype(dtype)
    b = (0.1 * rs.randn(cout)).astype(np.float32).astype(dtype)
    grids = [np.ones((n, gh, gw), bool), rs.rand(n, gh, gw) < 0.5,
             rs.rand(n, gh, gw) < 0.5]

    # JAX's frame jitted (eager JAX compiles every op)
    @functools.partial(jax.jit, static_argnames=("cap", "building"))
    def jframe(x, grid, canvases, cap, building):
        jidx = JG.exec_indices(grid, cap)
        jctx = JCtx.blocked(jidx, n, gh, gw, canvases, building=building)
        ref = JL.stem_pool_s2d(jctx, "conv1", "pool",
                               jsplit(x, jidx, n, gh, gw), jnp.asarray(w),
                               jnp.asarray(s), jnp.asarray(b))
        return ref.data, jctx.canvases

    jcv, tcv = {}, {}
    for t, grid in enumerate(grids):
        x = rs.randn(n, gh * bs, gw * bs, 3).astype(dtype)
        ref, jcv = jframe(jnp.asarray(x), jnp.asarray(grid), jcv,
                          cap=int(grid.sum()) + 1, building=t == 0)
        tidx = TG.exec_indices(torch.from_numpy(grid), int(grid.sum()) + 1)
        tctx = TCtx.blocked(tidx, n, gh, gw, tcv, building=t == 0)
        got = TL.stem_pool_s2d(tctx, "conv1", "pool",
                               tsplit(tt(x), tidx, n, gh, gw), oihw(w),
                               tt(s), tt(b))
        tcv = tctx.canvases
        assert got.data.shape == (grid.sum() + 1, bs // 4, bs // 4, cout)
        assert_close(ref, got.data, tol(dtype), msg=f"frame {t}")
        assert_tree(_snap(jcv["conv1.s2d"]), _snap(tcv["conv1.s2d"]),
                    assert_same)
        assert_tree(_snap(jcv["pool.planes"]), _snap(tcv["pool.planes"]),
                    lambda a, b_, m: assert_close(a, b_, tol(dtype), msg=m))
