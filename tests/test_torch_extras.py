"""The port's inherited detection ops (``blockcopy_tpu_torch/ops/extras.py``)
against the JAX package's (``blockcopy_tpu/ops/extras.py``): values within
1e-5, and the RoIAlign and deformable-conv gradients within 1e-4 of
``jax.grad``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.core.blocked import ExecCtx as JCtx, split_dense as jsplit
from blockcopy_tpu.ops import extras as JE
from blockcopy_tpu_torch.core.blocked import ExecCtx as TCtx
from blockcopy_tpu_torch.core.blocked import split_dense as tsplit
from blockcopy_tpu_torch.ops import extras as TE
from torch_port_util import assert_close, tt, two_torch_threads  # noqa: F401

TOL = 1e-5


def close(ref, got, tol=TOL):
    """Within ``tol`` of the largest |JAX value| (and ``tol`` relative)."""
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    assert_close(ref, got, tol, atol=tol * scale)


def _rois():
    # in-image, partly outside (zero contributions), degenerate (< 1 px)
    return np.array([[0, 1.0, 2.0, 11.0, 9.0], [1, 0.0, 0.0, 15.0, 11.0],
                     [0, -3.5, 4.25, 6.0, 14.5], [1, 7.3, 7.3, 7.6, 7.9],
                     [0, 10.0, -2.0, 19.0, 6.0]], np.float32)


def test_sigmoid_focal_loss():
    rs = np.random.RandomState(0)
    logits = (rs.randn(16, 3) * 4).astype(np.float32)
    targets = rs.randint(0, 4, (16,))
    for gamma, alpha in ((2.0, 0.25), (1.5, 0.5)):
        ref = JE.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets),
                                    gamma, alpha)
        got = TE.sigmoid_focal_loss(tt(logits), torch.from_numpy(targets),
                                    gamma, alpha)
        close(ref, got)


@pytest.mark.parametrize("out_size,scale,ratio", [(5, 1.0, 2), (7, 0.5, 2),
                                                  (3, 0.25, 3)])
def test_roi_align(out_size, scale, ratio):
    feat = np.random.RandomState(1).randn(2, 12, 16, 4).astype(np.float32)
    rois = _rois() * np.float32([1] + [1 / scale] * 4)
    ref = JE.roi_align(jnp.asarray(feat), jnp.asarray(rois), out_size, scale,
                       ratio)
    got = TE.roi_align(tt(feat), tt(rois), out_size, scale, ratio)
    assert tuple(got.shape) == ref.shape
    close(ref, got)


def test_roi_align_grad():
    rs = np.random.RandomState(2)
    feat = rs.randn(2, 12, 16, 4).astype(np.float32)
    rois = _rois()
    cot = rs.randn(len(rois), 5, 5, 4).astype(np.float32)
    ref = jax.grad(lambda f: jnp.sum(
        JE.roi_align(f, jnp.asarray(rois), 5) * cot))(jnp.asarray(feat))
    f = tt(feat).requires_grad_(True)
    (TE.roi_align(f, tt(rois), 5) * tt(cot)).sum().backward()
    close(ref, f.grad, 1e-4)


@pytest.mark.parametrize("out_size,scale", [(7, 1.0), (4, 0.5)])
def test_roi_pool(out_size, scale):
    feat = np.random.RandomState(3).randn(2, 12, 16, 4).astype(np.float32)
    rois = _rois() * np.float32([1] + [1 / scale] * 4)
    ref = JE.roi_pool(jnp.asarray(feat), jnp.asarray(rois), out_size, scale)
    got = TE.roi_pool(tt(feat), tt(rois), out_size, scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _dcn_inputs(seed, n=2, h=9, w=11, c=4, cout=6, k=3, dg=2, stride=1,
                padding=1, dilation=1):
    rs = np.random.RandomState(seed)
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    x = rs.randn(n, h, w, c).astype(np.float32)
    # fractional offsets, some far out of bounds (zero samples)
    off = (rs.randn(n, ho, wo, dg * k * k * 2) * 2.5).astype(np.float32)
    wt = (rs.randn(k, k, c, cout) / np.sqrt(k * k * c)).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    mask = rs.rand(n, ho, wo, dg * k * k).astype(np.float32)
    return x, off, wt, b, mask


@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("geom", [dict(), dict(stride=2, padding=2,
                                               dilation=2, dg=1)])
def test_deform_conv2d(modulated, geom):
    x, off, wt, b, mask = _dcn_inputs(4, **geom)
    kw = dict(stride=geom.get("stride", 1), padding=geom.get("padding", 1),
              dilation=geom.get("dilation", 1),
              deformable_groups=geom.get("dg", 2))
    # jitted: JAX's eager per-op dispatch over the taps is slow
    ref = jax.jit(lambda x_, o_, w_, b_, m_: JE.deform_conv2d(
        x_, o_, w_, b_, mask=m_, **kw))(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt), jnp.asarray(b),
        jnp.asarray(mask) if modulated else None)
    got = TE.deform_conv2d(tt(x), tt(off), tt(wt).permute(3, 2, 0, 1),
                           tt(b), mask=tt(mask) if modulated else None, **kw)
    assert tuple(got.shape) == ref.shape
    close(ref, got)


def test_deform_conv2d_grad():
    """Gradients with respect to the input, the offsets, the weights and
    the modulation."""
    x, off, wt, b, mask = _dcn_inputs(5)
    cot = np.random.RandomState(6).randn(2, 9, 11, 6).astype(np.float32)

    def jloss(x_, o_, w_, m_):
        return jnp.sum(JE.deform_conv2d(x_, o_, w_, jnp.asarray(b),
                                        deformable_groups=2, mask=m_) * cot)
    refs = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (x, off, wt, mask)))
    ts = [tt(a).requires_grad_(True) for a in (x, off, wt, mask)]
    out = TE.deform_conv2d(ts[0], ts[1], ts[2].permute(3, 2, 0, 1), tt(b),
                           deformable_groups=2, mask=ts[3])
    (out * tt(cot)).sum().backward()
    for ref, t in zip(refs, ts):
        close(ref, t.grad, 1e-4)


def test_masked_conv2d_dense_and_blocked():
    rs = np.random.RandomState(7)
    n, gh, gw, bs, c, cout = 1, 2, 3, 8, 4, 5
    x = rs.randn(n, gh * bs, gw * bs, c).astype(np.float32)
    w = (rs.randn(3, 3, c, cout) / 6).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    mask = rs.rand(n, gh * bs, gw * bs) > 0.5
    ref = JE.masked_conv2d(JCtx.dense(), "m", jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(mask), jnp.asarray(b))
    got = TE.masked_conv2d(TCtx.dense(), "m", tt(x), tt(w).permute(3, 2, 0, 1),
                           torch.from_numpy(mask), tt(b))
    close(ref, got)

    grid = np.zeros((n, gh, gw), bool)
    grid[0, :, 1:] = True
    jidx = JG.exec_indices(jnp.asarray(grid), 5)     # one padding slot
    tidx = tt(jidx).long()
    jctx = JCtx.blocked(jidx, n, gh, gw, {}, building=True)
    tctx = TCtx.blocked(tidx, n, gh, gw, {}, building=True)
    bmask = rs.rand(5, bs, bs, 1) > 0.3
    ref = JE.masked_conv2d(jctx, "m", jsplit(jnp.asarray(x), jidx, n, gh, gw),
                           jnp.asarray(w), jnp.asarray(bmask), padding=1)
    got = TE.masked_conv2d(tctx, "m", tsplit(tt(x), tidx, n, gh, gw),
                           tt(w).permute(3, 2, 0, 1), torch.from_numpy(bmask),
                           padding=1)
    close(ref.data, got.data)
