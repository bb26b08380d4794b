"""Port of models/swiftnet.py held against the JAX package with the JAX
parameters converted: RN18 in a dense ctx and in a blocked ctx over a
3-frame partial-grid clip (outputs and every canvas by name); RN50 blocked
(slow).

Random-init SwiftNet activations reach ~1e3 (identity BN), so float
results are compared with rtol 1e-4 and atol 1e-4 times the tensor's
largest magnitude."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockcopy_tpu.models.swiftnet as JS
import blockcopy_tpu_torch.models.swiftnet as TS
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.core.blocked import ExecCtx as JCtx, split_dense as jsplit
from blockcopy_tpu_torch.core.blocked import ExecCtx as TCtx
from blockcopy_tpu_torch.core.blocked import split_dense as tsplit
from blockcopy_tpu_torch.utils.convert import params_from_jax
from torch_port_util import assert_tree, jtree, npf, tt
from torch_port_util import two_torch_threads  # noqa: F401

H, W, BS = 256, 512, 128
RTOL = 1e-4


def assert_rel(ref, got, msg=""):
    ref, got = npf(ref), npf(got)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale,
                               err_msg=msg)


@functools.lru_cache(maxsize=None)
def _models(backbone):
    """Both packages' configs and parameters, converted once per module;
    the JAX side is read only through jitted functions below."""
    cfg_j = JS.SwiftNetConfig(backbone=backbone)
    cfg_t = TS.SwiftNetConfig(backbone=backbone)
    jp = JS.init_swiftnet(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, jp, cfg_t, params_from_jax(jtree(jp), device="cpu")


def test_init_matches_jax_structure():
    cfg_j = JS.SwiftNetConfig(backbone="resnet50")
    cfg_t = TS.SwiftNetConfig(backbone="resnet50")
    # shapes and dtypes only: JAX's init traced, not run
    jp = jax.eval_shape(lambda k: JS.init_swiftnet(k, cfg_j),
                        jax.random.PRNGKey(0))
    tp = TS.init_swiftnet(cfg_t, seed=0, device="cpu")

    def same_shape(a, b, msg):     # HWIO in JAX, OIHW in the port
        want = (a.shape[3], a.shape[2], a.shape[0], a.shape[1]) \
            if a.ndim == 4 else a.shape
        assert a.dtype == jnp.float32, msg
        assert tuple(b.shape) == want and b.dtype == torch.float32, msg

    assert_tree(jp, tp, same_shape)


def test_dense_rn18():
    cfg_j, jp, cfg_t, tp = _models("resnet18")
    x = np.random.RandomState(0).randn(1, H, W, 3).astype(np.float32)
    ref = jax.jit(lambda p, v: JS.swiftnet_apply(p, v, JCtx.dense(), cfg_j))(
        jp, jnp.asarray(x))
    got = TS.swiftnet_apply(tp, tt(x), TCtx.dense(), cfg_t)
    assert got.shape == (1, H // 4, W // 4, 19)
    assert_rel(ref, got)


def _snap(tree):
    if isinstance(tree, dict):
        return {k: _snap(v) for k, v in tree.items()}
    return np.array(npf(tree))


def _jax_blocked_frame(cfg_j, n, gh, gw):
    """One frame of JAX's blocked SwiftNet, jitted per executed-block
    count and per building/steady frame (eager JAX compiles every op)."""
    @functools.partial(jax.jit, static_argnames=("cap", "building"))
    def frame(jp, x, grid, canvases, cap, building):
        jidx = JG.exec_indices(grid, cap)
        jctx = JCtx.blocked(jidx, n, gh, gw, canvases, building=building)
        out = JS.swiftnet_apply(jp, jsplit(x, jidx, n, gh, gw), jctx, cfg_j)
        return jidx, out.data, jctx.canvases
    return frame


def _blocked_clip(backbone, n_frames=3):
    cfg_j, jp, cfg_t, tp = _models(backbone)
    rs = np.random.RandomState(1)
    n, gh, gw = 1, H // BS, W // BS
    grids = [np.ones((n, gh, gw), bool), np.zeros((n, gh, gw), bool),
             np.zeros((n, gh, gw), bool)][:n_frames]
    grids[1][0, 0, 1:3] = grids[1][0, 1, 0] = True
    grids[2][0, 1, :] = True
    jframe = _jax_blocked_frame(cfg_j, n, gh, gw)
    jcv, tcv = {}, {}
    for t, grid in enumerate(grids):
        x = rs.randn(n, H, W, 3).astype(np.float32)
        jidx, ref, jcv = jframe(jp, jnp.asarray(x), jnp.asarray(grid), jcv,
                                cap=int(grid.sum()) + 1, building=t == 0)
        tidx = tt(jidx).long()
        tctx = TCtx.blocked(tidx, n, gh, gw, tcv, building=t == 0)
        got = TS.swiftnet_apply(tp, tsplit(tt(x), tidx, n, gh, gw), tctx,
                                cfg_t)
        tcv = tctx.canvases
        assert sorted(jcv) == sorted(tcv)
        assert_rel(ref, got.data, f"frame {t}")
        assert_tree(_snap(jcv), _snap(tcv), assert_rel)


def test_blocked_clip_rn18():
    _blocked_clip("resnet18")


@pytest.mark.slow
def test_blocked_clip_rn50():
    _blocked_clip("resnet50")
