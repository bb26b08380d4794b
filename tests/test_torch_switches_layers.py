"""The JAX package's off-by-default layer lowerings in the port, held against
JAX's with the switch on in both: ``BORDER_CONV`` (the border-corrected 3x3
conv and 3x3/p1 max pool), ``S2D_STEM`` (the 7x7 s2 stem over s2d-4 cells)
and ``TALL_CONV_BS`` (stride-1 convs of small blocks as one tall conv).

Each case runs a 2-frame clip over a 3x4 grid of 8 px blocks: frame 1
executes every block and builds the canvases, frame 2 a partial grid with
two padding slots, so skipped blocks read their neighbours' stale strips.
Outputs are held at 1e-4 of their largest magnitude (fp32), the carried
canvases bit for bit by name after each frame, and a spy checks that the
port's lowering ran.

One exception: at stride 2 with ``p = d = 2`` the JAX border lowering is not
exact (it adds the second left halo column, which no tap reads, and leaves
out the bottom row and the right column, which tap 2 reads; on random input
it differs from JAX's own exchange path by ~15), so there the port's border
conv is held against JAX's exchange path.  The last two tests check each global's default, and that each
``BLOCKCOPY_TPU_*`` variable sets it in a process that imports no JAX.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import blockcopy_tpu.ops.layers as JL
import blockcopy_tpu_torch.ops.layers as TL
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.core.blocked import ExecCtx as JCtx, split_dense as jsplit
from blockcopy_tpu_torch.core.blocked import ExecCtx as TCtx
from blockcopy_tpu_torch.core.blocked import split_dense as tsplit
from torch_port_util import assert_same, assert_tree, npf, tt
from torch_port_util import two_torch_threads  # noqa: F401

N, GH, GW, BS, C = 1, 3, 4, 8, 8
TOL = 1e-4


def _clip(c=C, seed=0):
    rs = np.random.RandomState(seed)
    frames = [rs.randn(N, GH * BS, GW * BS, c).astype(np.float32)
              for _ in range(2)]
    partial = np.zeros((N, GH, GW), bool)
    partial[0, ::2, 1::2] = partial[0, 1, 0] = True
    return frames, [np.ones((N, GH, GW), bool), partial]


def _assert_rel(ref, got, msg=""):
    ref, got = npf(ref), npf(got)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * scale,
                               err_msg=msg)


def _snap(tree):
    if isinstance(tree, dict):
        return {k: _snap(v) for k, v in tree.items()}
    return np.array(npf(tree))


def _run_both(jop, top, frames, grids):
    """Run ``jop(ctx, pack)`` (JAX, jitted per frame) and ``top(ctx, pack)``
    (the port) over the clip; hold outputs and canvases after each frame."""
    @functools.partial(jax.jit, static_argnames=("cap", "building"))
    def jframe(x, grid, canvases, cap, building):
        idx = JG.exec_indices(grid, cap)
        ctx = JCtx.blocked(idx, N, GH, GW, canvases, building=building)
        return idx, jop(ctx, jsplit(x, idx, N, GH, GW)).data, ctx.canvases

    jcv, tcv = {}, {}
    for t, (x, grid) in enumerate(zip(frames, grids)):
        cap = int(grid.sum()) + (2 if t else 0)       # padding slots
        idx, ref, jcv = jframe(jnp.asarray(x), jnp.asarray(grid), jcv,
                               cap=cap, building=t == 0)
        tidx = tt(idx).long()
        ctx = TCtx.blocked(tidx, N, GH, GW, tcv, building=t == 0)
        got = top(ctx, tsplit(tt(x), tidx, N, GH, GW))
        tcv = ctx.canvases
        _assert_rel(ref, got.data, f"frame {t}")
        assert sorted(jcv) == sorted(tcv)
        assert_tree(_snap(jcv), _snap(tcv), assert_same)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(TL, name)

    def wrapped(*a, **k):
        out = real(*a, **k)
        calls.append(out is not None)
        return out
    monkeypatch.setattr(TL, name, wrapped)
    return calls


@pytest.mark.parametrize("stride,dilation,groups", [
    (1, 1, 1), (2, 1, 1), (1, 2, 1), (2, 2, 1), (1, 1, C), (2, 1, C)])
def test_border_conv(stride, dilation, groups, monkeypatch):
    # JAX's border form is exact except at s = 2, p = d = 2 (docstring)
    monkeypatch.setattr(JL, "BORDER_CONV", (stride, dilation) != (2, 2))
    monkeypatch.setattr(TL, "BORDER_CONV", True)
    calls = _spy(monkeypatch, "_border_conv")
    frames, grids = _clip()
    rs = np.random.RandomState(1)
    w = rs.randn(3, 3, C // groups, 16).astype(np.float32)      # HWIO
    b = rs.randn(16).astype(np.float32)
    kw = dict(stride=stride, dilation=dilation, groups=groups)
    _run_both(
        lambda ctx, x: JL.conv2d(ctx, "c", x, jnp.asarray(w),
                                 jnp.asarray(b), **kw),
        lambda ctx, x: TL.conv2d(ctx, "c", x, tt(w.transpose(3, 2, 0, 1)),
                                 tt(b), **kw),
        frames, grids)
    assert calls == [True, True]


@pytest.mark.parametrize("stride", [1, 2])
def test_border_max_pool(stride, monkeypatch):
    monkeypatch.setattr(JL, "BORDER_CONV", True)
    monkeypatch.setattr(TL, "BORDER_CONV", True)
    calls = _spy(monkeypatch, "_border_max_pool")
    frames, grids = _clip(seed=2)
    _run_both(
        lambda ctx, x: JL.max_pool2d(ctx, "p", x, 3, stride, 1),
        lambda ctx, x: TL.max_pool2d(ctx, "p", x, 3, stride, 1),
        frames, grids)
    assert calls == [True, True]


def test_s2d_stem_conv(monkeypatch):
    monkeypatch.setattr(JL, "S2D_STEM", True)
    monkeypatch.setattr(TL, "S2D_STEM", True)
    calls = _spy(monkeypatch, "_s2d_stem_conv")
    frames, grids = _clip(c=3, seed=3)
    rs = np.random.RandomState(4)
    w = rs.randn(7, 7, 3, 16).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    _run_both(
        lambda ctx, x: JL.conv2d(ctx, "stem", x, jnp.asarray(w),
                                 jnp.asarray(b), stride=2, padding=3),
        lambda ctx, x: TL.conv2d(ctx, "stem", x, tt(w.transpose(3, 2, 0, 1)),
                                 tt(b), stride=2, padding=3),
        frames, grids)
    assert len(calls) == 2


@pytest.mark.parametrize("dilation", [1, 2])
def test_tall_conv(dilation, monkeypatch):
    monkeypatch.setattr(JL, "TALL_CONV_MAX_BS", BS)
    monkeypatch.setattr(TL, "TALL_CONV_MAX_BS", BS)
    calls = _spy(monkeypatch, "_tall_conv")
    frames, grids = _clip(seed=5)
    rs = np.random.RandomState(6)
    w = rs.randn(3, 3, C, 12).astype(np.float32)
    b = rs.randn(12).astype(np.float32)
    _run_both(
        lambda ctx, x: JL.conv2d(ctx, "c", x, jnp.asarray(w),
                                 jnp.asarray(b), dilation=dilation),
        lambda ctx, x: TL.conv2d(ctx, "c", x, tt(w.transpose(3, 2, 0, 1)),
                                 tt(b), dilation=dilation),
        frames, grids)
    assert len(calls) == 2


SWITCHES = {
    # variable: (module, global, value set, value expected)
    "BLOCKCOPY_TPU_BORDER_CONV": ("ops.layers", "BORDER_CONV", "1", True),
    "BLOCKCOPY_TPU_S2D_STEM": ("ops.layers", "S2D_STEM", "1", True),
    "BLOCKCOPY_TPU_TALL_CONV_BS": ("ops.layers", "TALL_CONV_MAX_BS", "8", 8),
    "BLOCKCOPY_TPU_OUT_BLOCKS": ("core.stepper", "OUT_BLOCKS", "1", True),
    "BLOCKCOPY_TPU_PACKED_OUT": ("core.stepper", "PACKED_OUT", "1", True),
    "BLOCKCOPY_TPU_POLICY_SPLIT_STEM": ("policy.net", "POLICY_SPLIT_STEM",
                                        "1", True),
    "BLOCKCOPY_TPU_POLICY_STEM_CONV4": ("policy.net", "POLICY_STEM_CONV4",
                                        "0", False),
    "BLOCKCOPY_TPU_TOPK": ("models.csp", "TOPK_IMPL", "approx", "approx"),
    "BLOCKCOPY_TPU_DECODE_LEAN_POINTS": ("models.csp", "DECODE_LEAN_POINTS",
                                         "0", False),
}


def test_switch_defaults():
    """With no ``BLOCKCOPY_TPU_*`` variable set, each global holds JAX's
    default (the port's ``TOPK_IMPL`` is 'sort')."""
    import importlib
    assert not set(SWITCHES) & set(os.environ)
    got = [getattr(importlib.import_module("blockcopy_tpu_torch." + m), g)
           for m, g, _, _ in SWITCHES.values()]
    assert got == [False, False, 0, False, False, False, True, "sort", True]


def test_environment_names():
    """In a process that imports the port and no JAX, each variable sets
    its global."""
    env = dict(os.environ, **{k: v[2] for k, v in SWITCHES.items()})
    code = (
        "import importlib, json, sys\n"
        f"names = {json.dumps([(m, g) for m, g, _, _ in SWITCHES.values()])}\n"
        "vals = [getattr(importlib.import_module('blockcopy_tpu_torch.' + m),"
        " g) for m, g in names]\n"
        "assert 'jax' not in sys.modules\n"
        "print(json.dumps(vals))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == [v[3] for v in SWITCHES.values()]
