"""The package's public surface: ``blockcopy_tpu_torch`` exports every name
of ``blockcopy_tpu.__all__`` (plus ``resolve_device``), lazily, so the
import builds no kernel and imports no JAX; and the block helpers the
surface adds (``is_block``, ``combine``, ``to_dense``,
``split_block_layout``, ``ExecCtx.split_like``, ``blockcopy_noblocks``)
equal JAX's bit for bit, as ``tests/test_core_blocked.py`` holds JAX's."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockcopy_tpu
import blockcopy_tpu.core.blocked as JB
import blockcopy_tpu.core.engine as JE
import blockcopy_tpu_torch
import blockcopy_tpu_torch.core.blocked as TB
import blockcopy_tpu_torch.core.engine as TE
from torch_port_util import assert_same, tt
from torch_port_util import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_exports_jax_names():
    assert set(blockcopy_tpu.__all__) | {"resolve_device"} == \
        set(blockcopy_tpu_torch.__all__)
    for name in blockcopy_tpu_torch.__all__:
        value = getattr(blockcopy_tpu_torch, name)
        assert getattr(blockcopy_tpu, name, value).__name__ == \
            value.__name__, name
    assert blockcopy_tpu_torch.blockcopy_noblocks is TE.noblocks
    assert blockcopy_tpu_torch.BlockPack is TB.BlockPack
    assert set(blockcopy_tpu.__all__) <= set(dir(blockcopy_tpu_torch))
    with pytest.raises(AttributeError):
        blockcopy_tpu_torch.not_a_name


def test_import_builds_nothing_and_leaves_jax_out():
    """In a fresh process: the import loads no model code; touching every
    export then builds no kernel and imports no JAX."""
    code = (
        "import sys\n"
        "import blockcopy_tpu_torch as p\n"
        "assert 'blockcopy_tpu_torch.core.blocked' not in sys.modules\n"
        "from blockcopy_tpu_torch.ops.kernels import build\n"
        "calls = []\n"
        "build.build = lambda *a, **k: calls.append(a)\n"
        "build.library = lambda *a, **k: calls.append(a)\n"
        "names = [getattr(p, n) for n in p.__all__]\n"
        "assert not calls, calls\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'blockcopy_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split() == ["10"]


def _layout(seed=0, n=2, gh=2, gw=3, bs=4, c=5):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, gh * bs, gw * bs, c).astype(np.float32)
    idx = np.array([4, 0, 11, n * gh * gw], np.int32)   # a padding slot
    return x, idx, (n, gh, gw)


def test_is_block():
    x, idx, geom = _layout()
    jp = JB.split_dense(jnp.asarray(x), jnp.asarray(idx), *geom)
    tp = TB.split_dense(tt(x), tt(idx).long(), *geom)
    for jv, tv in ((jp, tp), (jnp.asarray(x), tt(x)), (x, x),
                   (None, None)):
        assert JB.is_block(jv) == TB.is_block(tv)
    assert TB.is_block(tp) and not TB.is_block(tt(x))


@pytest.mark.parametrize("sentinel", [True, False])
def test_split_block_layout(sentinel):
    """From a canvas with its zero sentinel row, and from a bare block
    layout (the sentinel index reads zeros, as ``mode="fill"``)."""
    x, idx, geom = _layout(1)
    layout = np.asarray(JB.dense_to_block_layout(jnp.asarray(x), *geom[1:]))
    if sentinel:
        layout = np.concatenate([layout, np.zeros_like(layout[:1])])
    ref = JB.split_block_layout(jnp.asarray(layout), jnp.asarray(idx), *geom)
    got = TB.split_block_layout(tt(layout), tt(idx).long(), *geom)
    assert_same(ref.data, got.data)
    assert (got.n, got.gh, got.gw) == (ref.n, ref.gh, ref.gw)
    assert_same(ref.idx, got.idx)


def test_combine_to_dense_split_like():
    """``combine`` and ``to_dense`` through a canvas, over two frames so
    the second keeps the first frame's skipped blocks; ``split_like``
    gathers with the context's grid; dense tensors pass ``to_dense``."""
    x, idx, geom = _layout(2)
    x2 = x + 1.0
    idx2 = np.array([1, 2, 12, 12], np.int32)
    jc, tc = {}, {}
    for frame, ix in ((x, idx), (x2, idx2)):
        jctx = JB.ExecCtx.blocked(jnp.asarray(ix), *geom, jc, building=True)
        tctx = TB.ExecCtx.blocked(tt(ix).long(), *geom, tc, building=True)
        jp, tp = jctx.split_like(jnp.asarray(frame)), tctx.split_like(
            tt(frame))
        assert_same(jp.data, tp.data)
        assert_same(JB.combine(jctx, "a", jp), TB.combine(tctx, "a", tp))
        assert_same(JB.to_dense(jp, jctx, "b"), TB.to_dense(tp, tctx, "b"))
        jc, tc = jctx.canvases, tctx.canvases
    assert_same(jc["a"], tc["a"])
    dense = tt(x)
    assert TB.to_dense(dense) is dense
    with pytest.raises(ValueError):
        TB.to_dense(tp)


def test_blockcopy_noblocks():
    """The alias runs a dense function inside a blocked model: blocks in,
    blocks out, the dense view through a canvas, as JAX's."""
    x, idx, geom = _layout(3)
    jctx = JB.ExecCtx.blocked(jnp.asarray(idx), *geom, {}, building=True)
    tctx = TB.ExecCtx.blocked(tt(idx).long(), *geom, {}, building=True)
    jp = JB.split_dense(jnp.asarray(x), jnp.asarray(idx), *geom)
    tp = TB.split_dense(tt(x), tt(idx).long(), *geom)
    ref = JE.blockcopy_noblocks(jctx, "spp", jp,
                                lambda ctx, d: d * 2.0 + 1.0)
    got = TE.blockcopy_noblocks(tctx, "spp", tp,
                                lambda ctx, d: d * 2.0 + 1.0)
    assert TE.blockcopy_noblocks is TE.noblocks
    assert_same(ref.data, got.data)
    assert_same(jctx.canvases["spp"], tctx.canvases["spp"])
    dense = TE.blockcopy_noblocks(TB.ExecCtx.dense(), "x", tt(x),
                                  lambda ctx, d: d + 1)
    assert torch.equal(dense, tt(x) + 1)
