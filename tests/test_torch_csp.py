"""CSP in the port held against the JAX package: the layers it adds
(``conv_transpose2d``, ``group_norm``, ``concat_channels``), a two-frame
blocked forward under both head switches, and the converter on CSP
parameters.

The model runs ``CSPConfig(stage_blocks=(1, 2, 2, 1))`` at full widths on
256x256 frames (block 128, a 2x2 grid): the port's fused-tail gate takes
layer2 block 1 and layer3 block 1 (their plain versions run here), JAX runs
them unfused.  Tolerances: 1e-4 fp32, 3e-2 bf16, relative to each tensor's
largest magnitude where random-init activations grow large.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockcopy_tpu.models.csp as JC
import blockcopy_tpu_torch.models.csp as TC
from blockcopy_tpu.core import blocked as JB
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.ops import layers as JL
from blockcopy_tpu_torch.core import blocked as TB
from blockcopy_tpu_torch.core import grid as TG
from blockcopy_tpu_torch.ops import layers as TL
from blockcopy_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from torch_port_util import (assert_same, assert_tree, close_rel, jtree, npf,
                             tol, tt)
from torch_port_util import two_torch_threads  # noqa: F401

CFG = dict(stage_blocks=(1, 2, 2, 1))
_PARAMS = {}


def _params():
    """Port-drawn CSP parameters (JAX's eager init is slow on the CPU),
    carried to JAX through the converter's inverse."""
    if not _PARAMS:
        tp = TC.init_csp(TC.CSPConfig(**CFG), seed=0, device="cpu")
        jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
        _PARAMS["p"] = (jp, params_from_jax(jtree(jp), device="cpu"))
    return _PARAMS["p"]


def _dtypes():
    return [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("jdt,tdt", _dtypes())
@pytest.mark.parametrize("stride,pad,blocked", [(2, 1, True), (4, 0, True),
                                                (2, 1, False)])
def test_conv_transpose2d(jdt, tdt, stride, pad, blocked):
    rs = np.random.RandomState(stride + pad)
    x = rs.randn(3, 8, 8, 24).astype(np.float32)
    w = (rs.randn(4, 4, 24, 16) * 0.1).astype(np.float32)   # HWIO
    b = rs.randn(16).astype(np.float32)
    idx = np.array([0, 3, 4])
    jx, tx = jnp.asarray(x, jdt), tt(np.asarray(jnp.asarray(x, jdt)))
    jw, jb = jnp.asarray(w, jdt), jnp.asarray(b, jdt)
    tw = params_from_jax({"neck": {"p3": {"w": np.asarray(jw)}}},
                         device="cpu")["neck"]["p3"]["w"]
    assert tuple(tw.shape) == (24, 16, 4, 4)
    if blocked:
        jx = JB.BlockPack(jx, jnp.asarray(idx, jnp.int32), 1, 2, 2)
        tx = TB.BlockPack(tx, torch.as_tensor(idx), 1, 2, 2)
        jctx = JB.ExecCtx.blocked(jx.idx, 1, 2, 2, {})
        tctx = TB.ExecCtx.blocked(tx.idx, 1, 2, 2, {})
    else:
        jctx, tctx = JB.ExecCtx.dense(), TB.ExecCtx.dense()
    ref = JL.conv_transpose2d(jctx, "t", jx, jw, jb, stride=stride,
                              padding=pad)
    got = TL.conv_transpose2d(tctx, "t", tx, tw, tt(np.asarray(jb)),
                              stride=stride, padding=pad)
    ref, got = (r.data if blocked else r for r in (ref, got))
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    close_rel(ref, got, tol(jdt))
    assert tctx.macs == jctx.macs


def _gn_pack(rs, dtype, n):
    """A blocked input over 2 images of a 2x2 grid with one padding slot."""
    d = (rs.randn(5, 4, 4, 64) * 3 + 1).astype(np.float32)
    idx = np.array([0, 2, 5, 7, 4 * n])         # last: padding slot
    return d, idx


@pytest.mark.parametrize("jdt,tdt", _dtypes())
@pytest.mark.parametrize("blocked", [True, False])
def test_group_norm(jdt, tdt, blocked):
    rs = np.random.RandomState(1)
    gamma = rs.randn(64).astype(np.float32)
    beta = rs.randn(64).astype(np.float32)
    if blocked:
        d, idx = _gn_pack(rs, jdt, 2)
        jd = jnp.asarray(d, jdt)
        jx = JB.BlockPack(jd, jnp.asarray(idx, jnp.int32), 2, 2, 2)
        tx = TB.BlockPack(tt(np.asarray(jd)), torch.as_tensor(idx), 2, 2, 2)
    else:
        jx = jnp.asarray((rs.randn(2, 8, 8, 64) * 3 + 1).astype(np.float32),
                         jdt)
        tx = tt(np.asarray(jx))
    ref = JL.group_norm(jx, 32, jnp.asarray(gamma), jnp.asarray(beta))
    got = TL.group_norm(tx, 32, tt(gamma), tt(beta))
    ref, got = (r.data if blocked else r for r in (ref, got))
    assert got.dtype == tdt
    k = 4 if blocked else None   # the padding slot's output is unused
    close_rel(npf(ref)[:k], npf(got)[:k], tol(jdt))


def test_group_norm_padding_slot_is_ignored():
    """A padding slot's values do not reach the statistics."""
    rs = np.random.RandomState(2)
    d, idx = _gn_pack(rs, np.float32, 2)
    g, b = torch.ones(64), torch.zeros(64)
    a = TL.group_norm(TB.BlockPack(tt(d), torch.as_tensor(idx), 2, 2, 2),
                      32, g, b)
    d[-1] += 100.0
    c = TL.group_norm(TB.BlockPack(tt(d), torch.as_tensor(idx), 2, 2, 2),
                      32, g, b)
    assert torch.equal(a.data[:4], c.data[:4])


@pytest.mark.parametrize("blocked", [True, False])
def test_concat_channels(blocked):
    rs = np.random.RandomState(3)
    xs = [rs.randn(2, 4, 4, c).astype(np.float32) for c in (3, 5, 2)]
    if blocked:
        idx = np.array([1, 0])
        ref = JL.concat_channels([JB.BlockPack(jnp.asarray(x),
                                               jnp.asarray(idx), 1, 1, 2)
                                  for x in xs])
        got = TL.concat_channels([TB.BlockPack(tt(x), torch.as_tensor(idx),
                                               1, 1, 2) for x in xs])
        assert isinstance(got, TB.BlockPack)
        ref, got = ref.data, got.data
    else:
        ref = JL.concat_channels([jnp.asarray(x) for x in xs])
        got = TL.concat_channels([tt(x) for x in xs])
    assert_same(ref, got)


def _two_frames(apply, B, G, params, frames, cfg, as_idx):
    """Frame 1 executes all 4 blocks (building the canvases), frame 2
    blocks 0 and 3 at capacity 4 (two padding slots; the same shapes as
    frame 1, so JAX compiles its ops once)."""
    ctx0 = B.ExecCtx.blocked(as_idx(np.arange(4)), 1, 2, 2, {},
                             building=True)
    out0 = apply(params, B.split_dense(frames[0], ctx0.idx, 1, 2, 2), ctx0,
                 cfg)
    grid = np.array([[[True, False], [False, True]]])
    idx1 = G.exec_indices(as_idx(grid), 4)
    ctx1 = B.ExecCtx.blocked(idx1, 1, 2, 2, ctx0.canvases)
    out1 = apply(params, B.split_dense(frames[1], idx1, 1, 2, 2), ctx1, cfg)
    return out0, out1, ctx1


@pytest.mark.parametrize("blocked_final", [True, False])
@pytest.mark.parametrize("fused_branch", [True, False])
def test_csp_two_frames(monkeypatch, blocked_final, fused_branch):
    monkeypatch.setattr(JC, "HEAD_BLOCKED_FINAL", blocked_final)
    monkeypatch.setattr(TC, "HEAD_BLOCKED_FINAL", blocked_final)
    monkeypatch.setattr(JC, "HEAD_FUSED_BRANCH_CONV", fused_branch)
    monkeypatch.setattr(TC, "HEAD_FUSED_BRANCH_CONV", fused_branch)
    jp, tp = _params()
    rs = np.random.RandomState(5)
    f0 = rs.randn(1, 256, 256, 3).astype(np.float32)
    frames = [f0, f0 + rs.randn(1, 256, 256, 3).astype(np.float32)]
    j0, j1, jctx = _two_frames(
        JC.csp_apply, JB, JG, jp, [jnp.asarray(f) for f in frames],
        JC.CSPConfig(**CFG),
        lambda a: jnp.asarray(a) if a.dtype == bool else jnp.asarray(
            a, jnp.int32))
    t0, t1, tctx = _two_frames(
        TC.csp_apply, TB, TG, tp, [tt(f) for f in frames],
        TC.CSPConfig(**CFG), torch.as_tensor)
    for frame, ref, got in ((1, j0, t0), (2, j1, t1)):
        assert len(got) == 3
        for name, r, g in zip(("cls", "reg", "offset"), ref, got):
            assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
            close_rel(r, g, 1e-4, f"frame {frame} {name}")
    jc, tcv = jtree(jctx.canvases), tctx.canvases
    assert sorted(jc) == sorted(tcv)
    assert_tree(jc, tcv, lambda a, b, m: close_rel(a, b, 1e-4, f"canvas{m}"))
    assert tctx.macs == pytest.approx(jctx.macs)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_converter_round_trip(dtype):
    """JAX's CSP tree goes through the port and back bit for bit; the neck's
    transposed-conv weights land in torch's (in, out, kh, kw) layout, so a
    neck conv through the converted weights matches JAX's."""
    cfg = JC.CSPConfig(stage_blocks=(1, 1, 1, 1))
    # JAX's tree, structure and dtypes, filled with random values (JAX's
    # eager init compiles every draw on the CPU)
    rs = np.random.RandomState(4)
    jp = jax.tree.map(
        lambda s: np.asarray(jnp.asarray(rs.randn(*s.shape), s.dtype)),
        jax.eval_shape(lambda: JC.init_csp(jax.random.PRNGKey(0), cfg,
                                           dtype=dtype)))
    tp = params_from_jax(jp, device="cpu")
    assert tp["head"]["reg_scale"].dim() == 0
    assert tuple(tp["neck"]["p4"]["w"].shape) == (1024, 256, 4, 4)
    assert tuple(tp["head"]["csp_cls"]["w"].shape) == (1, 256, 3, 3)
    assert_tree(jp, params_to_numpy(tp), assert_same)
    x = rs.randn(2, 8, 8, 1024).astype(np.float32)
    p = jp["neck"]["p4"]
    ref = JL.conv_transpose2d(JB.ExecCtx.dense(), "p4",
                              jnp.asarray(x, dtype), jnp.asarray(p["w"]),
                              jnp.asarray(p["b"]), stride=4, padding=0)
    got = TL.conv_transpose2d(TB.ExecCtx.dense(), "p4", tt(np.asarray(
        jnp.asarray(x, dtype))), tp["neck"]["p4"]["w"],
        tp["neck"]["p4"]["b"], stride=4, padding=0)
    close_rel(ref, got, 1e-5 if dtype == jnp.float32 else 3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_tails_per_frame(monkeypatch, dtype):
    """The tails CSP hands the fused kernel per frame at block 128, routed on
    the CPU as on the card: layer2 blocks 1-3 (bs 16, Cm 128) and layer3
    blocks 1-5 (bs 8, Cm 256), 8 in all; layer1 (Cm 64) and the dilated
    layer4 stay unfused.  Layers 1 and 4 are cut to one block (they fuse
    nothing), on a 128x256 frame."""
    import blockcopy_tpu_torch.models.swiftnet as TS
    from blockcopy_tpu_torch.tools.measure import csp_stepper
    calls = []
    real = TS.bottleneck_tail
    monkeypatch.setattr(TS, "bottleneck_tail",
                        lambda *a: calls.append(a[0].shape[1:]) or real(*a))
    monkeypatch.setattr(TS, "FUSED_BOTTLENECK", None)   # port default: on
    params, st = csp_stepper((1, 128, 256, 3), 1, dtype, "cpu",
                             TC.CSPConfig(stage_blocks=(1, 4, 6, 1)))
    frame = torch.randn((1, 128, 256, 3), generator=torch.Generator()
                        .manual_seed(0)).to(dtype)
    state = st.first_step(params, st.init_state(params, seed=1), frame)
    assert len(calls) == 8
    state = st.step(params, state, frame)
    assert [tuple(c) for c in calls[8:]] == [(16, 16, 128)] * 3 \
        + [(8, 8, 256)] * 5
    assert bool(torch.isfinite(state["dets"]).all())


def test_halo_sites_per_frame(monkeypatch):
    """The K1 launches CSP makes per frame at block 128, (bs, C, pad) in
    order, routed on the CPU as on the card: the stem's s2d planes, a 3x3
    per layer1 block, the strided first blocks of layer2 and layer3, a
    dilated 3x3 (pad 2) per layer4 block, the head's fused branch conv (768
    channels) and its three blocked final convs.  ``chip_smoke.py`` holds
    the full-depth count (13) on the card."""
    from blockcopy_tpu_torch.tools.measure import csp_stepper
    calls = []
    real = TB.halo_gather_strips_kernel

    def record(strips, idx, pad, *rest):
        calls.append((strips["cols"].shape[1], strips["cols"].shape[-1],
                      pad))
        return real(strips, idx, pad, *rest)

    monkeypatch.setattr(TB, "halo_gather_strips_kernel", record)
    cfg = TC.CSPConfig(stage_blocks=(2, 4, 6, 2))
    params, st = csp_stepper((1, 128, 256, 3), 1, torch.float32, "cpu", cfg)
    frame = torch.zeros((1, 128, 256, 3))
    st.first_step(params, st.init_state(params, seed=1), frame)
    assert calls == ([(32, 48, 1)] + [(32, 64, 1)] * 2
                     + [(32, 128, 1), (16, 256, 1)] + [(8, 512, 2)] * 2
                     + [(32, 768, 1)] + [(32, 256, 1)] * 3)
