"""The stepper's and the policy net's off-by-default lowerings in the port,
held against the JAX package with the switch on in both:

* ``OUT_BLOCKS``: ``_model_fn`` (two frames, the second a partial grid with
  padding slots, canvases by name), ``fetch_outputs``, ``_output_repr`` and
  ``_reward_grid`` on given states, at blocks of 64, 128 and 256 px (output
  blocks below, at and above the policy's 32 px);
* ``PACKED_OUT``: ``_store_dense_packed`` through ``_model_fn``;
* the fast policy's stem forms: ``assemble_policy_input_split`` (bit for
  bit) with ``_conv_stem4_split``, and the explicit space-to-depth + 1x1
  stem (``POLICY_STEM_CONV4=0``): logits and BN state at 1e-4 in fp32, and
  the REINFORCE gradients by each leaf's norm-wise relative error, as
  ``test_torch_policy.py`` holds them.

Then one port-only RN18 clip per switch (128x256, block 64, capacity 3 of
8, REINFORCE on frames 2 and 4), held against the switch-off clip: equal
grids and outputs at 1e-4 of their largest magnitude.  JAX's own
``tests/test_out_blocks.py`` holds its switch-on clip against switch-off.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import blockcopy_tpu.core.stepper as JST
import blockcopy_tpu.policy.net as JN
import blockcopy_tpu_torch.core.stepper as TST
import blockcopy_tpu_torch.models.swiftnet as TS
import blockcopy_tpu_torch.policy.net as TN
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.core.blocked import ExecCtx as JCtx, split_dense as jsplit
from blockcopy_tpu_torch.core.blocked import ExecCtx as TCtx
from blockcopy_tpu_torch.core.blocked import split_dense as tsplit
from blockcopy_tpu_torch.policy import optim as TO
from blockcopy_tpu_torch.utils.convert import params_from_jax, \
    params_to_numpy
from torch_port_util import assert_same, assert_tree, jtree, npf, tt
from torch_port_util import two_torch_threads  # noqa: F401

TOL = 1e-4
NCLS = 19
GEOMS = {64: (1, 128, 256, 3), 128: (1, 256, 512, 3), 256: (1, 256, 512, 3)}


def _assert_rel(ref, got, msg=""):
    ref, got = npf(ref), npf(got)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * scale,
                               err_msg=msg)


def _steppers(bs):
    shape = GEOMS[bs]
    ident = lambda params, pack, ctx: pack            # noqa: E731
    jst = JST.FixedCapacityStepper(ident, JST.StepperConfig(block_size=bs),
                                   shape, 2)
    tst = TST.FixedCapacityStepper(ident, TST.StepperConfig(block_size=bs),
                                   shape, 2, device="cpu")
    return jst, tst


def _logit_frames(st, rs):
    """Two frames of dense stride-4 logits and their grids (all blocks,
    then a partial grid with two padding slots)."""
    n, gh, gw = st.geom
    _, h, w, _ = st.frame_shape
    partial = np.zeros((n, gh, gw), bool)
    partial.reshape(-1)[::3] = True
    out = []
    for grid, extra in ((np.ones((n, gh, gw), bool), 0), (partial, 2)):
        x = (3 * rs.randn(n, h // 4, w // 4, NCLS)).astype(np.float32)
        out.append((x, grid, int(grid.sum()) + extra))
    return out


def _model_fn_clip(jst, tst):
    """``_model_fn`` of both steppers over two frames of logits, holding the
    outputs and the canvases by name after each (JAX's frame jitted, traced
    with the switch set)."""
    n, gh, gw = jst.geom

    @functools.partial(jax.jit, static_argnames=("cap", "building"))
    def jframe(x, grid, canvases, cap, building):
        jidx = JG.exec_indices(grid, cap)
        jctx = JCtx.blocked(jidx, n, gh, gw, canvases, building=building)
        out = jst._model_fn(None, jsplit(x, jidx, n, gh, gw), jctx)
        return jidx, out["outputs"], jctx.canvases

    jcv, tcv, kept = {}, {}, []
    for t, (x, grid, cap) in enumerate(_logit_frames(jst,
                                                     np.random.RandomState(0))):
        jidx, ref, jcv = jframe(jnp.asarray(x), jnp.asarray(grid), jcv,
                                cap=cap, building=t == 0)
        tidx = tt(jidx).long()
        tctx = TCtx.blocked(tidx, n, gh, gw, tcv, building=t == 0)
        got = tst._model_fn(None, tsplit(tt(x), tidx, n, gh, gw),
                            tctx)["outputs"]
        tcv = tctx.canvases
        assert_same(ref, got, f"frame {t}")
        assert sorted(jcv) == sorted(tcv)
        assert_tree(jtree(jcv), {k: npf(v) for k, v in tcv.items()},
                    assert_same)
        kept.append((npf(got).copy(), got))
    # the first frame's outputs are not the canvas the second updated
    assert_same(kept[0][0], kept[0][1], "frame 0 after frame 1")


@pytest.mark.parametrize("bs", sorted(GEOMS))
def test_out_blocks_hooks(bs, monkeypatch):
    monkeypatch.setattr(JST, "OUT_BLOCKS", True)
    monkeypatch.setattr(TST, "OUT_BLOCKS", True)
    jst, tst = _steppers(bs)
    _model_fn_clip(jst, tst)

    rs = np.random.RandomState(bs)
    b = bs // 4
    state = {}
    for key in ("outputs", "outputs_prev"):
        canvas = (3 * rs.randn(jst.total + 1, b, b, NCLS)).astype(np.float32)
        canvas[-1] = 0
        state[key] = canvas
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: tt(v) for k, v in state.items()}
    assert_same(jax.jit(jst.fetch_outputs)(jstate),
                tst.fetch_outputs(tstate))
    assert_same(jax.jit(jst._output_repr)(jstate), tst._output_repr(tstate))
    _assert_rel(jax.jit(jst._reward_grid)(jstate), tst._reward_grid(tstate))


@pytest.mark.parametrize("bs", [64, 128])
def test_packed_out_store(bs, monkeypatch):
    monkeypatch.setattr(JST, "PACKED_OUT", True)
    monkeypatch.setattr(TST, "PACKED_OUT", True)
    _model_fn_clip(*_steppers(bs))


# -- the policy net's stem forms ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _policy_inputs():
    rs = np.random.RandomState(7)
    frame = rs.randn(2, 256, 512, 3).astype(np.float32)
    fs = rs.randn(2, 64, 128, 3).astype(np.float32)
    out = (3 * rs.randn(2, 64, 128, NCLS)).astype(np.float32)
    grid = (rs.rand(2, 2, 4) < 0.5).astype(np.float32)
    params, bn = JN.init_policy_net(jax.random.PRNGKey(3),
                                    JN.policy_in_channels(NCLS),
                                    arch="fast", head_bias=0.3)
    # the zero-init head would hide the trunk
    params["head1"]["w"] = jnp.asarray(
        0.05 * rs.randn(*params["head1"]["w"].shape).astype(np.float32))
    signed = rs.randn(2, 2, 4).astype(np.float32)
    return (frame, fs, out, grid), params, bn, signed


@pytest.mark.parametrize("form", ["split", "s2d"])
def test_policy_stem_forms(form, monkeypatch):
    monkeypatch.setattr(JN, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TN, "COMPUTE_DTYPE", torch.float32)
    if form == "s2d":
        monkeypatch.setattr(JN, "POLICY_STEM_CONV4", False)
        monkeypatch.setattr(TN, "POLICY_STEM_CONV4", False)
    srcs, params, bn, signed = _policy_inputs()
    if form == "split":
        jx = JN.assemble_policy_input_split(*map(jnp.asarray, srcs), 128,
                                            jnp.float32)
        tx = TN.assemble_policy_input_split(*map(tt, srcs), 128,
                                            torch.float32)
        assert isinstance(tx, tuple) and len(tx) == 4
        for a, b in zip(jx, tx):
            assert_same(a, b)
    else:
        jx = JN.assemble_policy_input(*map(jnp.asarray, srcs), 128)
        tx = TN.assemble_policy_input(*map(tt, srcs), 128)
    grid = srcs[3]

    def jloss(p):
        lg, s = JN.policy_net_apply(p, bn, jx, update_stats=True,
                                    arch="fast")
        l = lg[..., 0]
        logp = grid * jax.nn.log_sigmoid(l) \
            + (1 - grid) * jax.nn.log_sigmoid(-l)
        return jnp.mean(-logp * signed), (lg, s)

    (_, (jlg, js)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    tp = params_from_jax(jtree(params), device="cpu")
    leaves = TO.tree_map(lambda a: a.clone().requires_grad_(True), tp)
    tlg, ts = TN.policy_net_apply(leaves, params_from_jax(jtree(bn),
                                                          device="cpu"),
                                  tx, update_stats=True, arch="fast")
    l = tlg[..., 0]
    g = torch.from_numpy(grid)
    loss = torch.mean(-(g * F.logsigmoid(l) + (1 - g) * F.logsigmoid(-l))
                      * torch.from_numpy(signed))
    grads = iter(torch.autograd.grad(loss, TO.tree_leaves(leaves)))
    tgrads = TO.tree_map(lambda _: next(grads), leaves)
    _assert_rel(jlg, tlg.detach())
    assert_tree(jtree(js), params_to_numpy(ts),
                lambda a, b, m: _assert_rel(a, b, m))

    def grads_close(a, b, m):        # as test_torch_policy.py holds them
        err = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
        assert err < 1e-3, (m, err)

    assert_tree(jtree(jgrads), params_to_numpy(tgrads), grads_close)


# -- port-only clips: each switch on against all off -------------------------

CLIP_SHAPE, CLIP_BS, CLIP_CAP = (1, 128, 256, 3), 64, 3
CLIP_SWITCHES = {
    "OUT_BLOCKS": (TST, "OUT_BLOCKS", True),
    "PACKED_OUT": (TST, "PACKED_OUT", True),
    "POLICY_SPLIT_STEM": (TN, "POLICY_SPLIT_STEM", True),
    "POLICY_STEM_CONV4": (TN, "POLICY_STEM_CONV4", False),
}


def _port_clip(switch=None):
    """RN18 clip through the port's stepper (fp32 policy convs): the grid
    and the fetched outputs after every frame, and the last policy."""
    patches = [(TN, "COMPUTE_DTYPE", torch.float32)]
    if switch is not None:
        patches.append(CLIP_SWITCHES[switch])
    saved = [(m, k, getattr(m, k)) for m, k, _ in patches]
    try:
        for m, k, v in patches:
            setattr(m, k, v)
        params, cfg = _clip_params()
        st = TST.FixedCapacityStepper(
            TS.make_apply_fn(cfg), TST.StepperConfig(
                block_size=CLIP_BS, policy_arch="fast", train_interval=2,
                block_target=0.4), CLIP_SHAPE, CLIP_CAP, device="cpu")
        state = st.init_state(params, seed=1)
        # RMSprop mid-training (test_torch_stepper.py): from a zero state
        # the first step moves each weight by about +-lr whatever the size
        # of its gradient, so rounding-sized gradients would not compare
        opt = state["policy"]["opt"]
        opt["square_avg"] = TO.tree_map(lambda a: torch.full_like(a, 1e-4),
                                        opt["square_avg"])
        rs = np.random.RandomState(11)
        frames = [tt(rs.randn(*CLIP_SHAPE).astype(np.float32))
                  for _ in range(4)]
        state = st.first_step(params, state, frames[0])
        out = [(npf(state["prev_grid"]), npf(st.fetch_outputs(state)))]
        for frame in frames[1:]:
            state = st.step(params, state, frame)
            out.append((npf(state["prev_grid"]),
                        npf(st.fetch_outputs(state))))
        return out, params_to_numpy(state["policy"]["params"])
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


@functools.lru_cache(maxsize=None)
def _clip_params():
    cfg = TS.SwiftNetConfig(backbone="resnet18")
    return TS.init_swiftnet(cfg, seed=0, device="cpu"), cfg


@functools.lru_cache(maxsize=None)
def _port_clip_off():
    return _port_clip()


@pytest.mark.parametrize("switch", sorted(CLIP_SWITCHES))
def test_port_clip_switch_on_matches_off(switch):
    ref, ref_pol = _port_clip_off()
    got, got_pol = _port_clip(switch)
    for t, ((g0, o0), (g1, o1)) in enumerate(zip(ref, got)):
        assert_same(g0, g1, f"grid, frame {t}")
        assert o1.shape == o0.shape == (1, 32, 64, NCLS)
        _assert_rel(o0, o1, f"outputs, frame {t}")
    # an update moves a weight by 1e-4 to 1e-3 (test_torch_stepper.py): a
    # missed or doubled one would show at this absolute tolerance
    assert_tree(ref_pol, got_pol, lambda a, b, m: np.testing.assert_allclose(
        b, a, rtol=TOL, atol=1e-5, err_msg=m))
