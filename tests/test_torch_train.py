"""Detection training: the port's GT maps, losses, LR schedule, gradients
and Adam + mean-teacher update against the JAX package's
(``blockcopy_tpu/tasks/detection/train.py``) on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blockcopy_tpu.models.csp import CSPConfig as JCSPConfig
from blockcopy_tpu.tasks.detection import train as JT
from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
from blockcopy_tpu_torch.policy.optim import tree_leaves
from blockcopy_tpu_torch.tasks.detection import train as TT
from blockcopy_tpu_torch.tasks.detection.train_dataset import \
    SyntheticDetTrainDataset
from blockcopy_tpu_torch.tools.measure import relu_masks
from blockcopy_tpu_torch.utils.convert import (params_from_jax,
                                               params_to_numpy,
                                               train_state_from_jax,
                                               train_state_to_numpy)
from torch_port_util import assert_tree, jtree, npf, tt, \
    two_torch_threads  # noqa: F401

H, W = 128, 256
STAGES = (1, 2, 2, 1)


# -- GT maps ----------------------------------------------------------------


def _boxes(rs, n, h, w):
    """Boxes inside the image, as the crop leaves them (``_crop_boxes``),
    some thinner or shorter than the stride."""
    x1 = rs.uniform(0, w - 4, n)
    y1 = rs.uniform(0, h - 4, n)
    x2 = np.minimum(x1 + rs.uniform(2, 90, n), w)
    y2 = np.minimum(y1 + rs.uniform(2, 160, n), h)
    return np.stack([x1, y1, x2, y2], 1).astype(np.float32)


GT_CASES = {
    "random": lambda rs: (_boxes(rs, 7, 256, 512), _boxes(rs, 3, 256, 512)),
    "no_ignore": lambda rs: (_boxes(rs, 5, 256, 512), None),
    "empty_gts": lambda rs: (np.zeros((0, 4), np.float32),
                             _boxes(rs, 2, 256, 512)),
    "empty_both": lambda rs: (np.zeros((0, 4), np.float32),
                              np.zeros((0, 4), np.float32)),
    "edges": lambda rs: (np.array([[0, 0, 33, 80], [479, 176, 512, 256],
                                   [0, 200, 40, 256], [500, 0, 512, 90],
                                   [100.5, 3.25, 141.75, 99.5]], np.float32),
                         np.array([[0, 0, 512, 4], [508, 0, 512, 256]],
                                  np.float32)),
}


@pytest.mark.parametrize("case", sorted(GT_CASES))
@pytest.mark.parametrize("radius,stride", [(8, 4), (12, 4)])
def test_calc_gt_center_bitwise(case, radius, stride):
    gts, igs = GT_CASES[case](np.random.RandomState(3))
    ref = JT.calc_gt_center(gts, igs, (256, 512), radius=radius,
                            stride=stride)
    got = TT.calc_gt_center(gts, igs, (256, 512), radius=radius,
                            stride=stride)
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype
        np.testing.assert_array_equal(g, r)


# -- losses -----------------------------------------------------------------


def _loss_inputs(seed):
    rs = np.random.RandomState(seed)
    maps = [TT.calc_gt_center(_boxes(rs, 4, H, W), _boxes(rs, 1, H, W),
                              (H, W)) for _ in range(2)]
    pos, scale, offset = (np.stack([m[i] for m in maps]) for i in range(3))
    # log-height targets of about 0 inside the mask (a box of exactly the
    # stride's height): the loss masks them out
    ys, xs = np.nonzero(scale[0, ..., 1])
    scale[0, ys[:3], xs[:3], 0] = np.float32([0.0, 1e-7, -5e-7])
    cls = rs.randn(2, H // 4, W // 4, 1).astype(np.float32) * 3
    reg = rs.randn(2, H // 4, W // 4, 1).astype(np.float32) + 3
    off = rs.randn(2, H // 4, W // 4, 2).astype(np.float32)
    return (cls, reg, off), (pos, scale, offset)


@pytest.mark.parametrize("weights", [(0.01, 1.0, 0.1), (1.0, 1.0, 0.1)])
def test_losses(weights):
    outs, maps = _loss_inputs(0)
    ref = JT.csp_loss(tuple(map(jnp.asarray, outs)),
                      tuple(map(jnp.asarray, maps)), weights=weights)
    got = TT.csp_loss(tuple(map(tt, outs)), tuple(map(tt, maps)),
                      weights=weights)
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    # each term alone
    for jf, tf, i in ((JT.cls_pos_loss, TT.cls_pos_loss, 0),
                      (JT.reg_pos_loss, TT.reg_pos_loss, 1),
                      (JT.offset_pos_loss, TT.offset_pos_loss, 2)):
        np.testing.assert_allclose(
            tf(tt(outs[i]), tt(maps[i])).item(),
            float(jf(jnp.asarray(outs[i]), jnp.asarray(maps[i]))), rtol=1e-5)


def test_reg_loss_masks_zero_log_height():
    """A target of about 0 contributes nothing, in both packages."""
    outs, (pos, scale, offset) = _loss_inputs(1)
    ys, xs = np.nonzero(scale[1, ..., 1])
    only = np.zeros_like(scale)
    only[1, ys[0], xs[0]] = [1e-8, 1.0]
    for f, conv in ((JT.reg_pos_loss, jnp.asarray), (TT.reg_pos_loss, tt)):
        assert float(f(conv(outs[1]), conv(only))) == 0.0


# -- LR schedule ------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(lr=1e-3, warmup_iters=10, warmup_ratio=0.5, iters_per_epoch=100,
         lr_steps=(2, 4)),
    dict(lr=2e-4, warmup_iters=50, warmup_ratio=0.1, iters_per_epoch=400,
         lr_steps=()),
])
def test_lr_at(cfg):
    jc, tc = JT.TrainConfig(**cfg), TT.TrainConfig(**cfg)
    steps = {0, 1, jc.warmup_iters - 1, jc.warmup_iters, jc.warmup_iters + 1}
    for s in jc.lr_steps:
        b = s * jc.iters_per_epoch
        steps |= {b - 1, b, b + 1}
    for step in sorted(x for x in steps if x >= 0):
        ref = np.float32(JT.lr_at(jnp.int32(step), jc))
        assert TT.lr_at(step, tc) == float(ref), step


# -- gradients and the update, against JAX's own train step -----------------


def _batch():
    ds = SyntheticDetTrainDataset(2, H, W, seed=5)
    items = [ds[i] for i in range(2)]
    return (np.stack([it[0] for it in items]),
            tuple(np.stack([it[1 + i] for it in items]) for i in range(3)))


@pytest.fixture(scope="module")
def jax_run():
    """Two steps of JAX's jitted train step on a small CSP, with what each
    step's ``jax.value_and_grad`` saw: the gradients it returned and the
    sign mask of every ReLU input (``layers.relu``, in call order)."""
    from blockcopy_tpu.ops import layers as JL

    tp = init_csp(CSPConfig(stage_blocks=STAGES), seed=0, device="cpu")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    tcfg = dict(lr=1e-3, warmup_iters=1, warmup_ratio=0.5, lr_steps=(),
                iters_per_epoch=10, loss_weights=(1.0, 1.0, 0.1))
    orig_vg, orig_relu = jax.value_and_grad, JL.relu
    masks = []

    def relu(x):
        masks.append(x > 0)
        return orig_relu(x)

    def recording(fn, **kw):
        def fn_masks(*a):
            masks.clear()
            loss, aux = fn(*a)
            return loss, {**aux, "relu_pos": list(masks)}
        f = orig_vg(fn_masks, **kw)

        def g(*a):
            (loss, aux), grads = f(*a)
            return (loss, {**aux, "grads": grads}), grads
        return g

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "value_and_grad", recording)
        mp.setattr(JL, "relu", relu)
        step = jax.jit(JT.make_train_step(JCSPConfig(stage_blocks=STAGES),
                                          JT.TrainConfig(**tcfg)))
        images, maps = _batch()
        state = JT.init_train_state(jp, JT.TrainConfig(**tcfg))
        states, losses = [jtree(state)], []
        for _ in range(2):
            state, out = step(state, jnp.asarray(images),
                              tuple(map(jnp.asarray, maps)))
            states.append(jtree(state))
            losses.append(jtree(out))
    return {"tcfg": tcfg, "images": images, "maps": maps, "states": states,
            "losses": losses}


def _leaf_close(tol):
    def check(ref, got, msg):
        ref, got = npf(ref), npf(got)
        scale = float(np.abs(ref).max()) if ref.size else 0.0
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale + 1e-30,
                                   err_msg=msg)
    return check


@pytest.mark.parametrize("step", [0, 1])
def test_loss_and_grads(jax_run, step):
    """At the params of JAX's steps 1 and 2: losses within 1e-5 relative
    and every gradient leaf within 1e-4 of its largest |JAX value|, over the
    same key set (every float leaf).

    A ReLU input within rounding of 0 can take the other side of the kink
    in the other framework, and then every gradient upstream of it differs
    by up to 1e-2 of the leaf (as fp32 against fp64 does on this CSP at
    random init).  So the port's ReLUs take JAX's sign masks
    (``tools/measure.py`` ``relu_masks``), after the test checks that the
    masks disagree only within rounding of 0: the comparison then holds the
    arithmetic, not the side of a kink."""
    ref = jax_run["losses"][step]
    flips = []
    params = params_from_jax(jax_run["states"][step]["params"], device="cpu")
    with relu_masks(force=ref["relu_pos"], flips=flips):
        losses, grads = TT.loss_and_grads(
            params, tt(jax_run["images"]), tuple(map(tt, jax_run["maps"])),
            CSPConfig(stage_blocks=STAGES), jax_run["tcfg"]["loss_weights"])
    # every ReLU took a mask, and they disagree only within rounding of 0
    assert len(flips) == len(ref["relu_pos"])
    assert sum(f[0] for f in flips) <= 8 and max(f[1] for f in flips) <= 1e-5
    for k in ("loss_cls", "loss_bbox", "loss_offset", "loss_total"):
        np.testing.assert_allclose(losses[k].item(), float(ref[k]),
                                   rtol=1e-5, err_msg=k)
    assert_tree(ref["grads"], params_to_numpy(grads), _leaf_close(1e-4))


def test_adam_ema_update_from_jax_grads(jax_run):
    """Fed JAX's gradients, the port's update lands within 1e-6 of JAX's
    params, moments and teacher after each of two steps."""
    tcfg = TT.TrainConfig(**jax_run["tcfg"])
    state = train_state_from_jax(jax_run["states"][0], device="cpu")
    # the teacher is a copy, not an alias
    state0 = TT.init_train_state(state["params"], tcfg)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        tree_leaves(state0["params"]), tree_leaves(state0["ema_params"])))
    for i in range(2):
        grads = params_from_jax(jax_run["losses"][i]["grads"], device="cpu")
        state = TT.adam_ema_update(state, grads, tcfg)
        ref = jax_run["states"][i + 1]
        got = train_state_to_numpy(state)
        assert int(got["step"]) == int(ref["step"]) == i + 1
        for k in ("params", "m", "v", "ema_params"):
            assert_tree(ref[k], got[k], _leaf_close(1e-6), f"step {i + 1} {k}")
