"""The slice as a whole: ``FixedCapacityStepper`` of the port held against
the JAX stepper over a 4-frame RN18 clip (``init_state``, ``first_step``, 3
steps, ``train_interval=2`` so frames 2 and 4 run a REINFORCE update).

The port is fed the uniforms JAX draws: the test replays JAX's key chain
(``stepper.py:456`` split, then ``:367-371``) and passes them as ``draws``.
Grids and executed indices must be equal exactly.  Outputs, carried canvases
and policy state are held at 1e-3 in fp32: the clip runs 4 frames deep
through random-init RN18 (activations reach ~1e3, so the absolute tolerance
is 1e-3 of each tensor's largest magnitude) and includes RMSprop steps.  The RMSprop state starts mid-training (a
positive ``square_avg``): from a zero state the first step moves every
weight by +-lr/sqrt(1-alpha) whatever its gradient's size, so a gradient
that is 0 in one package and 1e-9 in the other would differ by 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import blockcopy_tpu.models.swiftnet as JS
import blockcopy_tpu.policy.net as JN
import blockcopy_tpu_torch.models.swiftnet as TS
import blockcopy_tpu_torch.policy.net as TN
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.core import stepper as JST
from blockcopy_tpu_torch.core import grid as TG
from blockcopy_tpu_torch.core import stepper as TST
from blockcopy_tpu_torch.utils.convert import (params_from_jax,
                                               policy_state_from_jax,
                                               stepper_state_from_jax,
                                               stepper_state_to_numpy)
from torch_port_util import assert_same, assert_tree, jtree, npf, tt
from torch_port_util import two_torch_threads  # noqa: F401

SHAPE = (1, 256, 512, 3)
CAPACITY = 4
TOL = 1e-3


def _frames(count, seed=0):
    """Synthetic moving frames: a bright square sliding over fixed noise."""
    base = np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)
    out = []
    for t in range(count):
        f = base.copy()
        s = 24 * t
        f[:, s:s + 96, s:s + 96] += 2.0
        out.append(f)
    return out


def _jax_draws(policy_state, probs_shape, total):
    """The uniforms JAX's ``step`` draws from this policy state's key."""
    _, k_use = jax.random.split(policy_state["key"])
    k1, k2 = jax.random.split(k_use)
    return (jax.random.uniform(k1, probs_shape),
            jax.random.uniform(k2, (total,)))


def _close(ref, got, msg):
    ref, got = npf(ref), npf(got)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * scale,
                               err_msg=msg)


def _compare_states(js, ts, frame):
    ref = jtree({k: v for k, v in js.items()})
    ref["policy"] = {k: v for k, v in ref["policy"].items() if k != "key"}
    got = stepper_state_to_numpy(ts)
    assert int(ref["frame_idx"]) == got["frame_idx"] == frame
    assert_same(ref["prev_grid"], got["prev_grid"], f"grid, frame {frame}")
    assert sorted(ref["canvases"]) == sorted(got["canvases"])
    for key in ("canvases", "outputs", "outputs_prev"):
        assert_tree(ref[key], got[key],
                    lambda a, b, m: _close(a, b, f"frame {frame} {key}{m}"))
    pol_ref, pol_got = dict(ref["policy"]), dict(got["policy"])
    # an update moves a weight by 1e-4 to 1e-3, so the parameters are held
    # with a small absolute tolerance: a missed or doubled update would show
    assert_tree(pol_ref.pop("params"), pol_got.pop("params"),
                lambda a, b, m: np.testing.assert_allclose(
                    b, a, rtol=TOL, atol=1e-5, err_msg=f"frame {frame}{m}"))
    assert_tree(pol_ref, pol_got,
                lambda a, b, m: _close(a, b, f"frame {frame} policy{m}"))


def test_clip_matches_jax(monkeypatch):
    # fp32 policy convs in both packages: a bf16 probability rounded
    # differently could land on the other side of a shared draw
    monkeypatch.setattr(JN, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TN, "COMPUTE_DTYPE", torch.float32)
    jcfg, tcfg = (JS.SwiftNetConfig(backbone="resnet18"),
                  TS.SwiftNetConfig(backbone="resnet18"))
    jparams = JS.init_swiftnet(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jtree(jparams), device="cpu")
    kw = dict(policy_arch="fast", train_interval=2)
    jst = JST.FixedCapacityStepper(JS.make_apply_fn(jcfg),
                                   JST.StepperConfig(**kw), SHAPE, CAPACITY)
    tst = TST.FixedCapacityStepper(TS.make_apply_fn(tcfg),
                                   TST.StepperConfig(**kw), SHAPE, CAPACITY,
                                   device="cpu")
    js = jst.init_state(jparams, jax.random.PRNGKey(1))
    opt = js["policy"]["opt"]
    js["policy"]["opt"] = opt._replace(square_avg=jax.tree.map(
        lambda a: jnp.full_like(a, 1e-4), opt.square_avg))
    ts = tst.init_state(tparams, seed=1)
    assert_tree(jtree(js["canvases"]), stepper_state_to_numpy(ts)["canvases"],
                assert_same)
    ts["policy"] = {**policy_state_from_jax(jtree(js["policy"]),
                                          device="cpu"),
                    "generator": ts["policy"]["generator"]}

    frames = _frames(4)
    js = jst.first_step(jparams, js, jnp.asarray(frames[0]))
    ts = tst.first_step(tparams, ts, tt(frames[0]))
    _compare_states(js, ts, 1)
    heads = [npf(ts["policy"]["params"]["head1"]["w"])]
    n, gh, gw = jst.geom
    for t, frame in enumerate(frames[1:], start=2):
        u, u_rank = _jax_draws(js["policy"], (n, gh, gw), n * gh * gw)
        js = jst.step(jparams, js, jnp.asarray(frame))
        ts = tst.step(tparams, ts, tt(frame), draws=(tt(u), tt(u_rank)))
        _compare_states(js, ts, t)
        assert float(ts["prev_grid"].sum()) == CAPACITY
        assert_same(JG.exec_indices(js["prev_grid"] > 0, CAPACITY),
                    TG.exec_indices(ts["prev_grid"] > 0, CAPACITY))
        heads.append(npf(ts["policy"]["params"]["head1"]["w"]))
    # REINFORCE ran on frames 2 and 4 only
    changed = [not np.array_equal(a, b) for a, b in zip(heads, heads[1:])]
    assert changed == [True, False, True]
    # the converter's two directions are inverse on the carried state
    ref = jtree(js)
    ref["policy"] = {k: v for k, v in ref["policy"].items() if k != "key"}
    back = stepper_state_from_jax(jtree(js), device="cpu")
    assert_tree(ref, stepper_state_to_numpy(back), assert_same)


def test_sample_grid_keeps_capacity():
    """Without injected draws the grid comes from the stepper's generator
    and still holds exactly ``capacity`` blocks."""
    st = TST.FixedCapacityStepper(None, TST.StepperConfig(), SHAPE, CAPACITY,
                                  device="cpu")
    gen = torch.Generator().manual_seed(0)
    for p in (0.0, 0.3, 1.0):
        grid = st._sample_grid(torch.full((1, 2, 4), p), generator=gen)
        assert grid.dtype == torch.bool and int(grid.sum()) == CAPACITY
