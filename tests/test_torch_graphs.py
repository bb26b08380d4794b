"""The compiled, donated steps (``core/graphs.py``) on the CPU, where they
run their in-place bodies eagerly.

One 6-frame RN18 clip at 256x512, capacity 4 of 8, the fast policy,
REINFORCE every 4th frame (frame 4 trains), draws injected from JAX's key
chain (``tests/test_torch_stepper.py``), goes through three steps: JAX's
``jax.jit(step, donate_argnums=(1,))``, the port's ``step`` and the port's
``StepperGraphs`` (the step the CLIs run).  The in-place step must equal
``step`` bitwise and keep its state's storage; it is held against JAX at
1e-4 of each tensor's largest magnitude (fp32, fp32 policy convs, the
RMSprop state mid-training as in the stepper test).  The detection stepper's
in-place step and the ladder engine's per-capacity body are checked
likewise, port against port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockcopy_tpu.models.swiftnet as JS
import blockcopy_tpu.policy.net as JN
import blockcopy_tpu_torch.models.csp as TC
import blockcopy_tpu_torch.models.swiftnet as TS
import blockcopy_tpu_torch.policy.net as TN
from blockcopy_tpu.core import stepper as JST
from blockcopy_tpu_torch.core import stepper as TST
from blockcopy_tpu_torch.core.graphs import StepperGraphs
from blockcopy_tpu_torch.tasks.detection.stepper import DetectionStepper
from blockcopy_tpu_torch.utils.convert import (params_from_jax,
                                               params_to_numpy,
                                               policy_state_from_jax,
                                               stepper_state_to_numpy)
from torch_port_util import (assert_same, assert_tree, engine_clip,
                             engine_pair, jtree, moving_square_frames, npf,
                             stepper_draws, tt)
from torch_port_util import two_torch_threads  # noqa: F401

SHAPE = (1, 256, 512, 3)
CAPACITY = 4
FRAMES = 6
TOL = 1e-4


def _snapshot(state):
    """The state as numpy copies (``stepper_state_to_numpy`` shares the
    CPU tensors' memory, which the next step overwrites)."""
    return jax.tree.map(np.copy, stepper_state_to_numpy(state))


def _leaf_ptrs(state):
    return [t.data_ptr() for t in jax.tree.leaves(
        {k: v for k, v in state.items() if k != "frame_idx"},
        is_leaf=lambda x: isinstance(x, (torch.Tensor, torch.Generator)))
        if isinstance(t, torch.Tensor)]


@pytest.fixture(scope="module")
def clip():
    """The clip through JAX's jitted, donated step, the port's ``step`` and
    the port's ``StepperGraphs``: per frame, numpy snapshots of the three
    states, and the in-place state's tensor addresses."""
    mp = pytest.MonkeyPatch()
    # fp32 policy convs in both packages: a bf16 probability rounded
    # differently could land on the other side of a shared draw
    mp.setattr(JN, "COMPUTE_DTYPE", jnp.float32)
    mp.setattr(TN, "COMPUTE_DTYPE", torch.float32)
    # two threads, as ``two_torch_threads`` gives each test: a module
    # fixture is set up before it
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = TS.SwiftNetConfig(backbone="resnet18")
        # drawn by the port (JAX's eager init is slow on the CPU)
        jparams = jax.tree.map(jnp.asarray, params_to_numpy(
            TS.init_swiftnet(cfg, seed=0, device="cpu")))
        tparams = params_from_jax(jtree(jparams), device="cpu")
        kw = dict(policy_arch="fast", train_interval=4)
        jst = JST.FixedCapacityStepper(
            JS.make_apply_fn(JS.SwiftNetConfig(backbone="resnet18")),
            JST.StepperConfig(**kw), SHAPE, CAPACITY)
        tst = TST.FixedCapacityStepper(TS.make_apply_fn(cfg),
                                       TST.StepperConfig(**kw), SHAPE,
                                       CAPACITY, device="cpu")
        # jitted: eager JAX compiles every op of the initialisation
        js = jax.jit(jst.init_state)(jparams, jax.random.PRNGKey(1))
        opt = js["policy"]["opt"]
        js["policy"]["opt"] = opt._replace(square_avg=jax.tree.map(
            lambda a: jnp.full_like(a, 1e-4), opt.square_avg))

        def port_state():
            ts = tst.init_state(tparams, seed=1)
            ts["policy"] = {**policy_state_from_jax(jtree(js["policy"]),
                                                    device="cpu"),
                            "generator": ts["policy"]["generator"]}
            return ts

        eager, inplace = port_state(), port_state()
        graphs = StepperGraphs(tst)
        frames = moving_square_frames(SHAPE, FRAMES)
        jfirst = jax.jit(jst.first_step, donate_argnums=(1,))
        jstep = jax.jit(jst.step, donate_argnums=(1,))
        # one program, where eager JAX compiles each op
        draws_of = jax.jit(stepper_draws, static_argnums=(1, 2))
        n, gh, gw = jst.geom
        out = {"jax": [], "eager": [], "inplace": [], "ptrs": []}
        for t, frame in enumerate(frames):
            if t == 0:
                js = jfirst(jparams, js, jnp.asarray(frame))
                eager = tst.first_step(tparams, eager, tt(frame))
                got = graphs.first_step(tparams, inplace, tt(frame))
            else:
                u, u_rank = draws_of({"key": js["policy"]["key"]},
                                     (n, gh, gw), n * gh * gw)
                draws = (tt(u), tt(u_rank))
                js = jstep(jparams, js, jnp.asarray(frame))
                eager = tst.step(tparams, eager, tt(frame), draws=draws)
                got = graphs.step(tparams, inplace, tt(frame), draws=draws)
            assert got is inplace
            ref = jtree(js)
            ref["policy"] = {k: v for k, v in ref["policy"].items()
                             if k != "key"}
            out["jax"].append(ref)
            out["eager"].append(_snapshot(eager))
            out["inplace"].append(_snapshot(inplace))
            out["ptrs"].append(_leaf_ptrs(inplace))
        out["graphs"] = sorted(graphs.graphs)
        return out
    finally:
        torch.set_num_threads(threads)
        mp.undo()


def test_inplace_step_equals_step(clip):
    """(a) the in-place body, bitwise ``step``'s state on every frame;
    REINFORCE ran on frame 4 only."""
    for t, (ref, got) in enumerate(zip(clip["eager"], clip["inplace"]), 1):
        assert got["frame_idx"] == ref["frame_idx"] == t
        assert_tree(ref, got, lambda a, b, m: assert_same(
            a, b, f"frame {t}{m}"))
    heads = [s["policy"]["params"]["head1"]["w"] for s in clip["inplace"]]
    changed = [not np.array_equal(a, b) for a, b in zip(heads, heads[1:])]
    assert changed == [False, False, True, False, False]


def test_inplace_step_keeps_storage(clip):
    """(b) every tensor of the state keeps its storage across frames, and
    ``outputs_prev`` is the previous frame's ``outputs``."""
    assert all(p == clip["ptrs"][0] for p in clip["ptrs"])
    states = clip["inplace"]
    assert_same(states[0]["outputs"], states[0]["outputs_prev"])
    for prev, cur in zip(states, states[1:]):
        assert_same(prev["outputs"], cur["outputs_prev"])
        assert not np.array_equal(cur["outputs"], cur["outputs_prev"])


def test_captured_steps_take_three_graphs(clip):
    """One graph per kind of frame: the first step, a plain and a train
    step (here all with injected draws)."""
    assert clip["graphs"] == [("first",), ("plain", True), ("train", True)]


def test_captured_steps_match_jax(clip):
    """(c) the CLI-facing step against JAX's jitted, donated step: grids
    equal, every other tensor within 1e-4 of its largest magnitude."""
    for t, (ref, got) in enumerate(zip(clip["jax"], clip["inplace"]), 1):
        assert int(ref["frame_idx"]) == got["frame_idx"] == t
        assert_same(ref["prev_grid"], got["prev_grid"], f"grid, frame {t}")
        assert float(got["prev_grid"].sum()) == (8 if t == 1 else CAPACITY)

        def close(a, b, m):
            a, b = npf(a), npf(b)
            scale = max(1.0, float(np.abs(a).max()))
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL * scale,
                                       err_msg=f"frame {t}{m}")

        assert_tree(ref, got, close)


def test_detection_inplace_step_equals_step():
    """(d) the detection stepper's in-place body bitwise its ``step`` over
    a 3-frame clip, REINFORCE every 2nd frame: a first, a train and a plain
    step (CSP (1, 2, 2, 1) 256x256, capacity 2 of 4, the ``csp_cls`` bias 0
    and ``score_thr`` 0.6: live boxes through decode, NMS and the IoU
    gain)."""
    cfg = TC.CSPConfig(stage_blocks=(1, 2, 2, 1), score_thr=0.6)
    params = TC.init_csp(cfg, seed=0, device="cpu")
    params["head"]["csp_cls"]["b"].zero_()
    shape = (1, 256, 256, 3)
    st = DetectionStepper(cfg, TST.StepperConfig(
        block_size=128, num_classes=1, policy_arch="fast", train_interval=2),
        shape, 2, device="cpu")
    eager, inplace = st.init_state(params, seed=1), st.init_state(params,
                                                                  seed=1)
    graphs = StepperGraphs(st)
    ptrs = _leaf_ptrs(inplace)
    gen = torch.Generator().manual_seed(2)
    valid = []
    for t, frame in enumerate(moving_square_frames(shape, 3)):
        if t == 0:
            eager = st.first_step(params, eager, tt(frame))
            graphs.first_step(params, inplace, tt(frame))
        else:
            draws = (torch.rand((1, 2, 2), generator=gen),
                     torch.rand((4,), generator=gen))
            eager = st.step(params, eager, tt(frame), draws=draws)
            graphs.step(params, inplace, tt(frame), draws=draws)
        assert_tree(stepper_state_to_numpy(eager),
                    stepper_state_to_numpy(inplace),
                    lambda a, b, m: assert_same(a, b, f"frame {t + 1}{m}"))
        assert _leaf_ptrs(inplace) == ptrs
        valid.append(int(inplace["valid"].sum()))
    assert all(0 < v < 100 for v in valid), valid
    assert sorted(graphs.graphs) == [("first",), ("plain", True),
                                     ("train", True)]


def test_engine_outputs_prev_unaliased():
    """(e) the ladder engine's per-capacity body over two frames at one
    capacity (policy ``all``: 8 blocks each): ``outputs_prev`` keeps the
    first frame's output, in storage of its own, after the second frame's
    run of the same capacity's step; the graph-off engine agrees."""
    _, model = engine_pair("all")
    _, eager = engine_pair("all")
    eager.graphs = False
    frames = [tt(f) for f in engine_clip(2)]
    first = model(frames[0]).clone()
    second = model(frames[1])
    meta = model.policy_meta
    assert list(model._steps) == [8]
    assert meta["outputs_prev"].data_ptr() != meta["outputs"].data_ptr()
    assert meta["outputs_prev"].data_ptr() != model._bufs[0].data_ptr()
    assert torch.equal(meta["outputs_prev"], first)
    assert not torch.equal(first, second)
    assert torch.equal(eager(frames[0]), first)
    assert torch.equal(eager(frames[1]), second)
    assert torch.equal(meta["frame_state"], eager.policy_meta["frame_state"])
