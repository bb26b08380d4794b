"""Clip-level data parallelism held against the JAX package: JAX's
``parallel/clip_parallel.py`` on 2 of the conftest's virtual CPU devices
(``shard_map`` over a ``Mesh``, ``pmean`` of the REINFORCE gradients)
against the port's two gloo ranks (``clip_parallel.spawn``, ``Group``'s one
``all_reduce`` a train frame), RN18 256x512, block 128, capacity 4, the
fast policy with fp32 convs, REINFORCE on every frame, a first step and two
steps.  Each rank gets its own clip and its JAX device's draws
(``stepper_draws`` of that device's key).

Each rank's grids must equal its device's; its outputs and canvases are held
within 1e-4 (of each tensor's largest magnitude: random-init activations
reach ~1e3) and its policy BN statistics within 1e-4; the averaged policy
parameters within the fast arch's 1e-3 (``test_torch_engine_rl.py``), and
bitwise equal across the ranks.  The averaged gradient is within 1e-7 of
the mean of the two ranks' own gradients.  The RMSprop state starts at a
positive ``square_avg``, as in ``test_torch_stepper.py``.  Then a world of
one (a real gloo group of one process) is bitwise the plain stepper.
"""

import datetime
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import blockcopy_tpu.models.swiftnet as JS
import blockcopy_tpu.policy.net as JN
from blockcopy_tpu.core import stepper as JST
from blockcopy_tpu.parallel import clip_parallel as JCP
from blockcopy_tpu_torch.parallel import clip_parallel as TCP
from blockcopy_tpu_torch.parallel.distributed import Group
from torch_port_util import (assert_same, assert_tree, close_rel, jtree,
                             stepper_draws)
from torch_port_util import two_torch_threads  # noqa: F401
from torch_rank_workers import clip_rank

SHAPE = (1, 256, 512, 3)
CAPACITY = 4
RANKS = 2


def clip_frames(seed):
    """One clip per rank: a square moving over that rank's noise."""
    rs = np.random.RandomState(seed)
    base = rs.randn(RANKS, *SHAPE).astype(np.float32)
    out = []
    for t in range(3):
        f = base.copy()
        f[:, :, 24 * t:24 * t + 96, 32 * t:32 * t + 96] += 2.0
        out.append(f)
    return out


@pytest.fixture(scope="module")
def runs():
    """JAX's 2-device mesh and the port's two ranks on the same inputs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JN, "COMPUTE_DTYPE", jnp.float32)
    mp.setenv("OMP_NUM_THREADS", "2")     # each spawned rank
    try:
        cfg = JS.SwiftNetConfig(backbone="resnet18")
        params = JS.init_swiftnet(jax.random.PRNGKey(0), cfg)
        stepper = JST.FixedCapacityStepper(
            JS.make_apply_fn(cfg), JST.StepperConfig(policy_arch="fast",
                                                     train_interval=1),
            SHAPE, CAPACITY)
        mesh = JCP.make_mesh(RANKS)
        state = JCP.init_parallel_state(stepper, params,
                                        jax.random.PRNGKey(4), RANKS)
        opt = state["policy"]["opt"]
        state["policy"]["opt"] = opt._replace(square_avg=jax.tree.map(
            lambda a: jnp.full_like(a, 1e-4), opt.square_avg))
        policy0 = jtree(jax.tree.map(lambda x: x[0], {
            k: v for k, v in state["policy"].items() if k != "key"}))
        frames = clip_frames(7)
        n, gh, gw = stepper.geom
        # each device's draws, from its key chain (a step draws from the
        # second half of a split and carries the first)
        draws = []
        for d in range(RANKS):
            key, mine = state["policy"]["key"][d], []
            for _ in frames[1:]:
                u, u_rank = stepper_draws({"key": key}, (n, gh, gw),
                                          n * gh * gw)
                mine.append((np.asarray(u), np.asarray(u_rank)))
                key = jax.random.split(key)[0]
            draws.append(mine)
        # the port's ranks run in their own processes while JAX compiles
        spec = TCP.make_group(RANKS, ["cpu"] * RANKS)
        port, failed = [], []

        def run_port():
            try:
                port.extend(TCP.spawn(
                    spec, clip_rank, "resnet18", SHAPE, CAPACITY, policy0,
                    jtree(params),
                    [[f[d] for f in frames] for d in range(RANKS)], draws,
                    timeout=240))
            except Exception as e:      # re-raised in the test's thread
                failed.append(e)

        thread = threading.Thread(target=run_port)
        thread.start()
        first, step = JCP.build_parallel_steps(stepper, mesh)
        jax_states = []
        for t, f in enumerate(frames):
            state = (step if t else first)(params, state, jnp.asarray(f))
            # copies: the next step donates these buffers
            jax_states.append(jax.tree.map(np.array, state))
        thread.join(300)
        assert not thread.is_alive()
        if failed:
            raise failed[0]
        yield jax_states, port
    finally:
        mp.undo()


def lane(tree, d):
    return jax.tree.map(lambda x: np.asarray(x)[d], tree)


def test_each_rank_matches_its_device(runs):
    jax_states, port = runs
    for d, (states, _) in enumerate(port):
        for t, (js, ts) in enumerate(zip(jax_states, states), start=1):
            ref = lane({k: v for k, v in js.items() if k != "policy"}, d)
            msg = f"rank {d}, frame {t}"
            assert int(ref["frame_idx"]) == int(ts["frame_idx"]) == t
            assert_same(ref["prev_grid"], ts["prev_grid"], f"{msg} grid")
            for key in ("canvases", "outputs", "outputs_prev"):
                assert_tree(ref[key], ts[key], lambda a, b, m: close_rel(
                    a, b, 1e-4, f"{msg} {key}{m}"))
            pol = lane(js["policy"], d)
            assert_tree(pol["bn_state"], ts["policy"]["bn_state"],
                        lambda a, b, m: close_rel(a, b, 1e-4,
                                                  f"{msg} bn_state{m}"))
            assert_tree(pol["params"], ts["policy"]["params"],
                        lambda a, b, m: np.testing.assert_allclose(
                            b, a, rtol=1e-3, atol=1e-5,
                            err_msg=f"{msg} params{m}"))
    # the two clips differ, so do the ranks' BN statistics (per rank, as
    # per device in JAX)
    a, b = (port[d][0][-1]["policy"]["bn_state"]["stem_bn"]["mean"]
            for d in range(RANKS))
    assert not np.array_equal(a, b)


def test_ranks_hold_one_policy(runs):
    _, port = runs
    (s0, rec0), (s1, rec1) = port
    heads = [s["policy"]["params"]["head1"]["w"] for s in s0]
    # it trained on frames 2 and 3
    assert not np.array_equal(heads[0], heads[1])
    assert not np.array_equal(heads[1], heads[2])
    for t in range(3):
        assert_tree(s0[t]["policy"]["params"], s1[t]["policy"]["params"],
                    assert_same)
        assert_tree(s0[t]["policy"]["opt"], s1[t]["policy"]["opt"],
                    assert_same)
    assert len(rec0) == len(rec1) == 2     # one average a train frame
    for (own0, mean0), (own1, mean1) in zip(rec0, rec1):
        assert_tree(mean0, mean1, assert_same)
        want = jax.tree.map(lambda a, b: (a + b) / 2, own0, own1)
        assert_tree(want, mean0, lambda a, b, m: np.testing.assert_allclose(
            b, a, rtol=0, atol=1e-7, err_msg=f"mean{m}"))
        assert any(not np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(own0), jax.tree.leaves(own1)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_world_of_one_is_the_plain_stepper():
    """A real gloo group of one process: the averaged step (one
    all_reduce, a division by 1) is bitwise the plain step."""
    from blockcopy_tpu_torch.core.stepper import (FixedCapacityStepper,
                                                  StepperConfig)
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    cfg = SwiftNetConfig(backbone="resnet18")
    params = init_swiftnet(cfg, seed=0, device="cpu")
    stepper = FixedCapacityStepper(
        make_apply_fn(cfg), StepperConfig(policy_arch="fast",
                                          train_interval=1),
        (1, 128, 256, 3), 4, device="cpu")
    frames = [torch.from_numpy(f[0]) for f in clip_frames(3)]
    frames = [f[:, :128, :256].contiguous() for f in frames]

    def run(group):
        state = TCP.init_parallel_state(stepper, params, 1, 0)
        first, step = TCP.build_parallel_steps(stepper, group)
        state = first(params, state, frames[0])
        for f in frames[1:]:
            state = step(params, state, f)
        return state

    plain = run(None)
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        one = run(Group(0, 1, "cpu", dist.group.WORLD))
    finally:
        dist.destroy_process_group()
    from blockcopy_tpu_torch.utils.convert import stepper_state_to_numpy
    assert_tree(stepper_state_to_numpy(plain), stepper_state_to_numpy(one),
                assert_same)


def test_make_group():
    assert TCP.make_group(2, ["cpu"] * 4) == TCP.GroupSpec(("cpu", "cpu"),
                                                           "gloo")
    with pytest.raises(ValueError, match="only 4 available"):
        TCP.make_group(5, ["cpu"] * 4)
    with pytest.raises(ValueError, match="NCCL"):
        TCP.make_group(2, ["cuda:0", "cuda:0"])
    spec = TCP.make_group(2, ["cuda:0", "cuda:0"], backend="gloo")
    assert spec.size == 2 and spec.backend == "gloo"
    assert TCP.rank_clips(5, 1, 2) == ([1, 3], [True, True])
    assert TCP.rank_clips(5, 0, 2, pad=True) == ([0, 2, 4], [True] * 3)
    assert TCP.rank_clips(5, 1, 2, pad=True) == ([1, 3, 4],
                                                 [True, True, False])
    assert len({TCP.rank_seed(1, r) for r in range(4)}) == 4
