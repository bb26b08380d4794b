"""The detection train step as the CLIs run it (``tasks/detection/train.py``
``make_train_step``: on CUDA one captured graph per input signature, JAX's
``jax.jit(make_train_step(...), donate_argnums=(0,))`` at
``blockcopy_tpu/tasks/detection/train_cli.py:98``), on the CPU, where its
body runs eagerly.

A small CSP (``stage_blocks=(1, 2, 2, 1)`` at full widths, 128x256 fp32
batches of 2) takes three steps of JAX's jitted step and, in lockstep, of
the port's step with and without ``graphs``.  The warm-up ends at step 2,
so the learning rate the host passes in changes between the calls.  The
port's ReLUs take JAX's sign masks of each step (``tools/measure.py``
``relu_masks``, as in ``tests/test_torch_train.py``), so the comparison
holds the arithmetic and not the side of a kink.  The states are compared
as they are made (each is ~0.5 GB), and the fixture keeps what was found.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockcopy_tpu.models.csp import CSPConfig as JCSPConfig
from blockcopy_tpu.tasks.detection import train as JT
from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
from blockcopy_tpu_torch.policy.optim import tree_leaves
from blockcopy_tpu_torch.tasks.detection import train as TT
from blockcopy_tpu_torch.tasks.detection.train_dataset import \
    SyntheticDetTrainDataset
from blockcopy_tpu_torch.tools.measure import relu_masks
from blockcopy_tpu_torch.utils.checkpoint import load_npz, save_params
from blockcopy_tpu_torch.utils.convert import (params_to_numpy,
                                               train_state_to_numpy)
from torch_port_util import assert_tree, npf, \
    two_torch_threads  # noqa: F401

H, W = 128, 256
STAGES = (1, 2, 2, 1)
STEPS = 3
# the validation tool's short-run schedule, its warm-up ending at step 2
TCFG = dict(lr=2e-4, warmup_iters=2, warmup_ratio=0.1, lr_steps=(),
            iters_per_epoch=10, loss_weights=(1.0, 1.0, 0.1))
LOSSES = ("loss_cls", "loss_bbox", "loss_offset", "loss_total")


def _batches():
    ds = SyntheticDetTrainDataset(2 * STEPS, H, W, seed=5)
    out = []
    for i in range(STEPS):
        items = [ds[2 * i], ds[2 * i + 1]]
        out.append((np.stack([it[0] for it in items]),
                    tuple(np.stack([it[1 + j] for it in items])
                          for j in range(3))))
    return out


def _state(seed):
    return TT.init_train_state(
        init_csp(CSPConfig(stage_blocks=STAGES), seed=seed, device="cpu"),
        TT.TrainConfig(**TCFG))


def _make_step(graphs):
    return TT.make_train_step(CSPConfig(stage_blocks=STAGES),
                              TT.TrainConfig(**TCFG), "cpu", graphs=graphs)


def _held(state):
    return tree_leaves({k: state[k] for k in TT.HELD})


def _leaf_close(tol):
    def check(ref, got, msg):
        ref, got = npf(ref), npf(got)
        scale = float(np.abs(ref).max()) if ref.size else 0.0
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale + 1e-30,
                                   err_msg=msg)
    return check


def _adam_close(tol, bound, outside):
    """Each leaf within ``tol`` of its largest |JAX value|; the elements
    outside it go to ``outside`` and stay within ``bound``."""
    def check(ref, got, msg):
        ref, got = npf(ref), npf(got)
        d = np.abs(got.astype(np.float64) - ref)
        off = d[d > tol * float(np.abs(ref).max())]
        outside.extend(off.tolist())
        assert not (off > bound).any(), (msg, float(off.max()), bound)
    return check


def _against_jax(ref, got, step, losses, ref_losses):
    """The port's state and losses after ``step`` against JAX's (see
    ``test_captured_step_against_jax``); returns, for ``params`` and
    ``ema_params``, the number of elements outside 1e-4 of their leaf's
    largest |JAX value| and the number that may be."""
    for k in LOSSES:
        np.testing.assert_allclose(losses[k], ref_losses[k], rtol=1e-5,
                                   err_msg=k)
    assert int(got["step"]) == int(ref["step"]) == step
    for k in ("m", "v"):
        assert_tree(ref[k], got[k], _leaf_close(1e-4), f"step {step} {k}")
    tcfg = TT.TrainConfig(**TCFG)
    bound = 2 * sum(TT.lr_at(s, tcfg) for s in range(1, step + 1))
    out = {}
    for k in ("params", "ema_params"):
        outside = []
        assert_tree(ref[k], got[k], _adam_close(1e-4, bound, outside),
                    f"step {step} {k}")
        size = sum(np.size(x) for x in jax.tree.leaves(ref[k]))
        out[k] = (len(outside), 1e-5 * size)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three steps in lockstep: JAX's jitted step, which returns each
    step's ReLU sign masks (``layers.relu``, in call order), then the
    port's step with ``graphs`` and without on those masks.  After each
    step: the graphs state against JAX's (an AssertionError is kept for
    the test to raise), whether the two port states and losses are
    bitwise equal, the host steps, the losses as returned and as floats.
    The graphs state after step 1 is saved as the CLI saves it."""
    from blockcopy_tpu.ops import layers as JL

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    orig_relu = JL.relu
    record = []

    def relu(x):
        record.append(x > 0)
        return orig_relu(x)

    def with_masks(step_fn):
        # the masks leave the jitted step as an output of it
        def fn(state, images, maps):
            record.clear()
            state, losses = step_fn(state, images, maps)
            return state, losses, list(record)
        return fn

    saved = str(tmp_path_factory.mktemp("train") / "latest_state.npz")
    out = {"batches": _batches(), "saved": saved, "masks": [], "jax": [],
           "bitwise": [], "losses": [], "steps": {True: [], False: []},
           "floats": {True: [], False: []}}
    steps = {g: _make_step(g) for g in (True, False)}
    states = {g: _state(0) for g in (True, False)}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JL, "relu", relu)
            jstep = jax.jit(with_masks(JT.make_train_step(
                JCSPConfig(stage_blocks=STAGES), JT.TrainConfig(**TCFG))))
            jstate = JT.init_train_state(
                jax.tree.map(jnp.asarray, params_to_numpy(
                    states[True]["params"])), JT.TrainConfig(**TCFG))
            for i, (images, maps) in enumerate(out["batches"]):
                jstate, jlosses, relus = jstep(
                    jstate, jnp.asarray(images),
                    tuple(map(jnp.asarray, maps)))
                masks = [np.asarray(m) for m in relus]
                out["masks"].append(masks)
                losses = {}
                for g in (True, False):
                    with relu_masks(force=masks, flips=[]):
                        states[g], losses[g] = steps[g](states[g], images,
                                                        maps)
                    out["steps"][g].append(int(states[g]["step"]))
                    out["floats"][g].append({k: losses[g][k].item()
                                             for k in LOSSES})
                out["losses"].append(losses[True])
                out["bitwise"].append(all(
                    torch.equal(a, b) for a, b in zip(
                        _held(states[True]) + list(losses[True].values()),
                        _held(states[False])
                        + list(losses[False].values()))))
                try:
                    found = _against_jax(
                        jax.tree.map(np.asarray, jstate),
                        train_state_to_numpy(states[True]), i + 1,
                        out["floats"][True][i],
                        {k: float(jlosses[k]) for k in LOSSES})
                except AssertionError as e:
                    found = e
                out["jax"].append(found)
                if i == 0:
                    save_params(saved, states[True])
        out["step_fns"], out["final"] = steps, states[True]
        yield out
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_captured_step_against_jax(runs, step):
    """After each step, across the warm-up's end: the losses within 1e-5
    relative, every leaf of ``m`` and ``v`` within 1e-4 of its largest
    |JAX value|, and so every leaf of ``params`` and ``ema_params`` but
    for at most 1e-5 of their elements.  Adam divides each element by its
    own gradient scale, so where a gradient sits within the gradients'
    tolerance of 0 (``test_torch_train.py`` holds them to 1e-4 of each
    leaf's largest) the two frameworks may step it by up to ``lr`` either
    way; those few stay within ``2 * sum(lr)`` of JAX, the farthest two
    runs of Adam's normalised step (|m_hat| / sqrt(v_hat) of about 1 at
    most) can part in these steps.  (Measured: 44-60 elements of 29.4M,
    at most 1.35 of step 1's ``lr``, beside 3.5e-5 on ``m`` and ``v``.)"""
    found = runs["jax"][step - 1]
    if isinstance(found, AssertionError):
        raise found
    for k, (n, most) in found.items():
        assert n <= most, (k, n, most)


def test_captured_step_bitwise_eager(runs):
    """``graphs=True`` and ``graphs=False`` run one body on the same
    tensor inputs: every state tensor and loss bitwise after every step."""
    assert runs["bitwise"] == [True] * STEPS
    assert runs["floats"][True] == runs["floats"][False]


def test_host_step_and_loss_buffers(runs):
    """The host step advances once a call, outside the body; one input
    signature keys one graph; the losses are the graph's buffers (on the
    CPU too), which the next call overwrites, so a kept loss is a clone."""
    assert runs["steps"][True] == runs["steps"][False] \
        == list(range(1, STEPS + 1))
    calls = runs["step_fns"][True].calls
    assert len(calls.graphs) == 1 and runs["step_fns"][False].calls is None
    first, last = runs["losses"][0], runs["losses"][-1]
    assert all(first[k] is last[k] for k in LOSSES)
    floats = runs["floats"][True]
    assert {k: first[k].item() for k in LOSSES} == floats[-1] != floats[0]


def test_resumed_state_continues_bitwise(runs):
    """The state saved after step 1 (``save_params``, as the CLI's
    ``latest_state.npz``), loaded with ``copy_`` into the tensors of
    another state that a captured step has already used
    (``load_train_state_``), continues bitwise with the unbroken run
    through steps 2-3, in the same storage."""
    step, state = _make_step(True), _state(1)
    with relu_masks(force=runs["masks"][0], flips=[]):
        state, _ = step(state, *runs["batches"][0])
    ptrs = [t.data_ptr() for t in _held(state)]
    TT.load_train_state_(state, load_npz(runs["saved"], state,
                                         device="cpu"))
    assert int(state["step"]) == 1
    for i in range(1, STEPS):
        with relu_masks(force=runs["masks"][i], flips=[]):
            state, losses = step(state, *runs["batches"][i])
        assert int(state["step"]) == i + 1
        assert {k: losses[k].item() for k in LOSSES} \
            == runs["floats"][True][i]
    assert [t.data_ptr() for t in _held(state)] == ptrs
    assert all(torch.equal(a, b)
               for a, b in zip(_held(state), _held(runs["final"])))
