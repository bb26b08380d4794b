"""Ladder mode with ``rl_semseg`` held against the JAX package: the port's
``BlockCopyModel`` and the JAX one on the same parameters over a 4-frame
256x512 clip, REINFORCE on frames 2 and 4, the port fed JAX's draws
(grids equal; outputs, ``frame_state``, canvases and BN state at 1e-4),
for both policy architectures.

The policy's update is held as ``test_torch_policy.py`` holds gradients:
the RMSprop state starts mid-training (a positive ``square_avg``), so each
leaf's change is its gradient scaled by that state, and each leaf is held by
its norm-wise relative error.  Two checks per train frame:

* the port's ``optim`` on JAX's own inputs (outputs, policy input, grid and
  pre-update state);
* the update each package made from its own inputs.

Measured on this clip (norm-wise, frames 2 / 4): ``fast`` 1.7e-5 / 9.2e-5 on
JAX's inputs and 1.7e-5 / 7.0e-3 on its own; ``ref`` 4.8e-3 / 1.0e-2 and
5.9e-3 / 1.5e-2.  At this random init the ``ref`` net's train-mode BN over
few positions and its ReLU kinks turn rounding-order differences of ~1e-7
into ~1e-2 of some gradients, so ``ref`` is held at 3e-2 and ``fast`` at
1e-3 (JAX's inputs) and 2e-2 (its own).  After each update the port's policy
is set to JAX's, so the clip goes on from one state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockcopy_tpu.policy.net as JN
import blockcopy_tpu_torch.policy.net as TN
from blockcopy_tpu_torch.utils.convert import (ladder_policy_state_from_jax,
                                               params_to_numpy)
from torch_port_util import (assert_same, assert_tree, close_rel,
                             engine_clip, engine_frame, engine_pair, jtree,
                             tt)
from torch_port_util import two_torch_threads  # noqa: F401

# arch: (tolerance on JAX's inputs, on each package's own)
TOLS = {"fast": (1e-3, 2e-2), "ref": (3e-2, 3e-2)}


def _update_err(before, after_ref, after_got):
    """Largest norm-wise relative error over the leaves of the update
    ``after - before`` (``before``: JAX's and the port's)."""
    errs = []
    for jo, jn, to, tn in zip(*(jax.tree.leaves(t) for t in
                                (before[0], after_ref, before[1],
                                 after_got))):
        da, db = jn - jo, tn - to
        if not np.any(da):       # zero gradient on a zero weight
            assert not np.any(db)
            continue
        errs.append(np.linalg.norm(db - da) / max(np.linalg.norm(da),
                                                  1e-30))
    return max(errs)


@pytest.mark.parametrize("arch", ["fast", "ref"])
def test_rl_semseg_matches_jax(monkeypatch, arch):
    # fp32 policy convs in both packages: a bf16 probability rounded
    # differently could land on the other side of a shared draw
    monkeypatch.setattr(JN, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TN, "COMPUTE_DTYPE", torch.float32)
    tol_same, tol_own = TOLS[arch]
    jm, tm = engine_pair("rl_semseg", block_train_interval=2,
                         block_policy_arch=arch)
    opt = jm.policy.opt_state
    jm.policy.opt_state = opt._replace(square_avg=jax.tree.map(
        lambda a: jnp.full_like(a, 1e-4), opt.square_avg))

    def carry():
        tm.policy.load_state(ladder_policy_state_from_jax(
            jtree(jm.policy.state()), device="cpu"))

    carry()
    for t, f in enumerate(engine_clip(4)):
        pre = jtree(jm.policy.state())
        before = (pre["net_params"], params_to_numpy(tm.policy.net_params))
        engine_frame(jm, tm, f, t)
        ref, got = jtree(jm.policy.state()), tm.policy.state()
        assert got["running_cost"] == pytest.approx(ref["running_cost"],
                                                    rel=1e-12)
        assert_tree(ref["bn_state"], params_to_numpy(got["bn_state"]),
                    lambda a, b, m: close_rel(a, b, 1e-4, f"bn_state{m}"))
        if t not in (1, 3):            # no update off the train frames
            assert_tree(before[0], ref["net_params"], assert_same)
            assert_tree(before[1], params_to_numpy(got["net_params"]),
                        assert_same)
            continue
        assert _update_err(before, ref["net_params"],
                           params_to_numpy(got["net_params"])) < tol_own
        # the port's optim on JAX's inputs and pre-update state
        jmeta = jm.policy_meta
        tm.policy.load_state(ladder_policy_state_from_jax(
            {**pre, "bn_state": ref["bn_state"]}, device="cpu"))
        tm.policy.optim({"outputs": tt(jmeta["outputs"]),
                         "outputs_prev": tt(jmeta["outputs_prev"]),
                         "perc_exec": jmeta["perc_exec"],
                         "_rl_cache": tt(jmeta["_rl_cache"]),
                         "grid": tt(jmeta["grid"])}, train=True)
        assert tm.policy.running_cost == pytest.approx(ref["running_cost"],
                                                       rel=1e-12)
        pair = (pre["net_params"], pre["net_params"])
        assert _update_err(pair, ref["net_params"], params_to_numpy(
            tm.policy.net_params)) < tol_same
        carry()
    assert tm.flops.frames == jm.flops.frames
    assert tm.flops.macs_per_capacity == jm.flops.macs_per_capacity
    assert tm.flops.average_macs_by_module() == pytest.approx(
        jm.flops.average_macs_by_module(), rel=1e-12)
