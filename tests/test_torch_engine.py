"""Ladder mode held against the JAX package: the port's ``BlockCopyModel``
and the JAX one on the same parameters over 256x512 clips, quantum 0.5
(ladder {4, 8}), for the policies ``all``, ``none`` and ``random``.

The port is fed JAX's random draws (``torch_port_util.jax_draws``), so grids
are equal exactly; outputs, ``frame_state`` and every canvas are held per
frame at 1e-4 (fp32).  ``macs_by_module`` of every capacity is equal.
Batch 2 and RN50 are ``test_torch_engine_batch.py``, ``rl_semseg``
``test_torch_engine_rl.py``: one file each keeps every file short."""

import pytest
import torch

from torch_port_util import (ENGINE_H, ENGINE_W, engine_clip, engine_frame,
                             engine_pair, tt)
from torch_port_util import two_torch_threads  # noqa: F401


def _clip(jm, tm, frames):
    return [engine_frame(jm, tm, f, t) for t, f in enumerate(frames)]


@pytest.mark.parametrize("policy", ["all", "none", "random"])
def test_fixed_policies_match_jax(policy):
    jm, tm = engine_pair(policy)
    outs = _clip(jm, tm, engine_clip(4))
    jm.reset_temporal()                 # a second clip after a reset
    tm.reset_temporal()
    _clip(jm, tm, engine_clip(1, seed=1))
    assert tm.policy.stats.get_exec_percentage() == \
        jm.policy.stats.get_exec_percentage()
    assert tm.flops.frames == jm.flops.frames
    assert tm.flops.macs_per_capacity == jm.flops.macs_per_capacity
    if policy == "none":
        # reference quirk (test_engine.py:51-62): frames 1-2 execute
        # everything, then the output freezes, bit for bit, and no model
        # runs
        assert tm.flops.frames == [8, 8, 0, 0, 8]
        for o in outs[2:]:
            assert torch.equal(o, outs[1])
    if policy == "random":
        assert set(tm.flops.frames) == {4, 8}


def test_geometry_change_raises():
    _, tm = engine_pair("random")
    tm(tt(engine_clip(1)[0]))
    tm.reset_temporal()
    with pytest.raises(ValueError, match="geometry-static"):
        tm(torch.zeros((1, ENGINE_H // 2, ENGINE_W, 3)))
