"""Ladder mode held against the JAX package at batch 2 and with RN50, as
``test_torch_engine.py`` does for the policies: the port fed JAX's draws,
grids equal, outputs, ``frame_state`` and every canvas at 1e-4 (fp32)."""

from torch_port_util import (ENGINE_BS, ENGINE_H, ENGINE_W, engine_clip,
                             engine_frame, engine_pair)
from torch_port_util import two_torch_threads  # noqa: F401


def test_batch2_matches_jax():
    """The grid is drawn and quantized jointly over the batch; each image
    keeps its own canvas rows."""
    jm, tm = engine_pair("random")
    for t, f in enumerate(engine_clip(3, n=2)):
        out = engine_frame(jm, tm, f, t)
    assert tuple(out.shape) == (2, ENGINE_H // 4, ENGINE_W // 4, 19)
    assert tm.policy_meta["num_total"] == \
        2 * (ENGINE_H // ENGINE_BS) * (ENGINE_W // ENGINE_BS)
    assert tm.flops.macs_per_capacity == jm.flops.macs_per_capacity


def test_rn50_matches_jax():
    """RN50's stride-1 bottlenecks run the fused tail's path (its plain
    version on the CPU), at capacities 8 and 4."""
    jm, tm = engine_pair("random", backbone="resnet50")
    for t, f in enumerate(engine_clip(3)):
        engine_frame(jm, tm, f, t)
    assert 4 in tm.flops.frames
    assert tm.flops.macs_per_capacity == jm.flops.macs_per_capacity
