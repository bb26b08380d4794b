"""Clip-parallel evaluation through the port's semseg CLI on the CPU, as
``tests/test_mesh_eval.py`` does for the JAX CLI: ``--num-devices 2`` (two
spawned gloo ranks) against ``--num-devices 1`` on the same synthetic clips
(REINFORCE every 2nd frame, so the averaged update runs): equal
``perc_exec`` and ``gmacs_per_image``, mIoU within 0.02 (the policy's update
schedule differs: sequential clips against an average over two parallel
clips).  At ``--block-target 1.0`` every block runs every frame, so the
class maps do not depend on the policy: there the two ranks' summed
confusion matrix must give one rank's metrics to rounding, and rank 0 must
count every rank's images.  An over-count raises.  Mesh-mode policy checkpoints: an ``.npz``
path is rank 0's replica, which the next two-rank run loads on both ranks;
a per-rank directory restores each rank's own state (its BN statistics and
generator too); an orbax directory of the JAX package is refused.
"""

import logging
import os
import re

import numpy as np
import pytest
import torch

from blockcopy_tpu_torch.core.stepper import (FixedCapacityStepper,
                                              StepperConfig)
from blockcopy_tpu_torch.parallel import clip_parallel
from blockcopy_tpu_torch.tasks.semseg import eval as tcli
from blockcopy_tpu_torch.utils import policy_ckpt as tpc
from torch_port_util import assert_same, assert_tree
from torch_port_util import two_torch_threads  # noqa: F401
from torch_rank_workers import kept_confusion_matrices, semseg_cli_rank

COMMON = ["--synthetic", "--res", "256", "--clip-length", "3",
          "--num-clips-warmup", "2", "--num-clips-eval", "4",
          "--block-policy", "rl_semseg", "--speed-mode",
          "--block-train-interval", "2", "--model-checkpoint", "",
          "--workers", "1", "--device", "cpu"]


@pytest.fixture(autouse=True)
def two_threads_a_rank(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def policy_like(seed=5):
    st = FixedCapacityStepper(None, StepperConfig(block_size=128),
                              (1, 256, 512, 3), 4, device="cpu")
    return st.init_policy_state(seed)


def test_mesh_eval_matches_single_device(tmp_path):
    path = str(tmp_path / "pol.npz")
    r1 = tcli.main(COMMON + ["--num-devices", "1"])
    r2 = tcli.main(COMMON + ["--num-devices", "2", "--policy-checkpoint",
                             path])
    assert abs(r1["Mean IoU"] - r2["Mean IoU"]) < 0.02, (r1, r2)
    assert r2["perc_exec"] == r1["perc_exec"] == 0.5
    assert r2["gmacs_per_image"] == r1["gmacs_per_image"]
    assert r2["fps"] > 0 and 0 < r2["running_cost"] < 1
    # rank 0's replica, flat: it loads into a fresh stepper's policy, on
    # any rank, which keeps its own generator
    like = policy_like()
    got = tpc.load_stepper_policy(path, like, rank=1)
    assert got["generator"] is like["generator"]
    assert not torch.equal(got["params"]["conv1"]["w"],
                           like["params"]["conv1"]["w"])
    # the next two-rank run loads it on both ranks and saves it again
    stamp = os.path.getmtime(path)
    r3 = tcli.main(COMMON + ["--num-devices", "2", "--policy-checkpoint",
                             path])
    assert r3["perc_exec"] == 0.5 and os.path.getmtime(path) >= stamp


def _images(messages):
    """The image count of the CLI's last phase, from its log."""
    counts = [int(m) for m in re.findall(r"Number of images: (\d+)",
                                         "\n".join(messages))]
    return counts[-1]


def test_mesh_sums_confusion_matrices_and_images(caplog):
    argv = COMMON + ["--block-target", "1.0"]
    with caplog.at_level(logging.INFO, logger="blockcopy_tpu_torch.semseg"), \
            kept_confusion_matrices() as cm1:
        r1 = tcli.main(argv + ["--num-devices", "1"])
    n1 = _images([r.getMessage() for r in caplog.records])
    (r2, log0, cm2), (none, _, cm_rank1) = clip_parallel.spawn(
        clip_parallel.make_group(2, ["cpu", "cpu"]), semseg_cli_rank,
        argv + ["--num-devices", "2"], timeout=120)
    assert none is None and cm_rank1 == []
    assert _images(log0) == n1 == 4 * 3
    # one eval phase each: the same clips, the same class maps, summed
    assert len(cm1) == len(cm2) == 1 and cm1[0].sum() > 0
    np.testing.assert_array_equal(cm2[0], cm1[0])
    assert r2["perc_exec"] == r1["perc_exec"] == 1.0
    for key in ("Overall Acc", "Mean Acc", "FreqW Acc", "Mean IoU",
                "Fine mIoU"):
        assert r2[key] == pytest.approx(r1[key], rel=1e-9, abs=1e-12), key


def test_num_devices_over_available_rejected():
    with pytest.raises(ValueError, match="available"):
        tcli.main(COMMON + ["--num-devices", "1000"])


def test_mesh_needs_speed_mode():
    argv = [a for a in COMMON if a != "--speed-mode"]
    with pytest.raises(ValueError, match="speed-mode"):
        tcli.main(argv + ["--num-devices", "2"])


def test_per_rank_directory_round_trip(tmp_path):
    """Two ranks' states in a directory: each rank restores its own
    parameters, BN statistics, running cost and generator."""
    path = str(tmp_path / "mesh_policy")
    states = []
    for rank in range(2):
        pol = policy_like(seed=5)
        pol["bn_state"] = _shift_bn(pol["bn_state"], rank + 1.0)
        pol["running_cost"] = torch.tensor(0.25 * (rank + 1))
        pol["generator"] = torch.Generator().manual_seed(100 + rank)
        torch.rand(3, generator=pol["generator"])
        tpc.save_stepper_policy(path, pol, devices=2, rank=rank)
        states.append(pol)
    assert sorted(os.listdir(path)) == ["rank0.npz", "rank1.npz"]
    for rank, want in enumerate(states):
        got = tpc.load_stepper_policy(path, policy_like(seed=9), rank=rank)
        for key in ("params", "bn_state"):
            assert_tree(want[key], got[key], assert_same)
        assert float(got["running_cost"]) == 0.25 * (rank + 1)
        assert torch.equal(got["generator"].get_state(),
                           want["generator"].get_state())
    with pytest.raises(FileNotFoundError, match="rank 2"):
        tpc.load_stepper_policy(path, policy_like(), rank=2)


def _shift_bn(tree, by):
    if isinstance(tree, dict):
        return {k: _shift_bn(v, by) for k, v in tree.items()}
    return tree + by


def test_orbax_directory_refused(tmp_path):
    """The JAX package's mesh-mode orbax directory is refused by name (the
    port reads no orbax), by the loaders and by the CLI."""
    import jax.numpy as jnp

    from blockcopy_tpu.utils.checkpoint import save_orbax
    path = str(tmp_path / "pol_orbax")
    save_orbax(path, {"a": jnp.ones(3)})
    with pytest.raises(ValueError, match="orbax"):
        tpc.load_stepper_policy(path, policy_like())
    with pytest.raises(ValueError, match="orbax"):
        tpc.save_stepper_policy(path, policy_like(), devices=2)
    with pytest.raises(ValueError, match="orbax"):
        tcli.main(COMMON + ["--num-devices", "1", "--policy-checkpoint",
                            path])
