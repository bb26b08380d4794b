"""Clip-parallel detection at the config's target (0.5) through the port's
detection CLI on the CPU: two spawned gloo ranks over 3 clips (the final
group padded) keep the checks of ``tests/test_detection_mesh_eval.py`` (the
MR sentinels), and the mesh-mode ``--policy-checkpoint`` directory holds
one file per rank: the same averaged parameters and RMSprop state, each
rank's own BN statistics and generator; the next two-rank run restores
them and keeps the sentinels.  The setup is
``test_torch_detection_mesh_eval.py``'s.
"""

import os

import numpy as np

from blockcopy_tpu_torch.tasks.detection import eval as tcli
from test_torch_detection_mesh_eval import ARGS, files  # noqa: F401
from test_torch_detection_mesh_eval import two_threads_a_rank  # noqa: F401
from torch_port_util import two_torch_threads  # noqa: F401


def test_mesh_eval_and_per_rank_policy_directory(files, tmp_path):
    path = str(tmp_path / "policy_dir")
    r2 = tcli.main(ARGS + files + ["--num-devices", "2",
                                   "--policy-checkpoint", path])
    assert r2["perc_exec"] == 0.5 and r2["gmacs_per_image"] > 0
    for k in r2:
        if k.startswith("MR_"):
            # -1.0: no GT in the setup (no small or occluded pedestrians)
            assert r2[k] == -1.0 or 0.0 <= r2[k] <= 100.0, (k, r2[k])
    assert sorted(os.listdir(path)) == ["rank0.npz", "rank1.npz"]
    with np.load(os.path.join(path, "rank0.npz")) as a, \
            np.load(os.path.join(path, "rank1.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            same = np.array_equal(a[key], b[key])
            if key.startswith(("params/", "opt/")):
                assert same, key        # averaged gradients: one policy
        # each rank's own clips: its own BN statistics and draws
        assert not all(np.array_equal(a[k], b[k]) for k in a.files
                       if k.startswith("bn_state/"))
        assert not np.array_equal(a["generator_state"],
                                  b["generator_state"])
    # the next run restores each rank's file, then saves its own again
    again = tcli.main(ARGS + files + ["--num-devices", "2",
                                      "--policy-checkpoint", path])
    assert again["perc_exec"] == 0.5
    for k in r2:
        if k.startswith("MR_"):
            assert (again[k] == -1.0) == (r2[k] == -1.0), k
