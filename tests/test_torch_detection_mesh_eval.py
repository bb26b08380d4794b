"""Clip-parallel evaluation through the port's detection CLI on the CPU, as
``tests/test_detection_mesh_eval.py`` does for the JAX CLI: ``--num-devices
2`` (two spawned gloo ranks) against ``--num-devices 1``, 3 clips over 2
ranks, so the final group is padded by repeating its last clip and the
padded results must be thrown away.  CSP
``stage_blocks=(1, 1, 1, 1)`` at full widths from one npz (the ``csp_cls``
bias 0, ``score_thr`` 0.6, so the clips have boxes), clips of 2 frames,
REINFORCE every 2nd frame, so the averaged update runs on each clip's
last.

At ``--block-target 1.0`` every block runs every frame, so the boxes do not
depend on the policy: the two runs must dump the same detections for the
same images, with equal miss rates, ``perc_exec`` and ``gmacs_per_image``.
The config's target and the per-rank policy directory:
``test_torch_detection_mesh_policy.py`` (one file would take a minute).
"""

import json

import numpy as np
import pytest

from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
from blockcopy_tpu_torch.tasks.detection import eval as tcli
from blockcopy_tpu_torch.utils.checkpoint import save_params
from torch_port_util import two_torch_threads  # noqa: F401

CONFIG = """
model = dict(type="CSPBlockCopy",
             blockcopy_settings=dict(block_target=0.5, block_size=128,
                                     block_train_interval=2),
             backbone=dict(type="ResNet", depth=50,
                           stage_blocks=(1, 1, 1, 1)))
test_cfg = dict(score_thr=0.6)
"""
ARGS = ["--synthetic", "--res", "256", "--clip-length", "2",
        "--num-clips-warmup", "2", "--num-clips-eval", "3", "--workers", "1",
        "--speed-mode", "--device", "cpu"]


@pytest.fixture(autouse=True)
def two_threads_a_rank(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The config file and an npz of port-drawn weights, bias 0."""
    root = tmp_path_factory.mktemp("det_mesh")
    cfg = root / "csp_tiny.py"
    cfg.write_text(CONFIG)
    params = init_csp(CSPConfig(stage_blocks=(1, 1, 1, 1)), seed=0,
                      device="cpu")
    params["head"]["csp_cls"]["b"].zero_()
    ckpt = root / "csp_tiny.npz"
    save_params(str(ckpt), params)
    return ["--config", str(cfg), "--checkpoint", str(ckpt)]


def dets_by_image(path):
    with open(path) as f:
        rows = json.load(f)
    out = {}
    for d in rows:
        out.setdefault(d["image_id"], []).append(d["bbox"] + [d["score"]])
    return {k: np.array(sorted(v)) for k, v in out.items()}


def test_all_blocks_mesh_matches_single_device(files, tmp_path):
    dumps = [str(tmp_path / f"n{n}.json") for n in (1, 2)]
    r1, r2 = (tcli.main(ARGS + files + ["--block-target", "1.0", "--out",
                                        dump, "--num-devices", str(n)])
              for n, dump in zip((1, 2), dumps))
    assert r2["perc_exec"] == r1["perc_exec"] == 1.0
    assert r2["gmacs_per_image"] == r1["gmacs_per_image"]
    d1, d2 = dets_by_image(dumps[0]), dets_by_image(dumps[1])
    assert sorted(d1) == sorted(d2) == [1, 2, 3]    # no padded image
    assert sum(len(v) for v in d1.values()) >= 3
    for k in d1:
        np.testing.assert_allclose(d2[k], d1[k], rtol=1e-5, atol=1e-4)
    for k in r1:
        if k.startswith("MR_"):
            assert r2[k] == r1[k], k
    assert r2["fps"] > 0
