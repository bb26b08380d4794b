"""The port's detection CLI, its modes on the CPU (``--device cpu``), on
the config and npz of ``test_torch_detection_cli.py``: a policy file round
trips through ``--policy-checkpoint`` on both engines, and the epoch-range
mode polls for and evaluates each epoch's file."""

import threading
import time

import numpy as np
import pytest

from blockcopy_tpu_torch.tasks.detection import eval as tcli
from test_torch_detection_cli import files, port  # noqa: F401
from torch_port_util import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("engine", ["ladder", "speed-mode"])
def test_policy_checkpoint_round_trip(files, tmp_path, monkeypatch, engine):
    """Run 1 writes the policy file after warmup; run 2 loads it before
    warmup: the loaded state equals the file bit for bit."""
    from blockcopy_tpu_torch.core.engine import BlockCopyModel
    from blockcopy_tpu_torch.utils.checkpoint import _flatten
    from blockcopy_tpu_torch.utils.convert import params_to_numpy
    path = str(tmp_path / "policy.npz")
    extra = ["--speed-mode"] if engine == "speed-mode" else []
    first = port(*files, "--policy-checkpoint", path, *extra)
    with np.load(path) as f:
        saved = {k: f[k] for k in f.files}
    loaded = {}
    cls = tcli._StepperDetector if engine == "speed-mode" else BlockCopyModel
    load = cls.load_policy

    def spy(self, p):
        load(self, p)
        state = self.state["policy"] if engine == "speed-mode" \
            else self.policy.state()
        loaded.update(_flatten(params_to_numpy(
            state["params" if engine == "speed-mode" else "net_params"])))

    monkeypatch.setattr(cls, "load_policy", spy)
    second = port(*files, "--policy-checkpoint", path, *extra)
    assert loaded
    prefix = "params/" if engine == "speed-mode" else "net_params/"
    for k, v in loaded.items():
        np.testing.assert_array_equal(v, saved[prefix + k], err_msg=k)
    for res in (first, second):
        assert res["block_target"] == 0.9 and res["fps"] > 0


def test_epoch_range_polls_and_evaluates(files, tmp_path):
    """As ``tests/test_checkpoint_range_eval.py``: epoch 1's file appears
    late, epoch 0 waits for it (the writer has moved on), both epochs are
    evaluated, each with its own detection dump."""
    import json
    import os
    import shutil
    cfg, ckpt = files[1], files[3]
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    shutil.copy(ckpt, run_dir / "epoch_0.npz")

    def write_later():
        time.sleep(1.5)
        shutil.copy(ckpt, run_dir / "epoch_1.npz")

    writer = threading.Thread(target=write_later)
    writer.start()
    out = str(tmp_path / "dets.json")
    try:
        summaries = port("--config", cfg, "--checkpoint", str(run_dir),
                         "--checkpoint-start", "0", "--checkpoint-end", "2",
                         "--poll-seconds", "0.25", "--out", out)
    finally:
        writer.join()
    assert [s["epoch"] for s in summaries] == [0, 1]
    for s in summaries:
        assert s["result"]["fps"] > 0
        assert np.isfinite(s["result"]["gmacs_per_image"])
    for ep in (0, 1):
        path = str(tmp_path / f"dets_epoch{ep}.json")
        assert os.path.isfile(path), path
        with open(path) as f:
            assert isinstance(json.load(f), list)
