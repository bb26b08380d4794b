"""A CPU rehearsal of the harness at a small size: the set-up, the window,
the recorded clips judged by the reference, the metric readers and the
last line; the faults the comparison has to catch, each planted in the
program (a step that returns its state unchanged, an output or a grid
altered where it is produced, the policy's RMSprop with a doubled
learning rate or its square averages left unchanged); and a real run
without a card, which fails and prints nothing."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchcell import run, tiny
from harness.cell import BENCH, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "breakdown",
        "checks"]


@pytest.mark.parametrize("workload", ["semseg-rn50-b128-t05",
                                      "det-csp-r50-b128-t03"])
def test_rehearsal_line(workload):
    out = run(tiny(workload), trace=True)
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 3 * 4
    # no device on the CPU: the trace's device metrics read nothing
    assert set(out["metrics"]) == {"host_submit_ms", "model_mfu",
                                   "reinforce_ms"}
    assert out["device"]["count"] == 1 and out["device"]["busy_s"] == 0.0
    for k, v in out["checks"].items():
        assert v["value"] <= v["limit"], k
    json.dumps(out)


def test_end_to_end_metrics():
    out = run(tiny("semseg-rn50-b128-t05"))
    assert set(out["metrics"]) == {"fps", "frame_ms_p90", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["metrics"]["fps"]["unit"] == "frames/s"


def test_a_window_of_fewer_than_four_frames():
    """One clip of three frames: the log's quarters of the window are
    taken over the frames there are."""
    out = run(tiny("semseg-rn18-b128-t05", 3), seconds=0.0)
    assert out["attempted"] == 3
    assert out["correct"] is True, out["checks"]


def _unchanged(monkeypatch):
    from blockcopy_tpu_torch.core.stepper import FixedCapacityStepper
    monkeypatch.setattr(FixedCapacityStepper, "step_",
                        lambda self, params, state, frame, *a, **k: state)


def _altered_output(monkeypatch):
    from blockcopy_tpu_torch.core.stepper import FixedCapacityStepper
    from blockcopy_tpu_torch.tasks.detection.stepper import DetectionStepper
    semseg, det = FixedCapacityStepper._model_fn, DetectionStepper._model_fn

    def alter(orig):
        def fn(self, params, pack, ctx):
            out = dict(orig(self, params, pack, ctx))
            key = "dets" if "dets" in out else "outputs"
            t = out[key].clone()
            t.view(-1)[0] += 8.0
            out[key] = t
            return out
        return fn
    monkeypatch.setattr(FixedCapacityStepper, "_model_fn", alter(semseg))
    monkeypatch.setattr(DetectionStepper, "_model_fn", alter(det))


def _altered_grid(monkeypatch):
    from blockcopy_tpu_torch.core.stepper import FixedCapacityStepper
    orig = FixedCapacityStepper._sample_grid

    def fn(self, probs, draws=None, generator=None):
        g = orig(self, probs, draws, generator).reshape(-1).clone()
        on, off = torch.nonzero(g)[0, 0], torch.nonzero(~g)[0, 0]
        g[on], g[off] = False, True
        return g.reshape(probs.shape)
    monkeypatch.setattr(FixedCapacityStepper, "_sample_grid", fn)


def _rmsprop(monkeypatch, fault):
    from blockcopy_tpu_torch.policy import optim
    from calibrate import faulty_rmsprop
    for name, fn in faulty_rmsprop(fault).items():
        monkeypatch.setattr(optim, name, fn)


def _doubled_lr(monkeypatch):
    _rmsprop(monkeypatch, "lr2")


def _frozen_square_avg(monkeypatch):
    _rmsprop(monkeypatch, "sq")


@pytest.mark.parametrize("fault", [_unchanged, _altered_output,
                                   _altered_grid, _doubled_lr,
                                   _frozen_square_avg])
@pytest.mark.parametrize("workload", ["semseg-rn50-b128-t05",
                                      "det-csp-r50-b128-t03"])
def test_a_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = run(tiny(workload))
    assert out["correct"] is False, out["checks"]
    assert out["failed"] > 0


def test_without_a_card_a_run_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "semseg-rn50-b128-t05", "--seed", str(2 ** 33 + 1), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr


def test_the_benchmark_alone_fails_and_prints_nothing(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "semseg-rn50-b128-t05", "--seed", "7", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=env)
    assert res.returncode != 0 and res.stdout == ""
