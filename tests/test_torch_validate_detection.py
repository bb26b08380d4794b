"""The port's detection validation tool
(``blockcopy_tpu_torch/tools/validate_detection.py``): its metric pieces
against the root ``tools/validate_detection.py``, and a tiny end-to-end
run on the CPU."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from blockcopy_tpu_torch.tools import validate_detection as TV
from torch_port_util import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def JV():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_detection", ROOT / "tools" / "validate_detection.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dets(rs, n):
    xy = rs.uniform(0, 200, (n, 2))
    wh = rs.uniform(5, 60, (n, 2))
    # some boxes duplicated with a jitter, so IoUs straddle 0.5
    out = np.concatenate([xy, xy + wh, rs.rand(n, 1)], 1)
    out[n // 2:, :4] = out[:n - n // 2, :4] + rs.randn(n - n // 2, 4) * 3
    return out.astype(np.float32)


@pytest.mark.parametrize("n,m", [(0, 0), (0, 3), (4, 0), (6, 9), (12, 12)])
def test_iou_matrix(JV, n, m):
    rs = np.random.RandomState(n * 10 + m)
    a, b = _dets(rs, n)[:, :4], _dets(rs, m)[:, :4]
    ref, got = JV._iou_matrix(a, b), TV._iou_matrix(a, b)
    assert ref.shape == got.shape == (n, m)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", range(4))
def test_f1_vs(JV, seed):
    rs = np.random.RandomState(seed)
    dense, test = _dets(rs, 3 + seed * 3), _dets(rs, 2 + seed * 4)
    test[:len(dense) // 2] = dense[:len(dense) // 2]
    for kw in (dict(), dict(iou_thr=0.3, score_thr=0.0)):
        assert TV.f1_vs(dense, test, **kw) == JV.f1_vs(dense, test, **kw)
    empty = np.zeros((0, 5), np.float32)
    assert TV.f1_vs(empty, empty) == JV.f1_vs(empty, empty) == 1.0
    assert TV.f1_vs(dense, empty) == JV.f1_vs(dense, empty)


def test_dets_to_coco(JV):
    arr = _dets(np.random.RandomState(9), 5)
    assert TV.dets_to_coco(arr, 7) == JV.dets_to_coco(arr, 7)
    assert TV.dets_to_coco(arr[:0], 7) == []


def test_tool_end_to_end_tiny(monkeypatch, tmp_path, capsys):
    """Two train steps of CSP-R50 and every mode, the flag A/B included, at
    256x512 and 3-frame clips: the result's keys and ranges, and ``--out``
    writes only where it is told."""
    monkeypatch.setattr(TV, "H", 256)
    monkeypatch.setattr(TV, "W", 512)
    monkeypatch.setattr(TV, "CLIP_LEN", 3)
    out = tmp_path / "v.json"
    res = TV.main(["--device", "cpu", "--train-iters", "2",
                   "--warmup-clips", "1", "--eval-clips", "1",
                   "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(res))
    assert res["geometry"] == "256x512 bs128" and res["clip_len"] == 3
    assert set(res["modes"]) == {
        "dense", "frozen", "blockcopy", "blockcopy_HEAD_BLOCKED_FINAL=0",
        "blockcopy_HEAD_FUSED_BRANCH_CONV=0"}
    for mode in res["modes"].values():
        assert set(mode["mr"]) == {"Reasonable", "Reasonable_small",
                                   "Reasonable_occ=heavy", "All"}
        assert 0 <= mode["agreement_f1_vs_dense"] <= 1
    # 8 blocks at target 0.3: capacity 2, a quarter of the frame
    assert res["modes"]["blockcopy"]["exec_rate_eval"] == 0.25
    assert np.isfinite([res["train"]["loss_first"],
                        res["train"]["loss_last"]]).all()
    # no file by default: the root VALIDATION_det_t03.json is JAX's record
    assert TV.build_argparser().parse_args([]).out == ""
