"""The port's detection CLI held against the JAX CLI on the CPU
(``--device cpu``): both load one npz written here (CSP
``stage_blocks=(1, 1, 1, 1)`` at full widths, the ``csp_cls`` bias 0 so the
synthetic clips get boxes) through a config file, policy ``all``: the same
JSON keys, the miss rates equal, ``gmacs_per_image`` to 1e-6 relative.

Then the port alone: ``--speed-mode`` runs and an explicit ``--block-*``
flag beats the config's ``blockcopy_settings``; the paths not ported raise.
Policy files and the epoch-range mode: ``test_torch_detection_cli_modes.py``
(one file would take a minute)."""

import numpy as np
import pytest

import blockcopy_tpu.models.csp as JC
from blockcopy_tpu.tasks.detection import eval as jcli
from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
from blockcopy_tpu_torch.tasks.detection import eval as tcli
from blockcopy_tpu_torch.utils.checkpoint import save_params
from torch_port_util import two_torch_threads  # noqa: F401

CONFIG = """
model = dict(type="CSPBlockCopy",
             blockcopy_settings=dict(block_target=0.9, block_size=128),
             backbone=dict(type="ResNet", depth=50,
                           stage_blocks=(1, 1, 1, 1)))
test_cfg = dict(score_thr=0.6)
"""
ARGS = ["--synthetic", "--res", "256", "--clip-length", "2",
        "--num-clips-warmup", "1", "--num-clips-eval", "1", "--workers", "1"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The config file and an npz of port-drawn weights, bias 0."""
    root = tmp_path_factory.mktemp("det_cli")
    cfg = root / "csp_tiny.py"
    cfg.write_text(CONFIG)
    params = init_csp(CSPConfig(stage_blocks=(1, 1, 1, 1)), seed=0,
                      device="cpu")
    params["head"]["csp_cls"]["b"].zero_()
    ckpt = root / "csp_tiny.npz"
    save_params(str(ckpt), params)
    return ["--config", str(cfg), "--checkpoint", str(ckpt)]


def port(*extra):
    return tcli.main(ARGS + ["--device", "cpu", *extra])


def test_speed_mode_with_explicit_flag(files):
    """``--speed-mode`` runs; ``--block-target 0.5`` typed against the
    config's 0.9 wins, and the stepper runs 4 of 8 blocks."""
    res = port(*files, "--speed-mode", "--block-target", "0.5")
    assert set(res) >= {"MR_Reasonable", "fps", "gmacs_per_image",
                        "gmacs_breakdown", "perc_exec", "block_target"}
    assert res["block_target"] == 0.5 and res["perc_exec"] == 0.5
    assert res["gmacs_per_image"] > 0 and res["fps"] > 0


def test_cli_matches_jax(files, tmp_path, monkeypatch):
    """Also the COCO dumps (``--out``): as many detections, each port box
    within 1e-4 of the JAX box nearest it."""
    import json
    monkeypatch.setattr(JC, "TOPK_IMPL", "sort")
    dumps = [str(tmp_path / f"{name}.json") for name in ("jax", "port")]
    ref = jcli.main(ARGS + files + ["--block-policy", "all", "--out",
                                    dumps[0]])
    got = port(*files, "--block-policy", "all", "--out", dumps[1])
    assert set(got) == set(ref)
    for key in ref:
        if key.startswith("MR_"):
            assert got[key] == ref[key], key
    rows = []
    for path in dumps:
        with open(path) as f:
            rows.append(np.array([d["bbox"] + [d["score"], d["image_id"]]
                                  for d in json.load(f)]))
    jd, td = rows
    assert len(jd) == len(td) >= 5
    near = np.abs(td[:, None, :4] - jd[None, :, :4]).max(-1).argmin(1)
    assert len(set(near.tolist())) == len(near)
    np.testing.assert_allclose(td, jd[near], rtol=1e-4, atol=1e-4)
    assert got["gmacs_per_image"] == pytest.approx(ref["gmacs_per_image"],
                                                   rel=1e-6)
    assert got["gmacs_breakdown"] == pytest.approx(ref["gmacs_breakdown"],
                                                   rel=1e-6)
    assert got["perc_exec"] == ref["perc_exec"] == 1.0
    # the config's target beats the CLI default (0.3)
    assert got["block_target"] == ref["block_target"] == 0.9
    assert got["fps"] > 0


def test_explicitly_passed():
    ex = tcli._explicitly_passed(["--synthetic", "--block-target", "0.5"])
    assert "block_target" in ex and "synthetic" in ex
    assert "block_size" not in ex and "res" not in ex


@pytest.mark.parametrize("extra, env", [
    (["--num-devices", "2"], {}),
    ([], {"WORLD_SIZE": "2"}),
    (["--policy-checkpoint", "policy_dir"], {}),
])
def test_unported_paths_raise(monkeypatch, extra, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="item 13"):
        port(*extra)
