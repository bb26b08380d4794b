"""The port's detection train CLI (``tasks/detection/train_cli.py``) end to
end on the CPU: the loss falls, the student, teacher and resume
checkpoints are written and load in the port's detector builder, and a
resume carries the step."""

import os

import numpy as np

from blockcopy_tpu_torch.tasks.detection.train_cli import main as train_main
from torch_port_util import two_torch_threads  # noqa: F401

CONFIG = "configs/csp/csp_r50_clip_blockcopy_030.py"
SMALL = ["--synthetic", "--crop-height", "128", "--crop-width", "256",
         "--warmup-iters", "0", "--workers", "1", "--device", "cpu"]


def test_train_cli_end_to_end(tmp_path, capsys):
    out = str(tmp_path / "work")
    r = train_main(SMALL + ["--epochs", "1", "--steps-per-epoch", "8",
                            "--batch-size", "2", "--num-samples", "16",
                            "--lr", "4e-4", "--out", out,
                            "--log-interval", "4"])
    assert r["step"] == 8 and r["epochs"] == 1 and r["out"] == out
    assert r["final_losses"]["loss_total"] < r["first_losses"]["loss_total"]
    assert set(r["first_losses"]) == {"loss_cls", "loss_bbox",
                                      "loss_offset", "loss_total"}
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        '{"epochs": 1')
    for f in ("epoch_1.npz", "epoch_1_teacher.npz", "latest_state.npz"):
        assert os.path.isfile(os.path.join(out, f)), f
    with np.load(os.path.join(out, "latest_state.npz")) as z:
        assert int(z["step"]) == 8
        assert {k.split("/")[0] for k in z.files} == {
            "params", "ema_params", "m", "v", "step"}
        # the teacher trails the student
        k = "params/head/csp_cls/w"
        assert not np.array_equal(z[k], z["ema_params/head/csp_cls/w"])

    from blockcopy_tpu_torch.models.builder import build_detector
    from blockcopy_tpu_torch.utils.registry import load_config
    det = build_detector(load_config(CONFIG), device="cpu",
                         checkpoint=os.path.join(out, "epoch_1_teacher.npz"))
    with np.load(os.path.join(out, "epoch_1_teacher.npz")) as z:
        np.testing.assert_array_equal(
            det.params["head"]["csp_cls"]["w"].permute(2, 3, 1, 0).numpy(),
            z["head/csp_cls/w"])


def test_train_cli_resume(tmp_path):
    out = str(tmp_path / "work")
    common = SMALL + ["--epochs", "1", "--steps-per-epoch", "2",
                      "--batch-size", "1", "--num-samples", "4",
                      "--out", out]
    assert train_main(common)["step"] == 2
    with np.load(os.path.join(out, "latest_state.npz")) as z:
        saved = dict(z)
    r = train_main(common + ["--resume",
                             os.path.join(out, "latest_state.npz")])
    assert r["step"] == 4          # the optimizer step counter carried over
    with np.load(os.path.join(out, "latest_state.npz")) as z:
        # the moments went on from the saved ones, not from zero
        assert not np.array_equal(z["m/head/csp_reg/b"],
                                  saved["m/head/csp_reg/b"])
        assert int(z["step"]) == 4
