"""Train checkpoints across the two packages: a JAX ``latest_state.npz``
(``init_csp`` + ``init_train_state`` + ``save_params``, no JAX training)
resumes in the port's train CLI, and the port's teacher checkpoint loads
in both packages' ``build_detector`` to the same parameters."""

import os

import jax
import numpy as np

from blockcopy_tpu.models.csp import CSPConfig as JCSPConfig
from blockcopy_tpu.models.csp import init_csp as jinit
from blockcopy_tpu.tasks.detection import train as JT
from blockcopy_tpu.utils.checkpoint import save_params as jsave
from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
from blockcopy_tpu_torch.tasks.detection import train as TT
from blockcopy_tpu_torch.tasks.detection.train_cli import main as train_main
from blockcopy_tpu_torch.utils.checkpoint import load_npz
from blockcopy_tpu_torch.utils.convert import (params_to_numpy,
                                               train_state_from_jax,
                                               train_state_to_numpy)
from torch_port_util import assert_same, assert_tree, jtree, \
    two_torch_threads  # noqa: F401

CONFIG = "configs/csp/csp_r50_clip_blockcopy_030.py"
SMALL = ["--synthetic", "--crop-height", "128", "--crop-width", "256",
         "--warmup-iters", "0", "--workers", "1", "--device", "cpu",
         "--epochs", "1", "--steps-per-epoch", "1", "--batch-size", "1",
         "--num-samples", "2"]


def test_jax_state_resumes_in_port_and_teacher_loads_in_both(tmp_path):
    jstate = JT.init_train_state(jinit(jax.random.PRNGKey(3), JCSPConfig()),
                                 JT.TrainConfig())
    jstate["step"] = jax.numpy.int32(5)
    path = str(tmp_path / "jax_latest_state.npz")
    jsave(path, jstate)
    ref = jtree(jstate)

    # the port reads it under JAX's keys, layouts converted
    like = TT.init_train_state(init_csp(CSPConfig(), device="meta"),
                               TT.TrainConfig())
    got = load_npz(path, like, device="cpu")
    assert_tree(ref, train_state_to_numpy(train_state_from_jax(ref, "cpu")),
                assert_same)
    assert_tree({k: ref[k] for k in ("params", "m", "v", "ema_params")},
                {k: params_to_numpy(got[k])
                 for k in ("params", "m", "v", "ema_params")}, assert_same)
    assert int(got["step"]) == 5

    # and the train CLI resumes from it
    out = str(tmp_path / "work")
    r = train_main(SMALL + ["--out", out, "--resume", path])
    assert r["step"] == 6

    # the port's teacher loads in both builders to the same parameters
    from blockcopy_tpu.models.builder import build_detector as jbuild
    from blockcopy_tpu.utils.registry import load_config as jload
    from blockcopy_tpu_torch.models.builder import build_detector as tbuild
    from blockcopy_tpu_torch.utils.registry import load_config as tload
    teacher = os.path.join(out, "epoch_1_teacher.npz")
    jdet = jbuild(jload(CONFIG), checkpoint=teacher)
    tdet = tbuild(tload(CONFIG), checkpoint=teacher, device="cpu")
    assert_tree(jtree(jdet.params), params_to_numpy(tdet.params), assert_same)
    with np.load(teacher) as z:
        np.testing.assert_array_equal(np.asarray(
            jdet.params["neck"]["p3"]["w"]), z["neck/p3/w"])
