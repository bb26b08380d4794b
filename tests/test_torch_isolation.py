"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to run on the CPU unless asked."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "blockcopy_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|blockcopy_tpu(?:\.|\s|$))",
    re.M)


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import blockcopy_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'blockcopy_tpu' or "
        "k.startswith('blockcopy_tpu.'))\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_walk_covers_detection():
    """The import walk above reaches the detection modules."""
    import pkgutil
    import blockcopy_tpu_torch as p
    names = {m.name for m in pkgutil.walk_packages(p.__path__,
                                                    p.__name__ + ".")}
    assert {f"blockcopy_tpu_torch.{m}" for m in (
        "models.csp", "models.builder", "ops.nms", "utils.registry",
        "tasks.detection.stepper", "tasks.detection.information_gain",
        "tasks.detection.eval", "tasks.detection.eval_mr",
        "tasks.detection.dataset", "tasks.detection.checkpoint",
        "tools.bench_detection")} <= names


def test_cli_runs_without_jax_or_pil():
    """The semseg CLI on ``--synthetic`` clips imports neither JAX, nor the
    JAX package, nor PIL (the card's machine has no PIL)."""
    code = (
        "import sys\n"
        "from blockcopy_tpu_torch.tasks.semseg import eval as cli\n"
        "res = cli.main(['--synthetic', '--res', '128', '--clip-length', '2',"
        " '--num-clips-warmup', '1', '--num-clips-eval', '1',"
        " '--model-checkpoint', '', '--device', 'cpu'])\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'blockcopy_tpu', 'PIL'))\n"
        "assert not bad, bad\n"
        "assert res['fps'] > 0\n")
    # two intra-op threads, as the other port tests (torch_port_util.py)
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_detection_cli_runs_without_jax_or_pil():
    """The detection CLI on ``--synthetic`` clips, ladder engine, imports
    neither JAX, nor the JAX package, nor PIL."""
    code = (
        "import sys\n"
        "from blockcopy_tpu_torch.tasks.detection import eval as cli\n"
        "res = cli.main(['--synthetic', '--res', '256', '--clip-length', '2',"
        " '--num-clips-warmup', '1', '--num-clips-eval', '1',"
        " '--workers', '1', '--device', 'cpu'])\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'blockcopy_tpu', 'PIL'))\n"
        "assert not bad, bad\n"
        "assert res['fps'] > 0 and 'MR_Reasonable' in res\n")
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if FORBIDDEN.search(f.read_text())]
    assert not offenders, offenders


def _swiftnet():
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet)
    init_swiftnet(SwiftNetConfig())


def _policy():
    from blockcopy_tpu_torch.policy.net import init_policy_net
    init_policy_net(26, arch="fast")


def _stepper():
    from blockcopy_tpu_torch.core.stepper import (FixedCapacityStepper,
                                                  StepperConfig)
    FixedCapacityStepper(None, StepperConfig(), (1, 256, 512, 3), 4)


def _params_from_jax():
    from blockcopy_tpu_torch.utils.convert import params_from_jax
    params_from_jax({"w": np.zeros((3, 3, 2, 4), np.float32)})


def _probe():
    from blockcopy_tpu_torch.tools import probe_int8
    probe_int8.main([])


def _engine():
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.core.engine import BlockCopyModel
    BlockCopyModel(None, None, default_settings(block_policy="all"))


def _build_policy():
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.policy.policies import \
        build_policy_from_settings
    build_policy_from_settings(default_settings())


def _load_checkpoint():
    from blockcopy_tpu_torch.models.swiftnet import SwiftNetConfig
    from blockcopy_tpu_torch.utils.checkpoint import load_params
    load_params("missing.pth", SwiftNetConfig())


def _load_npz():
    from blockcopy_tpu_torch.utils.checkpoint import load_npz
    load_npz("missing.npz", {})


def _cli():
    from blockcopy_tpu_torch.tasks.semseg import eval as cli
    cli.main(["--synthetic", "--res", "128"])


def _csp():
    from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
    init_csp(CSPConfig(stage_blocks=(1, 1, 1, 1)))


def _detection_stepper():
    from blockcopy_tpu_torch.core.stepper import StepperConfig
    from blockcopy_tpu_torch.models.csp import CSPConfig
    from blockcopy_tpu_torch.tasks.detection.stepper import DetectionStepper
    DetectionStepper(CSPConfig(), StepperConfig(), (1, 256, 256, 3), 2)


def _csp_blockcopy():
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.models.csp import CSPBlockCopy, CSPConfig
    CSPBlockCopy(None, CSPConfig(), default_settings(block_policy="all"))


def _build_detector():
    from blockcopy_tpu_torch.models.builder import build_detector
    build_detector({"model": {"type": "CSPBlockCopy",
                              "backbone": {"stage_blocks": (1, 1, 1, 1)}}})


def _load_csp_checkpoint():
    from blockcopy_tpu_torch.models.csp import CSPConfig
    from blockcopy_tpu_torch.tasks.detection.checkpoint import \
        load_csp_torch_checkpoint
    load_csp_torch_checkpoint("missing.pth", CSPConfig())


def _detection_cli():
    from blockcopy_tpu_torch.tasks.detection import eval as cli
    cli.main(["--synthetic", "--res", "256"])


def _bench_detection():
    from blockcopy_tpu_torch.tools import bench_detection
    bench_detection.main([])


@pytest.mark.parametrize("entry", [_swiftnet, _policy, _stepper,
                                   _params_from_jax, _probe, _engine,
                                   _build_policy, _load_checkpoint,
                                   _load_npz, _cli, _csp,
                                   _detection_stepper, _csp_blockcopy,
                                   _build_detector, _load_csp_checkpoint,
                                   _detection_cli, _bench_detection])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_kernel_wrappers_refuse_non_cpu_non_cuda():
    """A wrapper runs the plain version only for CPU tensors; anything else
    that is not CUDA is refused, never silently computed."""
    from blockcopy_tpu_torch.ops.kernels import bottleneck, halo
    meta = torch.device("meta")
    canvas = torch.empty((9, 4, 4, 8), device=meta)
    idx = torch.empty((2,), dtype=torch.int64, device=meta)
    center = torch.empty((2, 4, 4, 8), device=meta)
    with pytest.raises(ValueError):
        halo.halo_gather_canvas(canvas, idx, 1, 1, 2, 4, center)
    h1 = torch.empty((2, 8, 8, 128), device=meta)
    with pytest.raises(ValueError):
        bottleneck.bottleneck_tail(h1, h1, {}, None, None, None, None, None,
                                   None)
