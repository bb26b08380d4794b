"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to run on the CPU unless asked."""

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


@pytest.mark.parametrize("entry", [_swiftnet, _policy, _stepper,
                                   _params_from_jax, _probe])
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
