"""Build and load the CUDA kernels of ``blockcopy_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` at first use, then
loaded with ``ctypes``.  The file name carries a hash of the source, so an
edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile_cmd(name: str, out: Path) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every missing library among ``names``, one ``nvcc`` process
    per source, all started together.  Returns ``{name: compiler output}``
    for the sources it compiled (``-Xptxas -v``: registers, shared memory
    and spills of every kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = _compile_cmd(name, Path(tmp))
        jobs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), Path(tmp), target)
    logs = {}
    failed = []
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
