"""Build and load the port's native libraries: the CUDA kernels of
``blockcopy_tpu_torch/csrc`` and the host C++ of ``HOST_SOURCES``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` at first use, then
loaded with ``ctypes``.  The file name carries a hash of the source and of
the shared headers ``csrc/*.cuh``, so an edited source or header is rebuilt
and a stale library is never loaded.  Tensor maps for TMA are encoded
through ``cudaGetDriverEntryPoint``, so nothing links ``libcuda``.

A host source (the clip IO library ``native/io.cpp``) is compiled the same
way by ``g++`` with the JAX package's Makefile flags (``-O3``, no
fast-math), its hash over that one file; it needs no card.  Every build
writes a temporary file and renames it into place, so processes that build
at once never load a half-written library.
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

from blockcopy_tpu_torch.utils.profiler import timings

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v"]

# host C++ libraries: name -> source, built by g++ (linked with zlib)
HOST_SOURCES = {"io": PKG / "native" / "io.cpp"}
GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall"]
GXX_LIBS = ["-shared", "-lz", "-lpthread"]

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


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found (put it on PATH)")


def source(name: str) -> Path:
    """The source file of library ``name``."""
    return HOST_SOURCES.get(name, CSRC / f"{name}.cu")


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    deps = [source(name)] if name in HOST_SOURCES \
        else [source(name), *sorted(CSRC.glob("*.cuh"))]
    for path in deps:
        digest.update(path.read_bytes())
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile_cmd(name: str, out: Path) -> list:
    if name in HOST_SOURCES:
        return [_gxx(), *GXX_FLAGS, str(source(name)), "-o", str(out),
                *GXX_LIBS]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source(name))]


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every missing library among ``names``, one compiler process
    per source, all started together.  Returns ``{name: compiler output}``
    for the sources it compiled (for a ``.cu``, ``-Xptxas -v``: registers,
    shared memory and spills of every kernel).  A failed compile raises
    with the compiler's output.  Each compile adds one to the profiler's
    ``builds`` counter."""
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
            failed.append(f"{Path(proc.args[0]).name} failed for "
                          f"{source(name).name}:\n{out}")
        else:
            os.replace(tmp, target)
            timings.count("builds")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``name`` (``csrc/<name>.cu`` or a host
    source), built if needed."""
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
