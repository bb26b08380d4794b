"""Device selection for the port's entry points, and host-to-device
uploads that do not block the host."""

from __future__ import annotations

import torch

from blockcopy_tpu_torch.utils.profiler import timings


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Asking for CUDA where it is absent raises: the
    port never falls back to the CPU on its own; pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def to_device(a, device) -> torch.Tensor:
    """A host array or CPU tensor on ``device`` without blocking the host:
    on CUDA it is staged in pinned memory and copied asynchronously (an
    upload from pageable memory is a host sync).  Its host time is the
    span ``bc.upload`` (tracing level 2): from pageable memory, as in the
    CLIs, mostly the staging copy."""
    with timings.env("bc.upload", 2):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        if torch.device(device).type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
