"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper adds one to its entry of ``launches`` when it launches its
kernel, and nowhere else; a run reads the counts to show that a path went
through the kernels.
"""

from __future__ import annotations

import functools

import torch

# K2 counts by route: ``bottleneck_tail`` the bf16 wgmma route,
# ``bottleneck_tail_rows`` the bf16 row route, ``bottleneck_tail_f32`` fp32;
# ``mark`` the device marks of ``utils/profiler.py`` (``csrc/mark.cu``)
launches = {"halo_canvas": 0, "halo_strips": 0, "halo_pieces": 0,
            "bottleneck_tail": 0,
            "bottleneck_tail_rows": 0, "bottleneck_tail_f32": 0,
            "mm_bf16": 0, "mm_int8": 0, "mark": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sms(device: torch.device) -> int:
    """The SM count of the card ``device`` names, read once a card: what
    the kernels' launch plans size their grids from."""
    return _sms(device.index if device.index is not None
                else torch.cuda.current_device())
