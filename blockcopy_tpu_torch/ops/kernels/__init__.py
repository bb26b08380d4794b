"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper adds one to its entry of ``launches`` when it launches its
kernel, and nowhere else; a run reads the counts to show that a path went
through the kernels.
"""

from __future__ import annotations

launches = {"halo_canvas": 0, "halo_strips": 0, "bottleneck_tail": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
