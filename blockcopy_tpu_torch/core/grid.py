"""Execution-grid utilities (counterpart of ``blockcopy_tpu/core/grid.py``).

The execution grid is a boolean tensor ``(N, GH, GW)`` marking the blocks to
execute this frame.  Index bookkeeping stays on the device with static
shapes: ``exec_indices`` pads to a fixed capacity with the sentinel
``total == N*GH*GW`` and never synchronises with the host.

The capacity ladder (ladder mode, ``core/engine.py``) rounds the executed
count up to a multiple of ``total * quantum`` so only a few block counts,
and so a few sets of launch shapes, ever occur.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["grid_shape", "num_blocks", "quantize_grid", "capacity_for_count",
           "capacity_ladder", "exec_indices", "neighbor_indices"]


def grid_shape(height: int, width: int, block_size: int) -> Tuple[int, int]:
    """Grid height/width for an image of ``height x width`` pixels."""
    if height % block_size or width % block_size:
        raise ValueError(
            f"image size ({height}, {width}) not divisible by block size "
            f"{block_size}")
    return height // block_size, width // block_size


def num_blocks(n: int, gh: int, gw: int) -> int:
    return n * gh * gw


def quantize_grid(grid: torch.Tensor, quantum: float,
                  generator: Optional[torch.Generator] = None,
                  u_rank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round the number of executed blocks up to a multiple of
    ``total * quantum`` by enabling extra randomly chosen blocks
    (``grid.py:53``): blocks are ranked by (executed, random uniform) and
    the top ``target`` kept.  Joint over the batch, like the reference.

    The uniforms come from ``generator``, or are given as ``u_rank``
    (``(total,)`` fp32).  No host sync: the count stays on the device."""
    if quantum <= 0:
        return grid
    flat = grid.reshape(-1)
    total = flat.shape[0]
    multiple = int(total * quantum)
    if multiple <= 0:
        return grid
    if u_rank is None:
        u_rank = torch.rand((total,), generator=generator, device=grid.device)
    n_exec = flat.sum(dtype=torch.int64)
    # ceil to the next multiple; 0 stays 0
    target = torch.where(n_exec > 0, multiple * (1 + (n_exec - 1) // multiple),
                         0)
    scores = u_rank + 2.0 * flat.float()
    order = torch.argsort(-scores, stable=True)    # executed blocks lead
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(total, device=order.device))
    return (rank < target).reshape(grid.shape)


def capacity_for_count(count: int, total: int, quantum: float) -> int:
    """Host-side: smallest ladder capacity >= count."""
    if count <= 0:
        return 0
    multiple = max(1, int(total * quantum)) if quantum > 0 else 1
    return min(total, multiple * math.ceil(count / multiple))


def capacity_ladder(total: int, quantum: float):
    """All capacities that can occur for this grid size."""
    if quantum <= 0:
        return list(range(1, total + 1))
    multiple = max(1, int(total * quantum))
    return list(range(multiple, total + 1, multiple)) + (
        [total] if total % multiple else [])


def exec_indices(grid: torch.Tensor, capacity: int) -> torch.Tensor:
    """Flat indices (into ``N*GH*GW``) of executed blocks in ascending order,
    padded to ``capacity`` with the sentinel ``total``.

    A stable sort of ``~grid`` puts the set cells first in index order; no
    ``nonzero`` (which synchronises on CUDA)."""
    flat = grid.reshape(-1)
    total = flat.shape[0]
    order = torch.sort((~flat).to(torch.uint8), stable=True).indices
    if capacity > total:
        order = torch.cat([order, order.new_full((capacity - total,), total)])
        flat = torch.cat([flat, flat.new_zeros(capacity - total)])
    head = order[:capacity]
    keep = flat[head.clamp(max=total - 1)] & (head < total)
    return torch.where(keep, head, total)


def neighbor_indices(idx: torch.Tensor, n: int, gh: int,
                     gw: int) -> torch.Tensor:
    """For each flat block index, the flat indices of its 8 neighbours in
    order (TL, T, TR, L, R, BL, B, BR); out-of-image neighbours and padding
    slots map to the sentinel ``n*gh*gw``.  Returns ``(K, 8)``."""
    total = n * gh * gw
    g = idx % (gh * gw)
    b = idx // (gh * gw)
    gy = g // gw
    gx = g % gw
    # the 3x3 window positions 0..8 without the centre 4, built on the
    # device (a host-made offset table would be a synchronising copy)
    j = torch.arange(8, device=idx.device, dtype=idx.dtype)
    j = j + (j >= 4).to(idx.dtype)
    oy, ox = j // 3 - 1, j % 3 - 1
    ny = gy[:, None] + oy[None, :]
    nx = gx[:, None] + ox[None, :]
    ok = ((ny >= 0) & (ny < gh) & (nx >= 0) & (nx < gw)
          & (idx[:, None] < total))
    flat = b[:, None] * (gh * gw) + ny * gw + nx
    return torch.where(ok, flat, total)
