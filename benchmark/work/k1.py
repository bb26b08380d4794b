"""K1's work: the halo gathers of a configuration's frame at a block size,
and the bytes each must move (frozen from ``chip_smoke.py``
``halo_bytes`` and ``pieces_bytes``)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import programs
from work import k2, peaks

Launch = Tuple[int, int, int]       # (bs, C, pad) of the gathered blocks


def halo_bytes(bs, c, p, itemsize, k):
    """What an assembled gather (``gather_kernel``) must move: the blocks'
    interiors read, their halos read, the padded blocks written, and the
    block indices."""
    interior = k * bs * bs * c
    halo = k * (4 * p * bs + 4 * p * p) * c
    out = k * (bs + 2 * p) ** 2 * c
    return (interior + halo + out) * itemsize + 8 * k


def pieces_bytes(bs, c, p, itemsize, k):
    """What ``halo_pieces`` must move: each piece read once from its
    neighbour's strip and written once, and the block indices."""
    return 2 * k * (4 * p * bs + 4 * p * p) * c * itemsize + 8 * k


def launches(cfg: Dict, block_size: int) -> Dict[str, List[Launch]]:
    """A frame's K1 launches in the order the model runs them:
    ``gather``, the assembled halo of every blocked convolution with k > 1
    that K2 does not run, and ``pieces``, the unassembled halo of the
    stem's plane pool.

    The stem runs in space-to-depth form: its 7x7 s2 conv as a 3x3 over
    4 x 4 cells (16 x 3 channels at bs / 4), its max pool from the
    conv's four output planes (4 x 64 channels).  In the backbone
    (``k2.walk``) a bottleneck's 3x3 and a basic block's two 3x3s gather
    their input's halo (pad = dilation); K2 reads a fused tail's halo from
    the strips in place.  Then the launches after the backbone, which the
    configuration's program module lists (``k1_head``)."""
    gather = [(block_size // 4, 16 * 3, 1)]
    pieces = [(block_size // 4, 4 * 64, 1)]
    for b in k2.walk(cfg, block_size):
        if b.fused:
            continue
        if b.bottleneck:
            gather.append((b.bs, b.cm, b.dil))
        else:
            gather += [(b.bs, b.cin, b.dil),
                       (b.bs // b.stride, b.cm, b.dil)]
    gather += programs.of(cfg).k1_head(cfg, block_size)
    return {"gather": gather, "pieces": pieces}


def bound_s(cfg: Dict, block_size: int, k: int) -> float:
    """The least time of one frame's K1 launches over ``k`` blocks: their
    bytes over HBM's rate, in the served dtype."""
    item = 2 if cfg["dtype"] == "bfloat16" else 4
    lists = launches(cfg, block_size)
    nbytes = sum(halo_bytes(bs, c, p, item, k)
                 for bs, c, p in lists["gather"]) \
        + sum(pieces_bytes(bs, c, p, item, k)
              for bs, c, p in lists["pieces"])
    return nbytes / peaks.HBM_BYTES_PER_S
