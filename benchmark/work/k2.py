"""K2's work: the fused bottleneck tails of a configuration at a block
size, and the operations and bytes of each (frozen from ``chip_smoke.py``
``tail_cost``)."""

from __future__ import annotations

from typing import List, Tuple

from work import peaks

STAGE_PLANES = (64, 128, 256, 512)
STAGE_BLOCKS = (3, 4, 6, 3)


def tail_cost(bs, cm, co, itemsize, k):
    """K2's operations and the bytes it must move: h1, x, y, each block's
    halo (4 bs + 4 pixels of its neighbours' strips), the weights and the
    block indices, each once."""
    flops = 2 * k * bs * bs * cm * (9 * cm + co)
    elems = (k * bs * bs * (cm + 2 * co) + k * (4 * bs + 4) * cm
             + 9 * cm * cm + cm * co + 2 * cm + 2 * co)
    return flops, elems * itemsize + 8 * k


def tails(cfg, block_size: int) -> List[Tuple[int, int, int]]:
    """(bs, Cm, Co) of each ResNet-50 bottleneck the program fuses into
    K2: the stride-1 identity blocks (every block of a stage but its
    first), undilated, with Cm a multiple of 128 and blocks at least 8 px
    at that stage."""
    strides = cfg.get("strides", (1, 2, 2, 2))
    dilations = cfg.get("dilations", (1, 1, 1, 1))
    out, stride = [], 4
    for s in range(4):
        stride *= strides[s]
        bs, cm = block_size // stride, STAGE_PLANES[s]
        if dilations[s] == 1 and cm % 128 == 0 and bs >= 8:
            out += [(bs, cm, 4 * cm)] * (STAGE_BLOCKS[s] - 1)
    return out


def launches_per_tail(dtype: str) -> int:
    """bf16 runs a tail as one kernel, fp32 as two (3x3, then 1x1)."""
    return 1 if dtype == "bfloat16" else 2


def bound_s(cfg, block_size: int, k: int) -> float:
    """The least time of one frame's tails over ``k`` blocks: each tail's
    larger of operations over the peak and bytes over HBM's rate."""
    item = 2 if cfg["dtype"] == "bfloat16" else 4
    peak = peaks.flops_for(cfg["dtype"])
    total = 0.0
    for bs, cm, co in tails(cfg, block_size):
        flops, nbytes = tail_cost(bs, cm, co, item, k)
        total += max(flops / peak, nbytes / peaks.HBM_BYTES_PER_S)
    return total
