"""K2's work: the fused bottleneck tails of a configuration at a block
size, and the operations and bytes of each (frozen from ``chip_smoke.py``
``tail_cost``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import programs
from reference.nets import PLANES, RESNETS
from work import peaks


@dataclasses.dataclass(frozen=True)
class Block:
    """A backbone block as the served model runs it over blocks of ``bs``
    px at its input: ``cm`` its 3x3's channels (a bottleneck's inner
    width, a basic block's planes), ``fused`` whether K2 runs its tail."""
    bottleneck: bool
    bs: int
    cin: int
    cm: int
    cout: int
    stride: int
    dil: int
    fused: bool


def blocks(cfg: Dict, block_size: int) -> Iterator[Block]:
    """Every backbone block in order.  K2 takes a bottleneck's tail where
    the served gate does: groups 1, the stride-1 identity block, undilated,
    Cm and Co multiples of 128 and blocks at least 8 px.  SwiftNet names
    its ResNet; the served CSP is ResNet-50 only."""
    net = RESNETS[cfg.get("backbone", "resnet50")]
    strides = cfg.get("strides", (1, 2, 2, 2))
    dilations = cfg.get("dilations", (1, 1, 1, 1))
    cin, at = 64, 4
    for s, planes in enumerate(PLANES):
        cout = planes * net.expansion
        cm = net.width(planes) if net.bottleneck else planes
        for i in range(net.layers[s]):
            stride = strides[s] if i == 0 else 1
            bs = block_size // at
            fused = (net.bottleneck and net.groups == 1 and stride == 1
                     and cin == cout and dilations[s] == 1
                     and cm % 128 == 0 and cout % 128 == 0 and bs >= 8)
            yield Block(net.bottleneck, bs, cin, cm, cout, stride,
                        dilations[s], fused)
            cin, at = cout, at * stride


def walk(cfg: Dict, block_size: int) -> Iterator[Block]:
    """The served backbone's blocks: its program module's own ``blocks``
    where the module gives one, ``blocks`` here otherwise."""
    return getattr(programs.of(cfg), "blocks", blocks)(cfg, block_size)


def tail_cost(bs, cm, co, itemsize, k):
    """K2's operations and the bytes it must move: h1, x, y, each block's
    halo (4 bs + 4 pixels of its neighbours' strips), the weights and the
    block indices, each once."""
    flops = 2 * k * bs * bs * cm * (9 * cm + co)
    elems = (k * bs * bs * (cm + 2 * co) + k * (4 * bs + 4) * cm
             + 9 * cm * cm + cm * co + 2 * cm + 2 * co)
    return flops, elems * itemsize + 8 * k


def tails(cfg, block_size: int) -> List[Tuple[int, int, int]]:
    """(bs, Cm, Co) of each bottleneck the program fuses into K2."""
    return [(b.bs, b.cm, b.cout) for b in walk(cfg, block_size)
            if b.fused]


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
