"""A cell's run: one rank on one chip, or one rank a chip spawned through
the program's clip-parallel launcher (NCCL), then the result line."""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from harness.check import limits
from harness.report import assemble
from harness.window import serve_rank


def _vote(ctl):
    import torch.distributed as dist

    def vote(flag: bool) -> bool:
        t = torch.tensor([1.0 if flag else 0.0])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=ctl)
        return bool(t.item() > 0)
    return vote


def rank_main(group, cell, seed: int, seconds: float, trace: bool,
              t0: float) -> Dict:
    """One clip-parallel rank: its window ends when every rank agrees
    (a host vote on gloo at each clip boundary)."""
    import torch.distributed as dist
    torch.set_num_threads(2)
    ctl = dist.new_group(backend="gloo")
    return serve_rank(cell, seed, seconds, trace, t0, group.device, group,
                      _vote(ctl))


def loaded_in(reports) -> list:
    """The forbidden modules any rank held once its window had closed."""
    return sorted(set().union(*(r["forbidden"] for r in reports)))


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device=None, log=None) -> Tuple[Dict, list]:
    """The result line's object, and ``loaded_in`` the ranks.  ``device``
    None: the card(s); a test may pass the CPU, with ``cell.chips`` 1."""
    if cell.chips == 1:
        dev = torch.device("cuda", 0) if device is None else \
            torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        reports = [serve_rank(cell, seed, seconds, trace, t0, dev)]
    else:
        from blockcopy_tpu_torch.parallel import clip_parallel
        spec = clip_parallel.make_group(cell.chips)
        reports = clip_parallel.spawn(spec, rank_main, cell, seed, seconds,
                                      trace, t0, timeout=340 - (time.time()
                                                                - t0))
    kind = torch.cuda.get_device_name(0) if device is None else "cpu"
    return (assemble(cell, reports, trace, kind, limits(cell.name), log),
            loaded_in(reports))
