"""The comparison that decides ``correct``: each recorded clip, as the
program served it in the window, judged by the plain reference.

The reference takes the benchmark's own weights, frames and uniforms (the
values the program was handed) and works out everything else again.  A
clip recorded after the window's first starts from the program's policy
at that clip's start: the one state the reference cannot work out
without following every clip before it.  The window's first clip starts
from the benchmark's own initial policy, so that start is checked too.
On clip-parallel ranks the reference averages its gradients over the
ranks as the program does, and the ranks' policies after each update are
compared with each other (``rank_gap``, exact).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import torch

from harness.weights import as_fp32, realize, sub_seed
from reference import plain_fp32
from reference.clip import Served, Start, Task, run_clip

ROOT = Path(__file__).resolve().parents[1]


def limits(workload: str) -> Dict[str, float]:
    """Each compared number's limit for a cell (``checks/<cell>.json``)."""
    return json.loads((ROOT / "checks" / f"{workload}.json").read_text())[
        "limits"]


def _part(snap: Dict[str, torch.Tensor], prefix: str):
    n = len(prefix)
    return {k[n:]: v.float() for k, v in snap.items() if k.startswith(prefix)}


@plain_fp32()
def judge(cell, seed: int, recs, geom, pol0, host, draws, device,
          group=None) -> Dict[str, float]:
    """The worst of each gap over the recorded clips, float32 meaning
    float32 (``plain_fp32``)."""
    from harness.window import model_spec
    cfg, tr = cell.cfg, cell.traffic
    p_ref = as_fp32(realize(model_spec(cfg), sub_seed(seed, 1),
                            getattr(torch, cfg["dtype"]), device))
    task = Task(cfg, (cfg["height"], cfg["width"]), tr["block_size"])
    gh = cfg["height"] // tr["block_size"]
    gw = cfg["width"] // tr["block_size"]
    capacity = max(1, int(round(cfg["target"] * gh * gw)))
    wg = None if group is None else group.pg
    gaps: Dict[str, float] = {}
    for i, rec in sorted(recs.items()):
        slot = i % tr["clips"]
        got = rec.served(geom)
        n = len(got.outputs)
        frames = [f.to(device).permute(0, 3, 1, 2).float()
                  for f in host[slot][:n]]
        snap = pol0 if i == 0 else rec.start
        start = Start(_part(snap, "params/"), _part(snap, "sq/"),
                      snap["running_cost"].float())
        served = Served(got.grids, got.outputs,
                        {t: _part(s, "sq/") for t, s in rec.after.items()
                         if t <= n},
                        {t: _part(s, "params/")
                         for t, s in rec.after.items() if t <= n},
                        _part(rec.end_state, "params/"))
        _, g = run_clip(task, p_ref, frames, draws[slot], start, capacity,
                        "fp32", served, wg)
        for k, v in g.items():
            gaps[k] = max(gaps.get(k, 0.0), v)
        if group is not None:
            gaps["rank_gap"] = max(gaps.get("rank_gap", 0.0),
                                   rank_spread(rec, wg))
    return gaps


def rank_spread(rec, pg) -> float:
    """The largest difference between two ranks' policy parameters after
    any of the clip's train frames and at its end."""
    import torch.distributed as dist
    worst = 0.0
    for t, snap in list(rec.after.items()) + [(None, rec.end_state)]:
        if t is not None and t > rec.count:
            continue
        flat = torch.cat([v.reshape(-1).float()
                          for k, v in sorted(snap.items())
                          if k.startswith("params/")])
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=pg)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=pg)
        worst = max(worst, float((hi - lo).max()))
    return worst


def verdict(gaps: Dict[str, float], lim: Dict[str, float]):
    """(correct, lines): every limited number present and within its
    limit."""
    ok, lines = True, []
    for name, limit in lim.items():
        value = gaps.get(name)
        good = value is not None and value <= limit
        ok = ok and good
        lines.append((name, value, limit, good))
    return ok, lines
