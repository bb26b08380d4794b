"""The run's last line, from the ranks' reports and the metrics' readers
(``metrics/<name>.py``, each ``read(run) -> number | None``)."""

from __future__ import annotations

import importlib
import sys
from typing import Dict, List

from harness.cell import Cell, metrics_of
from harness.check import verdict
from work.macs import frame_macs
from work.peaks import flops_for


def run_view(cell: Cell, reports: List[Dict]) -> Dict:
    """What every reader sees: the ranks' reports, the cell, and the
    work of each kind of frame."""
    cfg, tr = cell.cfg, cell.traffic
    bs = tr["block_size"]
    total = (cfg["height"] // bs) * (cfg["width"] // bs)
    capacity = max(1, int(round(cfg["target"] * total)))
    return {"cell": cell, "ranks": reports, "block_size": bs,
            "capacity": capacity, "total_blocks": total,
            "macs": frame_macs(cfg, bs, capacity),
            "peak_flops": flops_for(cfg["dtype"])}


def read_metrics(run: Dict, kind: str, log) -> Dict:
    out = {}
    for m in metrics_of(run["cell"], kind):
        reader = importlib.import_module(f"metrics.{m['name']}")
        value = reader.read(run, log)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def assemble(cell: Cell, reports: List[Dict], trace: bool, device_kind: str,
             lim: Dict[str, float], log=None) -> Dict:
    log = log or (lambda msg: print(msg, file=sys.stderr))
    run = run_view(cell, reports)
    gaps: Dict[str, float] = {}
    for r in reports:
        for k, v in r["gaps"].items():
            gaps[k] = max(gaps.get(k, 0.0), v)
    recorded = sum(sum(r["recorded"].values()) for r in reports)
    ok, lines = verdict(gaps, lim)
    ok = ok and recorded > 0
    metrics = read_metrics(run, "per_layer" if trace else "end_to_end", log)
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in reports)}
    out = {"correct": ok, "attempted": sum(r["frames"] for r in reports),
           "failed": 0 if ok else recorded, "metrics": metrics,
           "device": device}
    if trace:
        traces = [r["trace"] for r in reports if r["trace"]]
        if traces:
            device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
            device["window_s"] = sum(t["window_s"] for t in traces) \
                / len(traces)
            ops = sorted(traces[0]["ops"].items(), key=lambda kv: -kv[1][1])
            out["breakdown"] = {
                "device_ops": [[n, v[1]] for n, v in ops[:10]],
                "idle_gaps": traces[0]["idle_gaps"]}
    log(f"compared {recorded} frames of recorded clips")
    for name, value, limit, good in lines:
        log(f"check {name} {value} limit {limit} {'ok' if good else 'FAIL'}")
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit, _ in lines}
    return out
