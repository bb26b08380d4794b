"""A cell as ``BENCHMARK.json`` names it: its configuration file, its
traffic file and its chips, found by name.  Loading a cell whose
configuration names no served program (``programs.of``) raises."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict

import programs

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    cfg: Dict
    traffic: Dict
    chips: int
    spec: Dict          # the whole BENCHMARK.json


def load(workload: str, bench_json: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = json.loads(Path(bench_json).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_json}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    programs.of(cfg)        # a configuration names its served program
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(workload, cfg, traffic, w["chips"], spec)


def metrics_of(cell: Cell, kind: str):
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in cell.spec[kind]
            if "workloads" not in m or cell.name in m["workloads"]]
