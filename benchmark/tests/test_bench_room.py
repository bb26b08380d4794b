"""Room for a new model: a configuration of a backbone no cell runs
(SwiftNet on ResNeXt-50 32x4d, grouped 3x3s that K2 does not take), with
its cell and limits, all as new files beside a BENCHMARK.json of its own,
runs through the harness on the CPU at the tiny size and is correct: the
reference, the weights' spec and the MAC count follow its ``backbone``,
and no file of the benchmark is edited."""

import hashlib
import json

from benchcell import run, tiny
from harness import check
from harness.cell import BENCH, ROOT

CELL = "semseg-rnx50-b128-t05"


def _files():
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(BENCH.rglob("*")) if p.is_file()
            and not {".cache", "__pycache__"} & set(p.parts)}


def test_a_new_backbone_needs_only_new_files(tmp_path, monkeypatch):
    before = _files()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((BENCH / "configs" / "swiftnet-rn18-cityscapes.json")
                      .read_text())
    conf.update(name="swiftnet-rnx50-cityscapes", backbone="resnext50_32x4d")
    (tmp_path / "rnx50.json").write_text(json.dumps(conf))
    spec["configs"].append({
        "name": conf["name"], "source": "https://arxiv.org/abs/1611.05431",
        "file": str(tmp_path / "rnx50.json"), "reduced": [],
        "why": "SwiftNet on ResNeXt-50 32x4d"})
    spec["workloads"].append({
        "name": CELL, "config": conf["name"], "traffic": "street-b128",
        "chips": 1, "why": "grouped 3x3s through cuDNN and K1"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "checks").mkdir()
    (tmp_path / "checks" / f"{CELL}.json").write_text(
        (BENCH / "checks" / "semseg-rn50-b128-t05.json").read_text())
    monkeypatch.setattr(check, "ROOT", tmp_path)

    cell = tiny(CELL, 7, bench_json=tmp_path / "BENCHMARK.json")
    out = run(cell)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"], checks
    assert checks["out_gap"] < 1e-4 and checks["grid_gap"] == 0.0
    assert checks["grad_gap"] < 1e-3
    assert _files() == before
