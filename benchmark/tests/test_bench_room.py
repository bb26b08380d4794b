"""Room for a new model, all as new files beside a BENCHMARK.json of its
own, with its cell and limits, run through the harness on the CPU at the
tiny size and correct, no file of the benchmark edited:

- a configuration of a backbone no cell runs (SwiftNet on ResNeXt-50
  32x4d, grouped 3x3s that K2 does not take): the reference, the weights'
  spec and the MAC count follow its ``backbone``;
- a new architecture, neither SwiftNet nor CSP: its served program
  (``PROGRAM``, written from the program's public pieces) and its plain
  reference (``REFERENCE``) as modules of their own that its
  configuration names, and K1's launches from its own walk and head."""

import hashlib
import json
import textwrap

from benchcell import run, spy_k1, tiny
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


# A toy atrous segmenter: the ResNet stem (stride 4), two basic blocks (the
# second strided, to stride 8), a blocked 3x3 at dilation 2, a dense head of
# rates 1, 2 and 3 and a global-pooling branch through ``noblocks``, and
# 1x1 logits at output stride 8.
PROGRAM = textwrap.dedent('''
    import torch

    from work.k2 import Block


    def stepper(cfg, scfg, shape, capacity, dtype, device):
        from blockcopy_tpu_torch.core.engine import noblocks
        from blockcopy_tpu_torch.core.stepper import FixedCapacityStepper
        from blockcopy_tpu_torch.ops import layers as L

        def cbr(ctx, name, x, p, **kw):
            y = L.conv2d(ctx, name, x, p["conv"]["w"], **kw)
            return L.relu(L.batch_norm(y, p["bn"]["scale"], p["bn"]["bias"]))

        def basic(ctx, name, x, p, stride):
            idt = x
            if "downsample" in p:
                q = p["downsample"]
                idt = L.batch_norm(L.conv2d(ctx, f"{name}.ds", x,
                                            q["conv"]["w"], stride=stride,
                                            padding=0),
                                   q["bn"]["scale"], q["bn"]["bias"])
            h = L.conv2d(ctx, f"{name}.conv1", x, p["conv1"]["w"],
                         stride=stride)
            h = L.relu(L.batch_norm(h, p["bn1"]["scale"], p["bn1"]["bias"]))
            h = L.conv2d(ctx, f"{name}.conv2", h, p["conv2"]["w"])
            h = L.batch_norm(h, p["bn2"]["scale"], p["bn2"]["bias"])
            return L.relu(L.add(h, idt))

        def head(dctx, p, x):
            n, h, w, _ = x.shape
            outs = [cbr(dctx, f"head.rate{r}", x, p[f"rate{r}"], dilation=r)
                    for r in (1, 2, 3)]
            g = cbr(dctx, "head.pool", L.adaptive_avg_pool2d(x, (1, 1)),
                    p["pool"])
            outs.append(g.expand(n, h, w, g.shape[-1]))
            return cbr(dctx, "head.project", torch.cat(outs, -1),
                       p["project"])

        def apply(params, x, ctx):
            st = params["stem"]
            x = L.stem_pool_s2d(ctx, "stem.conv", "stem.pool", x,
                                st["conv1"]["w"], st["bn1"]["scale"],
                                st["bn1"]["bias"])
            x = basic(ctx, "block1", x, params["block1"], 1)
            x = basic(ctx, "block2", x, params["block2"], 2)
            x = cbr(ctx, "dilated", x, params["dilated"], dilation=2)
            x = noblocks(ctx, "head", x,
                         lambda dctx, d: head(dctx, params["head"], d))
            q = params["logits"]
            return L.conv2d(ctx, "logits", x, q["w"], q["b"])

        return FixedCapacityStepper(apply, scfg, shape, capacity,
                                    dtype=dtype, device=device)


    def served(state):
        return {"grid": state["prev_grid"], "outputs": state["outputs"]}


    def reference_layout(rec, geom):
        return rec["outputs"].permute(0, 3, 1, 2), rec["grid"][0]


    def blocks(cfg, block_size):
        bs = block_size // 4
        return [Block(False, bs, 64, 64, 64, 1, 1, False),
                Block(False, bs, 64, 128, 128, 2, 1, False)]


    def k1_head(cfg, block_size):
        return [(block_size // 8, 128, 2)]
''')

REFERENCE = textwrap.dedent('''
    import torch
    import torch.nn.functional as F

    from reference import nets
    from reference.nets import Leaf, bn, conv, relu


    def _cb(cin, cout, k):
        return {"conv": nets._conv_leaf(cout, cin, k),
                "bn": nets._bn_leaf(cout)}


    def _basic(cin, cout):
        p = {"conv1": nets._conv_leaf(cout, cin, 3), "bn1": nets._bn_leaf(cout),
             "conv2": nets._conv_leaf(cout, cout, 3),
             "bn2": nets._bn_leaf(cout, 0.25)}
        if cin != cout:
            p["downsample"] = {"conv": nets._conv_leaf(cout, cin, 1),
                               "bn": nets._bn_leaf(cout)}
        return p


    def spec_atrous(cfg):
        n = cfg["num_classes"]
        return {
            "stem": {"conv1": nets._conv_leaf(64, 3, 7),
                     "bn1": nets._bn_leaf(64)},
            "block1": _basic(64, 64), "block2": _basic(64, 128),
            "dilated": _cb(128, 128, 3),
            "head": {"rate1": _cb(128, 32, 1), "rate2": _cb(128, 32, 3),
                     "rate3": _cb(128, 32, 3), "pool": _cb(128, 32, 1),
                     "project": _cb(128, 64, 1)},
            "logits": {"w": nets._conv_leaf(n, 64, 1)["w"],
                       "b": Leaf((n,), 0.0, 0.1)},
        }


    def atrous(fr, p, x, cfg):
        x = nets.stem(fr, p["stem"], x)
        x = nets.basic(fr, "block1", x, p["block1"], 1, 1)
        x = nets.basic(fr, "block2", x, p["block2"], 2, 1)
        q = p["dilated"]
        x = relu(bn(conv(fr, "dilated", x, q["conv"]["w"], pad=2, dil=2),
                    q["bn"]))
        x = fr.site("head", x)
        h = p["head"]

        def cb(name, t, r=1):
            w = h[name]["conv"]["w"]
            pad = r * (w.shape[2] // 2)
            return relu(bn(conv(fr, f"head.{name}", t, w, pad=pad, dil=r,
                                blocked=False), h[name]["bn"]))
        outs = [cb(f"rate{r}", x, r) for r in (1, 2, 3)]
        outs.append(cb("pool", F.adaptive_avg_pool2d(x, 1)).expand(
            -1, -1, x.shape[2], x.shape[3]))
        y = cb("project", torch.cat(outs, 1))
        q = p["logits"]
        return fr.site("out", conv(fr, "logits", y, q["w"], q["b"]))
''')

ATROUS = "semseg-atrous-b128-t05"


def test_a_new_architecture_needs_only_new_files(tmp_path, monkeypatch):
    before = _files()
    (tmp_path / "room_atrous_program.py").write_text(PROGRAM)
    (tmp_path / "room_atrous_reference.py").write_text(REFERENCE)
    monkeypatch.syspath_prepend(str(tmp_path))
    conf = json.loads((BENCH / "configs" / "swiftnet-rn18-cityscapes.json")
                      .read_text())
    for k in ("backbone", "num_features", "spp_grids", "spp_levels"):
        del conf[k]
    conf.update(name="atrous-toy-cityscapes",
                reference="room_atrous_reference.atrous",
                program="room_atrous_program")
    (tmp_path / "atrous.json").write_text(json.dumps(conf))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [{
        "name": conf["name"], "source": "https://arxiv.org/abs/1706.05587",
        "file": str(tmp_path / "atrous.json"), "reduced": [],
        "why": "a toy atrous segmenter at output stride 8"}]
    spec["workloads"] = [{
        "name": ATROUS, "config": conf["name"], "traffic": "street-b128",
        "chips": 1, "why": "a dilated blocked 3x3, a dense multi-rate head"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "checks").mkdir()
    (tmp_path / "checks" / f"{ATROUS}.json").write_text(
        (BENCH / "checks" / "semseg-rn18-b128-t05.json").read_text())
    monkeypatch.setattr(check, "ROOT", tmp_path)
    seen = spy_k1(monkeypatch)

    cell = tiny(ATROUS, 7, bench_json=tmp_path / "BENCHMARK.json")
    out = run(cell)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"], checks
    assert checks["out_gap"] < 1e-4 and checks["grid_gap"] == 0.0
    assert checks["grad_gap"] < 1e-3

    from work import k1, macs
    bs = cell.traffic["block_size"]
    want = k1.launches(cell.cfg, bs)
    # its own walk and head: the blocks' 3x3s, the dilated 3x3 at stride 8
    assert want["gather"][1:] == [(16, 64, 1)] * 3 + [(8, 128, 1),
                                                      (8, 128, 2)]
    frames = len(seen["pieces"]) // len(want["pieces"])
    assert frames >= 7
    for kind in ("gather", "pieces"):
        assert seen[kind] == want[kind] * frames
    # logits at output stride 8: 16 x 32 of the 128 x 256 frame
    assert macs.model_tally(cell.cfg, bs)["logits"] == (16 * 32 * 19 * 64,
                                                        True)
    assert _files() == before
