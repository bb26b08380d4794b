"""The served program is the module a configuration names (``programs/``),
and moving the two architectures there moved no reading: for each cell, at
the tiny CPU size and at the cell's own size on the meta device, the
weights, the MAC count, K1's and K2's lists and bounds, the stepper with
its model configuration, and the served tensors are what the harness gave
when it named SwiftNet and CSP in its own code (``pinned_programs.json``,
taken from that code).  A configuration that names no module, or one that
is not there, stops a run before any weights are drawn."""

import hashlib
import inspect
import json
from pathlib import Path

import pytest
import torch

import programs
from benchcell import run, tiny
from harness import cell as cells
from harness import program
from harness.weights import _leaves, realize
from harness.window import model_spec
from work import k1, k2, macs

PINNED = json.loads((Path(__file__).parent / "pinned_programs.json")
                    .read_text())
CELLS = ["semseg-rn50-b128-t05", "det-csp-r50-b128-t03",
         "semseg-rn50-b256-t05", "semseg-rn50-b128-t05-x4",
         "semseg-rn18-b128-t05"]
SIZES = ["tiny", "full"]
SEED = 12345


def _cell(workload, size):
    return tiny(workload) if size == "tiny" else cells.load(workload)


def _geometry(cell):
    cfg, bs = cell.cfg, cell.traffic["block_size"]
    total = (cfg["height"] // bs) * (cfg["width"] // bs)
    return cfg, bs, max(1, int(round(cfg["target"] * total)))


def _meta_params(spec, dtype):
    if isinstance(spec, dict):
        return {k: _meta_params(v, dtype) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_meta_params(v, dtype) for v in spec]
    return torch.empty(spec.shape, device="meta",
                       dtype=torch.float32 if spec.f32 else dtype)


def _model_config(stepper) -> str:
    if hasattr(stepper, "csp_cfg"):
        return repr(stepper.csp_cfg)
    return repr(inspect.getclosurevars(stepper.apply_fn).nonlocals["cfg"])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("workload", CELLS)
def test_weights_are_pinned(workload, size):
    cfg = _cell(workload, size).cfg
    tree = realize(model_spec(cfg), SEED, getattr(torch, cfg["dtype"]),
                   "cpu")
    h, count = hashlib.sha256(), 0
    for path, t in _leaves(tree):
        h.update(path.encode())
        h.update(str(t.dtype).encode())
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
        count += t.numel()
    assert [h.hexdigest(), count] == PINNED[f"{workload}/{size}"]["weights"]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("workload", CELLS)
def test_work_counts_are_pinned(workload, size):
    cfg, bs, cap = _geometry(_cell(workload, size))
    want = PINNED[f"{workload}/{size}"]
    assert macs.frame_macs(cfg, bs, cap) == want["macs"]
    assert {k: [list(x) for x in v]
            for k, v in k1.launches(cfg, bs).items()} == want["k1"]
    assert [list(b.__dict__.values()) for b in k2.walk(cfg, bs)] == \
        want["k2_blocks"]
    assert k1.bound_s(cfg, bs, cap) == want["k1_bound"]
    assert k2.bound_s(cfg, bs, cap) == want["k2_bound"]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("workload", CELLS)
def test_stepper_and_served_are_pinned(workload, size):
    """The stepper's class, model and stepper configurations, capacity,
    frame and dtype; the served tensors' keys, shapes and dtypes (of the
    state ``program.build`` makes on the CPU; at full size of the
    canvases and task outputs of the stepper's shape pass), and their
    reference layout's shapes."""
    cfg, bs, _ = _geometry(_cell(workload, size))
    want = PINNED[f"{workload}/{size}"]
    dtype = getattr(torch, cfg["dtype"])
    prog = programs.of(cfg)
    if size == "tiny":
        params = realize(model_spec(cfg), SEED, dtype, "cpu")
        st, state = program.build(cfg, bs, params, torch.device("cpu"))[:2]
    else:
        st = program.make_stepper(cfg, bs, "meta")
        ctx, task = st._shape_pass(_meta_params(model_spec(cfg), dtype),
                                   st.total)
        state = {"prev_grid": torch.empty(st.geom, device="meta"),
                 "canvases": ctx.canvases, **task}
    assert [type(st).__name__, _model_config(st), repr(st.cfg), st.capacity,
            list(st.frame_shape), str(st.dtype)] == want["stepper"]
    served = prog.served(state)
    assert {k: [list(v.shape), str(v.dtype)]
            for k, v in sorted(served.items())} == want["served"]
    rec = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in served.items()}
    out, grid = prog.reference_layout(rec, st.geom)
    if isinstance(out, dict):
        layout = {f"maps/{i}": list(m.shape)
                  for i, m in enumerate(out["maps"])}
        layout.update({f"boxes/{i}": list(b.shape)
                       for i, b in enumerate(out["boxes"])})
    else:
        layout = {"outputs": list(out.shape)}
    layout["grid"] = list(grid.shape)
    assert layout == want["layout"]


def _without_program(cfg):
    cfg.pop("program")


def _program_not_there(cfg):
    cfg["program"] = "programs.not_a_model"


@pytest.mark.parametrize("change", [_without_program, _program_not_there],
                         ids=["no key", "no module"])
def test_a_configuration_names_its_program(tmp_path, monkeypatch, change):
    """At load, with the key and the configuration named in the message;
    and in a run handed such a configuration, before any weights are
    drawn."""
    from harness import window
    from harness.cell import BENCH, ROOT
    conf = json.loads((BENCH / "configs" / "swiftnet-rn18-cityscapes.json")
                      .read_text())
    change(conf)
    (tmp_path / "conf.json").write_text(json.dumps(conf))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        if c["name"] == conf["name"]:
            c["file"] = str(tmp_path / "conf.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(LookupError, match=r"swiftnet-rn18-cityscapes.*"
                                          r"'program'"):
        cells.load("semseg-rn18-b128-t05",
                   bench_json=tmp_path / "BENCHMARK.json")

    def drawn(*a, **k):
        raise AssertionError("weights drawn")
    monkeypatch.setattr(window, "realize", drawn)
    cell = tiny("semseg-rn18-b128-t05")
    change(cell.cfg)
    with pytest.raises(LookupError, match="'program'"):
        run(cell)


def test_the_work_counts_load_nothing_of_the_program():
    """K1's and K2's lists read the program modules without the program."""
    from harness.cell import BENCH
    from test_bench_isolation import JAX, _top_levels
    mods = _top_levels(
        "import json, pathlib\n"
        "from work import k1, k2\n"
        f"for p in sorted(pathlib.Path({str(BENCH)!r}).glob('configs/*')):\n"
        "    cfg = json.loads(p.read_text())\n"
        "    k1.launches(cfg, 128), k2.tails(cfg, 128)\n")
    assert {"programs", "work"} <= mods
    assert not mods & (JAX | {"blockcopy_tpu_torch", "harness"})
