"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the served program.  Modules are compared by
their top-level name, whole: ``blockcopy_tpu_torch`` begins with
``blockcopy_tpu``."""

import re
import subprocess
import sys
import types

from harness.cell import BENCH, ROOT

JAX = {"jax", "jaxlib", "flax", "blockcopy_tpu"}


def _top_levels(code: str) -> set:
    prog = (f"import sys\nsys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}, "
            f"{str(BENCH / 'tests')!r}]\n{code}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(eval(res.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_levels(
        "import run, calibrate\n"
        "from harness.modules import forbidden_modules\n"
        "from benchcell import run as rehearse, tiny\n"
        "rehearse(tiny('semseg-rn50-b128-t05'), trace=True)\n"
        "rehearse(tiny('det-csp-r50-b128-t03'))\n"
        "assert forbidden_modules() == []\n")
    assert "blockcopy_tpu_torch" in mods and "harness" in mods
    assert not mods & JAX


def _load_flax():
    sys.modules["flax"] = types.ModuleType("flax")


def test_two_ranks_load_no_jax():
    """Each clip-parallel rank (a spawned process, which imports modules
    the parent never loads) reports what it holds after its window."""
    from benchcell import run_ranks, serve_as_rank
    from harness.main import loaded_in
    _, reports = run_ranks(serve_as_rank)
    assert [r["forbidden"] for r in reports] == [[], []]
    assert loaded_in(reports) == []
    _, reports = run_ranks(serve_as_rank, _load_flax)
    assert loaded_in(reports) == ["flax"]


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_levels(
        "import reference, reference.nets, reference.policy, "
        "reference.tasks, reference.clip\n"
        "import work.k1, work.k2, work.macs, work.peaks\n")
    assert "reference" in mods
    assert not mods & (JAX | {"blockcopy_tpu_torch", "harness"})


def test_no_source_imports_them():
    pat = re.compile(r"^\s*(?:import|from)\s+([A-Za-z_][A-Za-z0-9_]*)", re.M)
    for path in BENCH.rglob("*.py"):
        names = set(pat.findall(path.read_text()))
        assert not names & JAX, path
        if path.parent.name in ("reference", "work"):
            assert "blockcopy_tpu_torch" not in names, path


def test_forbidden_names_compare_whole():
    from harness.modules import forbidden_modules
    saved = dict(sys.modules)
    try:
        sys.modules["blockcopy_tpu_torch_x"] = sys
        assert "blockcopy_tpu" not in forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert forbidden_modules() == ["jax"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
