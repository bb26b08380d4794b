"""GEMM kernel module (``ops/kernels/mm.py``) and the port's rate probe
(``tools/probe_int8.py``): the plain versions held against the JAX probe's
Pallas ``make_mm`` (interpret mode) on the same numpy inputs, int8 bitwise
and bf16 within one bf16 ulp; the wrappers' refusals; the probe's entry
point and rate arithmetic.  The CUDA kernels are held against the plain
versions in ``test_torch_kernels_gpu.py``."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import mm as MM
from blockcopy_tpu_torch.tools import probe_int8 as TP
from torch_port_util import assert_close, assert_same, tt
from torch_port_util import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _jax_probe():
    """``tools/probe_int8.py`` of the JAX package (``tools/`` is no
    package), loaded by file path."""
    spec = importlib.util.spec_from_file_location(
        "jax_probe_int8", ROOT / "tools" / "probe_int8.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rows,k,n", [(256, 288, 128), (256, 1152, 128),
                                      (256, 288, 256)])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_plain_matches_jax_make_mm(rows, k, n, kind):
    """bf16: the port rounds the fp32 sum once, as the Pallas kernel does;
    sums taken in another order may round to the neighbouring bf16 value,
    so one ulp (rtol 2^-7) and 1e-3 near 0.  int8: exact."""
    probe = _jax_probe()
    rs = np.random.RandomState(rows + k + n)
    if kind == "bf16":
        x = jnp.asarray(rs.randn(rows, k), jnp.bfloat16)
        w = jnp.asarray(rs.randn(k, n), jnp.bfloat16)
        types = (jnp.bfloat16, jnp.float32, jnp.bfloat16)
    else:
        x = jnp.asarray(rs.randint(-128, 128, (rows, k)), jnp.int8)
        w = jnp.asarray(rs.randint(-128, 128, (k, n)), jnp.int8)
        types = (jnp.int8, jnp.int32, jnp.int32)
    # the mode is read when the pallas_call is made, so make_mm runs inside
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(probe.make_mm(rows, k, n, *types, 64)(x, w))
    before = dict(kernels.launches)
    if kind == "bf16":
        got = MM.mm_bf16(tt(x), tt(w))
        assert got.dtype == torch.bfloat16
        assert_close(ref, got, rtol=2 ** -7, atol=1e-3)
    else:
        got = MM.mm_int8(tt(x), tt(w))
        assert got.dtype == torch.int32
        assert_same(ref, got)
    assert kernels.launches == before          # CPU: plain version only


def test_int8_widens():
    """Sums of +-127 * 127 over k = 64 leave int8 (and int16): the result is
    exact in int32."""
    rs = np.random.RandomState(0)
    x = np.where(rs.rand(128, 64) < 0.5, -127, 127).astype(np.int8)
    w = np.full((64, 8), 127, np.int8)
    got = MM.mm_int8(torch.from_numpy(x), torch.from_numpy(w))
    want = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(want).max() > 2 ** 15
    np.testing.assert_array_equal(got.numpy(), want)


def _bad_calls():
    i8 = dict(dtype=torch.int8)
    bf = dict(dtype=torch.bfloat16)
    meta = torch.device("meta")
    return {
        "meta": (MM.mm_bf16, torch.empty((128, 64), device=meta, **bf),
                 torch.empty((64, 8), device=meta, **bf)),
        "meta_int8": (MM.mm_int8, torch.empty((128, 64), device=meta, **i8),
                      torch.empty((64, 8), device=meta, **i8)),
        "rows": (MM.mm_int8, torch.zeros((100, 64), **i8),
                 torch.zeros((64, 8), **i8)),
        "k_int8": (MM.mm_int8, torch.zeros((128, 48), **i8),
                   torch.zeros((48, 8), **i8)),
        "k_bf16": (MM.mm_bf16, torch.zeros((128, 24), **bf),
                   torch.zeros((24, 8), **bf)),
        "n": (MM.mm_bf16, torch.zeros((128, 32), **bf),
              torch.zeros((32, 12), **bf)),
        "inner": (MM.mm_bf16, torch.zeros((128, 32), **bf),
                  torch.zeros((64, 8), **bf)),
        "dtype": (MM.mm_int8, torch.zeros((128, 64)), torch.zeros((64, 8))),
        "mixed": (MM.mm_bf16, torch.zeros((128, 32), **bf),
                  torch.zeros((32, 8))),
        "overflow": (MM.mm_int8, torch.zeros((128, 2 ** 17), **i8),
                     torch.zeros((2 ** 17, 8), **i8)),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrappers_refuse(case):
    """What the kernel cannot take is refused on every device (the CPU
    included), and a device that is neither CPU nor CUDA always."""
    fn, x, w = _bad_calls()[case]
    with pytest.raises(ValueError):
        fn(x, w)


def test_probe_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.main([])
    with pytest.raises(ValueError, match="chunk"):
        TP.main(["--rows", "1000"])


def test_rate_arithmetic_matches_jax_tool(monkeypatch, capsys):
    """The JAX tool's ``main`` with its timing replaced by fixed rates
    (products per second, in call order bf16, int8, bf16, int8) prints the
    line that ``report`` gives for the best rate of each."""
    probe = _jax_probe()
    rates = iter([1234.5, 2011.25, 1300.75, 1999.0])
    monkeypatch.setattr(probe, "bench", lambda *a: next(rates))
    monkeypatch.setattr("sys.argv", ["probe_int8.py", "--rows", "128",
                                     "--k", "64", "--n", "128",
                                     "--chunk", "64"])
    probe.main()
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert TP.report(128, 64, 128, 1300.75, 2011.25) == jax_line


PLAN_SHAPES = [(16384, 2304, 256), (16384, 1152, 128), (4096, 2304, 256),
               (128, 64, 8), (128, 160, 136), (384, 1152, 128),
               (16896, 96, 24), (512, 1152, 136)]


@pytest.mark.parametrize("itemsize", [2, 1])
@pytest.mark.parametrize("rows,k,n", PLAN_SHAPES)
def test_plan_covers_every_tile_once(rows, k, n, itemsize):
    """The grid of ``plan`` (row blocks x column tiles x k splits, cut as
    the kernel cuts them) covers every output tile once per split, the
    splits of a tile cover its k chunks once and in order, and every CTA
    keeps at least one chunk."""
    p = MM.plan(rows, k, n, 132, itemsize)
    assert p.bn in (128, 256) and p.cluster in (1, 2)
    assert (rows // MM.ROW_TILE) % p.cluster == 0
    chunks = -(-k * itemsize // MM.CHUNK_BYTES)
    cover = np.zeros((rows, -(-n // p.bn) * p.bn), np.int64)
    for bx in range(rows // MM.ROW_TILE):
        for by in range(-(-n // p.bn)):
            cover[bx * MM.ROW_TILE:(bx + 1) * MM.ROW_TILE,
                  by * p.bn:(by + 1) * p.bn] += p.splits
    assert (cover == p.splits).all()
    parts = MM.split_ranges(chunks, p.splits)
    assert parts[0][0] == 0 and all(count >= 1 for _, count in parts)
    assert all(a + c == b for (a, c), (b, _) in zip(parts, parts[1:]))
    assert sum(count for _, count in parts) == chunks
    assert chunks * MM.CHUNK_BYTES >= k * itemsize > (chunks - 1) * \
        MM.CHUNK_BYTES


@pytest.mark.parametrize("itemsize", [2, 1])
@pytest.mark.parametrize("rows,k,n", PLAN_SHAPES[:3])
def test_plan_fills_the_card(rows, k, n, itemsize):
    """At the shapes of ``chip_smoke.py`` the plan puts at least 128 CTAs
    on the 132 SMs of an H100 (4096x2304x256 as 128-column tiles with k
    split 2 ways), and never more than one wave."""
    p = MM.plan(rows, k, n, 132, itemsize)
    ctas = rows // MM.ROW_TILE * -(-n // p.bn) * p.splits
    assert 128 <= ctas <= 132
    assert (p.bn, p.splits) == ((128, 2) if rows == 4096 else (n, 1))
