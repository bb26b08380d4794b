"""K1's launch plan (``ops/kernels/halo.py`` ``halo_plan``) on the CPU,
without JAX.  At every halo shape of the semseg paths at block 128 and 256
and of the detection path (``chip_smoke.py``'s ``HALO_SHAPES``,
``HALO_SHAPES_256``, ``DET_HALO_SHAPES``), pads 1-3, bf16 and fp32, the
capacities the steppers and ladders run and 132 or 1 SMs: the plan's shares
cover every (block, padded row) exactly once, its shared memory fits, and at
K = 8 it gives the card at least one CTA an SM wherever the launch has that
many rows.  Then ``gather_by_plan``, the plain inputs assembled in the
plan's order, piece by piece from the three source segments of each padded
row as ``csrc/halo.cu`` addresses them, bitwise against both plain versions
(``test_torch_halo_kernel.py`` holds it against JAX's)."""

import numpy as np
import pytest
import torch

import chip_smoke
from blockcopy_tpu_torch.core import grid as TG
from blockcopy_tpu_torch.core.grid import neighbor_indices
from blockcopy_tpu_torch.ops.kernels import halo as H
from torch_threads import two_torch_threads  # noqa: F401

SHAPES = sorted({(bs, c) for bs, c in chip_smoke.HALO_SHAPES
                 + chip_smoke.HALO_SHAPES_256}
                | {(bs, c) for bs, c, _ in chip_smoke.DET_HALO_SHAPES})
KS = (1, 2, 7, 8, 38, 64, 128)
# shared memory a CTA may take on sm_90 (227 KB)
SMEM_MAX = 232448


def check_plan(k, bs, c_bytes, p, sms):
    """The plan's invariants, as the C entry checks them, and its shares'
    cover of the launch's rows."""
    plan = H.halo_plan(k, bs, c_bytes, p, sms)
    w = bs + 2 * p
    row = w * c_bytes
    cuts, piece, share, ctas = (plan[key] for key in ("cuts", "piece",
                                                      "share", "ctas"))
    unit = 16 if c_bytes % 16 == 0 else 4 if c_bytes % 4 == 0 else 2
    # every row cut into non-empty pieces of whole units
    assert piece % unit == 0 and cuts * piece >= row > (cuts - 1) * piece
    pieces = k * w * cuts
    assert plan["pieces"] == pieces
    # the CTAs' shares, row-major, tile [0, pieces): each piece, hence each
    # (block, padded row, cut), exactly once, and no CTA without work
    starts = np.arange(ctas) * share
    ends = np.minimum(starts + share, pieces)
    assert (ends > starts).all() and starts[0] == 0 and ends[-1] == pieces
    np.testing.assert_array_equal(starts[1:], ends[:-1])
    # and the cuts of a row tile its bytes
    lo = np.arange(cuts) * piece
    hi = np.minimum(lo + piece, row)
    assert (hi > lo).all() and hi[-1] == row
    # the blocks each share touches fit its neighbour table
    blocks = (ends - 1) // cuts // w - starts // cuts // w + 1
    assert blocks.max() <= plan["span"]
    if unit == 16:
        assert 1 <= plan["depth"] <= min(share, H.GATHER_THREADS)
    else:
        assert plan["depth"] == 0
    assert plan["smem"] == (plan["depth"] * (piece + 8) + 64 * plan["span"])
    assert plan["smem"] <= SMEM_MAX
    return plan


@pytest.mark.parametrize("bs,c", SHAPES)
def test_plan_covers_every_row(bs, c):
    for itemsize in (2, 4):
        for p in (1, 2, 3):
            for k in KS:
                for sms in (132, 1):
                    plan = check_plan(k, bs, c * itemsize, p, sms)
                    if k == 8 and k * (bs + 2 * p) >= sms:
                        assert plan["ctas"] >= sms, (bs, c, p, plan)


@pytest.mark.parametrize("c_bytes", [2, 4, 6, 10, 12, 96])
def test_plan_small_units(c_bytes):
    """Widths that are no multiple of 16 bytes (the kernel's unit loop) and
    a tiny row: whole units, no ring."""
    for k in (1, 2, 8, 128):
        for p in (1, 2, 3):
            for sms in (132, 3, 1):
                check_plan(k, 4, c_bytes, p, sms)


def gather_by_plan(plan, store, center, idx, pad, n, gh, gw):
    """``(K, bs+2p, bs+2p, C)`` assembled as the kernel does it: for each
    CTA's share, each piece's bytes of its padded row taken from the row's
    three source segments [p C | bs C | p C].  ``store`` is a full canvas
    ``(T+1, bs, bs, C)`` or strips ``{"rows", "cols"}``.  Every element is
    written exactly once (asserted)."""
    k, bs, _, c = center.shape
    p, w = pad, bs + 2 * pad
    item = center.element_size()
    assert plan["piece"] % item == 0
    piece, cuts, share = plan["piece"] // item, plan["cuts"], plan["share"]
    strips = isinstance(store, dict)
    nb = neighbor_indices(idx, n, gh, gw).tolist()
    out = torch.zeros((k * w, w * c), dtype=center.dtype)
    written = torch.zeros((k * w, w * c), dtype=torch.int32)

    def segments(kk, py):
        q = nb[kk]
        if p <= py < p + bs:
            y = py - p
            if strips:
                left = store["cols"][q[3], y, p:]
                right = store["cols"][q[4], y, :p]
            else:
                left = store[q[3], y, bs - p:]
                right = store[q[4], y, :p]
            return left, center[kk, y], right
        src = store["rows"] if strips else store
        if py < p:
            y, (a, b, e) = (p if strips else bs - p) + py, q[0:3]
        else:
            y, (a, b, e) = py - p - bs, q[5:8]
        return src[a, y, bs - p:], src[b, y], src[e, y, :p]

    for cta in range(plan["ctas"]):
        j0 = cta * share
        j1 = min(j0 + share, plan["pieces"])
        assert (j1 - 1) // cuts // w - j0 // cuts // w + 1 <= plan["span"]
        for j in range(j0, j1):
            row, cut = divmod(j, cuts)
            kk, py = divmod(row, w)
            line = torch.cat([s.reshape(-1) for s in segments(kk, py)])
            lo, hi = cut * piece, min((cut + 1) * piece, w * c)
            out[row, lo:hi] = line[lo:hi]
            written[row, lo:hi] += 1
    assert (written == 1).all()
    return out.view(k, w, w, c)


def plain_case(seed, dtype, bs, c, pad, n=2, gh=3, gw=4, extra=3):
    """A canvas of two images' 3x4 grids (zero sentinel), its strips, the
    executed blocks' indices with ``extra`` padding slots and a center."""
    rs = np.random.RandomState(seed)
    total = n * gh * gw
    canvas = torch.from_numpy(rs.randn(total + 1, bs, bs, c)
                              .astype(np.float32)).to(dtype)
    canvas[-1] = 0
    strips = {"rows": torch.cat([canvas[:, :pad], canvas[:, -pad:]], 1),
              "cols": torch.cat([canvas[:, :, :pad], canvas[:, :, -pad:]],
                                2)}
    grid = torch.from_numpy(rs.rand(n, gh, gw) < 0.5)
    idx = TG.exec_indices(grid, int(grid.sum()) + extra)
    center = torch.from_numpy(rs.randn(idx.shape[0], bs, bs, c)
                              .astype(np.float32)).to(dtype)
    return canvas, strips, idx, center, (n, gh, gw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [5, 6, 16, 256])
@pytest.mark.parametrize("pad", [1, 2, 3])
def test_plan_order_matches_plain(pad, c, dtype):
    """Both plain versions, and the plain inputs gathered in the plan's
    order at 1, 3 and 132 SMs (shares that split rows and blocks, rows cut
    into pieces at C = 256), bitwise: C = 5 and 6 bf16 take the kernel's
    2- and 4-byte units."""
    canvas, strips, idx, center, geo = plain_case(pad * c, dtype, 8, c, pad)
    ref = H.halo_gather_canvas_plain(canvas, idx, pad, *geo, center)
    assert torch.equal(
        H.halo_gather_strips_plain(strips, idx, pad, *geo, center), ref)
    c_bytes = c * center.element_size()
    for sms in (1, 3, 132):
        plan = check_plan(idx.shape[0], 8, c_bytes, pad, sms)
        for store in (canvas, strips):
            got = gather_by_plan(plan, store, center, idx, pad, *geo)
            assert torch.equal(got, ref), (sms, type(store))
