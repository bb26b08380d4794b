"""Bottleneck-tail kernel module: the plain version held against the Pallas
``bottleneck_tail`` (interpret mode), and the port's fused block against the
JAX unfused path over 3-frame partial-grid clips.  The CUDA kernel is held
against the plain version in ``test_torch_kernels_gpu.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import blockcopy_tpu.models.swiftnet as JS
import blockcopy_tpu_torch.models.swiftnet as TS
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.core.blocked import ExecCtx as JCtx, split_dense as jsplit
from blockcopy_tpu.core.blocked import gather_halo_strips as jgather
from blockcopy_tpu.ops.pallas.bottleneck import bottleneck_tail as jtail
from blockcopy_tpu_torch.core import grid as TG
from blockcopy_tpu_torch.core.blocked import ExecCtx as TCtx
from blockcopy_tpu_torch.core.blocked import StripHalo
from blockcopy_tpu_torch.core.blocked import split_dense as tsplit
from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
from blockcopy_tpu_torch.utils.convert import params_from_jax
from torch_port_util import (assert_close, assert_same, assert_tree, jtree,
                             tol, tt)
from torch_port_util import two_torch_threads  # noqa: F401


def bottleneck_params(cin, planes, seed=0):
    """The JAX suite's bottleneck parameters (test_fused_bottleneck.py)."""
    rs = np.random.RandomState(seed)

    def conv(kh, kw, ci, co):
        return {"w": jnp.asarray(rs.randn(kh, kw, ci, co).astype(np.float32)
                                 * 0.1)}

    def bn(c):
        return {"scale": jnp.asarray(1.0 + 0.1 * rs.randn(c)
                                     .astype(np.float32)),
                "bias": jnp.asarray(0.1 * rs.randn(c).astype(np.float32))}

    return {"conv1": conv(1, 1, cin, planes), "bn1": bn(planes),
            "conv2": conv(3, 3, planes, planes), "bn2": bn(planes),
            "conv3": conv(1, 1, planes, cin), "bn3": bn(cin)}


PIECE_SHAPES = {"top": (1, "bs"), "bottom": (1, "bs"), "left": ("bs", 1),
                "right": ("bs", 1)}


def _tail_inputs(rs, k, bs, cm, co, dtype):
    def arr(*shape, relu=False):
        a = rs.randn(*shape).astype(np.float32)
        return (np.maximum(a, 0) if relu else a).astype(dtype)

    pieces = {}
    for name in BT.PIECES:
        hw = [bs if d == "bs" else d for d in PIECE_SHAPES.get(name, (1, 1))]
        pieces[name] = arr(k, *hw, cm, relu=True)
    return (arr(k, bs, bs, cm, relu=True), arr(k, bs, bs, co), pieces,
            arr(3, 3, cm, cm) * 0.05, 1 + 0.1 * arr(cm), 0.1 * arr(cm),
            arr(cm, co) * 0.05, 1 + 0.1 * arr(co), 0.1 * arr(co))


def _strip_halo(rs, k, bs, c, dtype, n=1, gh=2, gw=3):
    """Post-ReLU strips of an (n, gh, gw) grid (zero sentinels) and the
    indices of ``k - 1`` of its blocks and a padding slot: numpy strips,
    JAX's indices and the port's ``StripHalo`` of the same values."""
    total = n * gh * gw
    strips = {"rows": np.maximum(rs.randn(total + 1, 2, bs, c), 0),
              "cols": np.maximum(rs.randn(total + 1, bs, 2, c), 0)}
    strips = {name: a.astype(np.float32).astype(dtype)
              for name, a in strips.items()}
    for a in strips.values():
        a[-1] = 0
    grid = np.zeros(total, bool)
    grid[rs.permutation(total)[:k - 1]] = True
    jidx = JG.exec_indices(jnp.asarray(grid.reshape(n, gh, gw)), k)
    halo = StripHalo(rows=tt(strips["rows"]), cols=tt(strips["cols"]),
                     idx=tt(jidx).long(), n=n, gh=gh, gw=gw, pad=1)
    return strips, jidx, halo


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("bs,cm,co", [
    pytest.param(8, 128, 256, id="8"), pytest.param(16, 128, 256, id="16"),
    pytest.param(32, 128, 256, id="32"),
    pytest.param(8, 256, 1024, id="8-256-1024")])
def test_plain_matches_pallas(bs, cm, co, dtype):
    """The wrapper's plain version, on a ``StripHalo``, against the Pallas
    kernel (interpret mode) fed JAX's pieces of the same strips, at the bs
    of blocks 64, 128 and 256 (bs 32: a block the bf16 row route runs) and
    at a bottleneck's own widths (Co = 4 Cm)."""
    rs = np.random.RandomState(bs + cm)
    h1, x, _, w2, s2, b2, w3, s3, b3 = _tail_inputs(rs, 4, bs, cm, co, dtype)
    strips, jidx, halo = _strip_halo(rs, 4, bs, cm, dtype)
    pieces = jgather({k: jnp.asarray(v) for k, v in strips.items()}, jidx, 1,
                     1, 2, 3)
    ref = jtail(jnp.asarray(h1), jnp.asarray(x), pieces,
                *map(jnp.asarray, (w2, s2, b2, w3, s3, b3)))
    oihw = lambda w: tt(w).permute(3, 2, 0, 1)
    got = BT.bottleneck_tail(tt(h1), tt(x), halo, oihw(w2), tt(s2), tt(b2),
                             oihw(w3[None, None]), tt(s3), tt(b3))
    assert got.dtype == tt(h1).dtype
    assert_close(ref, got, tol(dtype))


def _plain_prepared(h1, x, pieces, prep):
    """The tail computed from the prepared layouts, read as the kernel reads
    them: w2 [dy][dx][co][ci] tap by tap, w3 (Co, Cm); cast order of
    ``bottleneck.py:82-89``."""
    w2p, s2, b2, w3p, s3, b3 = prep
    dt, (k, bs, _, cm) = h1.dtype, h1.shape
    full = BT._padded(h1, pieces).float()                # (K, bs+2, bs+2, Cm)
    acc = torch.zeros((k, bs, bs, cm))
    for dy in range(3):
        for dx in range(3):
            acc += full[:, dy:dy + bs, dx:dx + bs] @ w2p[dy, dx].float().t()
    h2 = torch.clamp_min(acc.to(dt) * s2 + b2, 0)
    y = (h2.float() @ w3p.float().t()).to(dt) * s3 + b3
    return torch.clamp_min(y + x, 0)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_prepared_weights_round_trip(dtype):
    """``prepare_tail_weights`` lays out w2 as [dy][dx][co][ci] and w3 as
    (Co, Cm): undoing the layouts gives the JAX-side (HWIO) weights back,
    bit for bit, and the BN vectors unchanged."""
    rs = np.random.RandomState(3)
    _, _, _, w2, s2, b2, w3, s3, b3 = _tail_inputs(rs, 1, 8, 128, 256, dtype)
    oihw = lambda w: tt(w).permute(3, 2, 0, 1)
    prep = BT.prepare_tail_weights(oihw(w2), tt(s2), tt(b2),
                                   oihw(w3[None, None]), tt(s3), tt(b3))
    w2p, s2p, b2p, w3p, s3p, b3p = prep
    assert all(t.is_contiguous() and t.dtype == tt(w2).dtype for t in prep)
    assert w2p.shape == (3, 3, 128, 128) and w3p.shape == (256, 128)
    assert_same(w2, w2p.permute(0, 1, 3, 2))             # back to HWIO
    assert_same(w3, w3p.t())
    for ref, got in zip((s2, b2, s3, b3), (s2p, b2p, s3p, b3p)):
        assert_same(ref, got)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("bs", [8, 16])
def test_prepared_reader_matches_plain_and_pallas(bs, dtype):
    """A plain reader of the prepared layouts equals ``bottleneck_tail_plain``
    and, through it, the Pallas ``bottleneck_tail`` in interpret mode."""
    rs = np.random.RandomState(bs + 1)
    h1, x, pieces, w2, s2, b2, w3, s3, b3 = _tail_inputs(rs, 3, bs, 128,
                                                         256, dtype)
    ref = jtail(jnp.asarray(h1), jnp.asarray(x),
                {k: jnp.asarray(v) for k, v in pieces.items()},
                *map(jnp.asarray, (w2, s2, b2, w3, s3, b3)))
    oihw = lambda w: tt(w).permute(3, 2, 0, 1)
    tpieces = {k: tt(v) for k, v in pieces.items()}
    weights = (oihw(w2), tt(s2), tt(b2), oihw(w3[None, None]), tt(s3),
               tt(b3))
    got = _plain_prepared(tt(h1), tt(x), tpieces,
                          BT.prepare_tail_weights(*weights))
    plain = BT.bottleneck_tail_plain(tt(h1), tt(x), tpieces, *weights)
    assert_close(plain, got, tol(dtype))
    assert_close(ref, got, tol(dtype))


def test_prepared_cache_follows_in_place_updates(monkeypatch):
    """``prepared_tail_weights`` prepares a parameter set once; an in-place
    update of any of its tensors, or another dtype, prepares it again."""
    calls = []
    real = BT.prepare_tail_weights
    monkeypatch.setattr(BT, "prepare_tail_weights",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(BT, "_prepared", {})
    rs = np.random.RandomState(5)
    _, _, _, w2, s2, b2, w3, s3, b3 = _tail_inputs(rs, 1, 8, 128, 256,
                                                   np.float32)
    params = [tt(w2).permute(3, 2, 0, 1), tt(s2), tt(b2),
              tt(w3[None, None]).permute(3, 2, 0, 1), tt(s3), tt(b3)]
    first = BT.prepared_tail_weights(*params, torch.float32)
    again = BT.prepared_tail_weights(*params, torch.float32)
    assert len(calls) == 1 and all(a is b for a, b in zip(first, again))
    params[0].mul_(2.0)                       # in place: w2's version moves
    updated = BT.prepared_tail_weights(*params, torch.float32)
    assert len(calls) == 2
    assert torch.equal(updated[0], first[0] * 2.0)
    params[4].add_(1.0)
    BT.prepared_tail_weights(*params, torch.float32)
    BT.prepared_tail_weights(*params, torch.bfloat16)
    assert len(calls) == 4
    BT.prepared_tail_weights(*params, torch.float32)
    BT.prepared_tail_weights(*params, torch.bfloat16)
    assert len(calls) == 4


def _frame(pkg, params, frame, grid, canvases, cap, building, n, gh, gw):
    """One frame of the bottleneck: its output and the canvases."""
    S, G, Ctx, split, to = pkg
    idx = G.exec_indices(to(grid), cap)
    ctx = Ctx.blocked(idx, n, gh, gw, canvases, building=building)
    out = S._bottleneck_block(ctx, "bn", split(to(frame), idx, n, gh, gw),
                              params, stride=1)
    return out.data, ctx.canvases


def _run(pkg, fused, frames, grids, params, n=1, gh=2, gw=4):
    """One bottleneck over a clip: outputs and strip canvases per frame.
    JAX's frame is jitted, traced with the switch set (eager JAX compiles
    every op)."""
    S = pkg[0]
    step = functools.partial(_frame, pkg)
    if S is JS:
        step = jax.jit(step, static_argnames=("cap", "building", "n", "gh",
                                              "gw"))
    old = S.FUSED_BOTTLENECK
    S.FUSED_BOTTLENECK = fused
    try:
        outs, canv = [], []
        canvases = {}
        for t, (frame, grid) in enumerate(zip(frames, grids)):
            out, canvases = step(params, frame, grid, canvases,
                                 cap=int(grid.sum()), building=t == 0, n=n,
                                 gh=gh, gw=gw)
            outs.append(out)
            canv.append({k: np.array(v) if not isinstance(v, torch.Tensor)
                         else v.clone() for k, v in canvases["bn.conv2"]
                         .items()})
        return outs, canv
    finally:
        S.FUSED_BOTTLENECK = old


JAX = (JS, JG, JCtx, jsplit, jnp.asarray)
PORT = (TS, TG, TCtx, tsplit, tt)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_fused_block_matches_jax_unfused(bs, dtype):
    n, gh, gw = 1, 2, 4
    cin, planes = 256, 128
    rs = np.random.RandomState(0)
    frames = [rs.randn(n, gh * bs, gw * bs, cin).astype(dtype)
              for _ in range(3)]
    grids = [np.ones((n, gh, gw), bool), np.zeros((n, gh, gw), bool),
             np.zeros((n, gh, gw), bool)]
    grids[1][0, 0, ::2] = grids[1][0, 1, 1] = True
    grids[2][0, 1, :] = True
    jp = bottleneck_params(cin, planes)
    tp = params_from_jax(jtree(jp), device="cpu")

    ref, ref_canv = _run(JAX, False, frames, grids, jp)
    launches = dict(kernels.launches)
    got, got_canv = _run(PORT, True, frames, grids, tp)
    unfused, unfused_canv = _run(PORT, False, frames, grids, tp)
    assert kernels.launches == launches    # CPU: plain version only
    for t in range(3):
        assert_close(ref[t], got[t], tol(dtype), msg=f"frame {t}")
        # the same strips whichever path runs the tail
        assert_tree(unfused_canv[t], got_canv[t], assert_same)
        assert_tree(ref_canv[t], got_canv[t],
                    lambda a, b, m: assert_close(a, b, tol(dtype), msg=m))


@pytest.mark.parametrize("planes,fused", [(64, False), (128, True)])
def test_gate(planes, fused, monkeypatch):
    """The default gate fuses stride-1 identity bottlenecks of 128-aligned
    width only (planes 64, RN50 layer1, stays unfused), and never in the
    building pass."""
    n, gh, gw, bs = 1, 2, 2, 8
    rs = np.random.RandomState(1)
    frame = torch.from_numpy(rs.randn(n, gh * bs, gw * bs, 4 * planes)
                             .astype(np.float32))
    p = params_from_jax(jtree(bottleneck_params(4 * planes, planes)),
                        device="cpu")
    calls = []
    monkeypatch.setattr(TS, "bottleneck_tail",
                        lambda h1, x, *a: calls.append(1) or x)
    monkeypatch.setattr(TS, "FUSED_BOTTLENECK", None)   # port default: on
    idx = TG.exec_indices(torch.ones((n, gh, gw), dtype=torch.bool), gh * gw)
    pack = tsplit(frame, idx, n, gh, gw)
    ctx = TCtx.blocked(idx, n, gh, gw, {}, building=True)
    TS._bottleneck_block(ctx, "bn", pack, p, stride=1)
    assert not calls
    ctx.building = False
    out = TS._bottleneck_block(ctx, "bn", pack, p, stride=1)
    assert out.data.shape == (gh * gw, bs, bs, 4 * planes)
    assert calls == ([1] if fused else [])


# RN50's stride-1 identity bottlenecks at block sizes 64, 128 and 256: layer2
# (stride 8, Cm 128), layer3 (stride 16, Cm 256), layer4 (stride 32, Cm 512)
# give bs = block / stride; whether the fused tail runs there, fp32 / bf16:
# wherever bs >= 8, as JAX's gate (the bf16 row route takes block 256's)
GATE_CASES = [
    (64, 8, 128, True, True), (64, 16, 256, False, False),
    (64, 32, 512, False, False),
    (128, 8, 128, True, True), (128, 16, 256, True, True),
    (128, 32, 512, False, False),
    (256, 8, 128, True, True), (256, 16, 256, True, True),
    (256, 32, 512, True, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,stride,planes,f32,bf16", GATE_CASES)
def test_gate_asks_the_kernel(block, stride, planes, f32, bf16, dtype,
                              monkeypatch):
    """The gate fuses only the blocks the dtype's kernel takes
    (``kernel_takes``) and runs the rest unfused: both kernels take every
    128-aligned RN50 block at bs >= 8, block 256's included.  The unfused
    fall-through gives the block's full output."""
    n, gh, gw, bs = 1, 1, 2, block // stride
    fused = f32 if dtype == torch.float32 else bf16
    # below bs 8 the gate refuses first; both kernels take any bs
    takes = fused or bs < 8
    assert BT.kernel_takes(dtype, bs, planes, 4 * planes) == takes
    rs = np.random.RandomState(block + planes)
    frame = torch.from_numpy(rs.randn(n, gh * bs, gw * bs, 4 * planes)
                             .astype(np.float32)).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    p = params_from_jax(jtree(jax.tree.map(
        lambda a: a.astype(jdt), bottleneck_params(4 * planes, planes))),
        device="cpu")
    calls = []
    monkeypatch.setattr(TS, "bottleneck_tail",
                        lambda h1, x, *a: calls.append(1) or x)
    monkeypatch.setattr(TS, "FUSED_BOTTLENECK", None)   # port default: on
    idx = TG.exec_indices(torch.ones((n, gh, gw), dtype=torch.bool), gh * gw)
    pack = tsplit(frame, idx, n, gh, gw)
    ctx = TCtx.blocked(idx, n, gh, gw, {}, building=True)
    TS._bottleneck_block(ctx, "bn", pack, p, stride=1)   # makes the canvases
    ctx.building = False
    out = TS._bottleneck_block(ctx, "bn", pack, p, stride=1)
    assert out.data.shape == (gh * gw, bs, bs, 4 * planes)
    assert out.data.dtype == dtype
    assert calls == ([1] if fused else [])


@pytest.mark.parametrize("dtype,bs,cm,co,takes", [
    (torch.float32, 1, 64, 64, True), (torch.float32, 3, 192, 320, True),
    (torch.float32, 8, 96, 512, False), (torch.float32, 8, 128, 480, False),
    (torch.bfloat16, 16, 128, 768, True), (torch.bfloat16, 16, 128, 640, True),
    (torch.bfloat16, 32, 128, 512, True), (torch.float16, 8, 128, 512, False),
])
def test_kernel_takes_widths(dtype, bs, cm, co, takes):
    """Both kernels take Cm and Co multiples of the 64-column tile at any
    bs (the C entry's own rule): bf16 on the wgmma route for its (bs, Cm)
    table at Co a multiple of 256, else on the row route; no other dtype
    has a kernel."""
    assert BT.kernel_takes(dtype, bs, cm, co) == takes


@pytest.mark.parametrize("block,dtype,per_frame", [
    (256, torch.bfloat16, 10), (256, torch.float32, 10),
    (128, torch.bfloat16, 8), (128, torch.float32, 8)])
def test_rn50_fused_tails_per_frame(block, dtype, per_frame, monkeypatch):
    """The tails RN50 hands the fused kernel per executed ladder frame
    (256x512, 3 frames), routed on the CPU as on the card: at block 256
    both dtypes fuse layers 2-4 (3 + 5 + 2), as JAX's gate does; at block
    128 both fuse layers 2-3 (3 + 5)."""
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.core.engine import BlockCopyModel
    from blockcopy_tpu_torch.tools.measure import synthetic_frames
    calls = []
    real = TS.bottleneck_tail
    monkeypatch.setattr(TS, "bottleneck_tail",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(TS, "FUSED_BOTTLENECK", None)   # port default: on
    cfg = TS.SwiftNetConfig(backbone="resnet50", num_classes=19)
    params = TS.init_swiftnet(cfg, seed=0, dtype=dtype, device="cpu")
    blocks = (256 // block) * (512 // block)
    model = BlockCopyModel(TS.make_apply_fn(cfg), params, default_settings(
        block_size=block, block_quantize_number_exec=1 / blocks),
        device="cpu")
    frames = synthetic_frames((1, 256, 512, 3), 3, dtype, device="cpu")
    per = []
    for t, frame in enumerate(frames):
        u = torch.full((1, 256 // block, 512 // block), 2.0)
        u.view(-1)[t % blocks] = -1.0                   # one block after 1
        before = len(calls)
        out = model(frame, None if t == 0 else (u, torch.rand((blocks,))))
        per.append(len(calls) - before)
        assert bool(torch.isfinite(out.float()).all())
    assert [model.policy_meta["num_exec"]] == [1]
    assert per == [per_frame] * 3


def _tf32(t):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, op, products):
    """``op(a, b)`` on TF32 operands, as the fp32 kernel's ``mma.sync``
    sums them: 3 products (3xTF32: each operand split as hi = rna(v), lo =
    rna(v - hi); lo hi + hi lo, then hi hi) or 1 (hi hi alone)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if products == 1:
        return op(a_hi, b_hi)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return op(a_lo, b_hi) + op(a_hi, b_lo) + op(a_hi, b_hi)


def _tail_tf32(h1, x, pieces, w2, s2, b2, w3, s3, b3, products):
    """The fp32 kernel's arithmetic in torch: the 3x3 conv over the padded
    tile and the 1x1 over h2 from TF32 operands, each epilogue rounding as
    ``bottleneck_tail_plain``."""
    full = BT._padded(h1, pieces).permute(0, 3, 1, 2)
    acc = _tf32_product(full, w2, F.conv2d, products).permute(0, 2, 3, 1)
    h2 = torch.clamp_min(acc * s2 + b2, 0)
    y = _tf32_product(h2, w3[:, :, 0, 0].t(), torch.matmul, products)
    return torch.clamp_min(y * s3 + b3 + x, 0)


def test_tf32_rounding_ties_away():
    """``_tf32`` keeps 10 mantissa bits and rounds a tie away from zero."""
    v = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -12, 3.0, 0.0])
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10,
                         3.0, 0.0])
    assert torch.equal(_tf32(v), want)


@pytest.mark.parametrize("bs", [8, 16])
def test_3xtf32_scheme_holds_fp32_tolerance(bs):
    """The fp32 kernel's numerical scheme, emulated: 3xTF32 holds 1e-4
    against ``bottleneck_tail_plain`` and the Pallas ``bottleneck_tail``
    (interpret mode); one TF32 product does not."""
    rs = np.random.RandomState(bs + 2)
    h1, x, pieces, w2, s2, b2, w3, s3, b3 = _tail_inputs(rs, 3, bs, 128,
                                                         256, np.float32)
    ref = jtail(jnp.asarray(h1), jnp.asarray(x),
                {k: jnp.asarray(v) for k, v in pieces.items()},
                *map(jnp.asarray, (w2, s2, b2, w3, s3, b3)))
    oihw = lambda w: tt(w).permute(3, 2, 0, 1)
    args = (tt(h1), tt(x), {k: tt(v) for k, v in pieces.items()},
            oihw(w2), tt(s2), tt(b2), oihw(w3[None, None]), tt(s3), tt(b3))
    plain = BT.bottleneck_tail_plain(*args)
    got = _tail_tf32(*args, products=3)
    assert_close(plain, got, 1e-4)
    assert_close(ref, got, 1e-4)
    with pytest.raises(AssertionError):
        assert_close(plain, _tail_tf32(*args, products=1), 1e-4)
