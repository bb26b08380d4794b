"""The CUDA kernels against their plain versions, on a GPU.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Without a GPU every case skips (decided when the test runs).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from blockcopy_tpu_torch.core import grid as TG
from blockcopy_tpu_torch.core.blocked import StripHalo
from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
from blockcopy_tpu_torch.ops.kernels import halo as H
from blockcopy_tpu_torch.ops.kernels import mm as MM

pytestmark = pytest.mark.cuda
DET_CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "csp"
                 / "csp_r50_clip_blockcopy_030.py")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [16, 6, 48])
@pytest.mark.parametrize("pad", [1, 3])
def test_halo_kernel_matches_plain(cuda_device, pad, c, dtype):
    """Both entry points, bitwise, on a partial grid with padding slots;
    C=6 bf16 takes the 4-byte path, C=6 fp32 and C=48 the 16-byte one."""
    n, gh, gw, bs = 2, 3, 4, 8
    total = n * gh * gw
    gen = torch.Generator().manual_seed(pad * c)
    canvas = torch.randn((total + 1, bs, bs, c), generator=gen).to(dtype)
    canvas[-1] = 0
    grid = torch.rand((n, gh, gw), generator=gen) < 0.5
    idx = TG.exec_indices(grid, int(grid.sum()) + 2)
    center = torch.randn((idx.shape[0], bs, bs, c), generator=gen).to(dtype)
    strips = {"rows": torch.cat([canvas[:, :pad], canvas[:, -pad:]], 1),
              "cols": torch.cat([canvas[:, :, :pad], canvas[:, :, -pad:]], 2)}
    ref = H.halo_gather_canvas_plain(canvas, idx, pad, n, gh, gw, center)
    dev = {"device": cuda_device}
    before = dict(kernels.launches)
    got_c = H.halo_gather_canvas(canvas.to(**dev), idx.to(**dev), pad, n,
                                 gh, gw, center.to(**dev))
    got_s = H.halo_gather_strips({k: v.contiguous().to(**dev)
                                  for k, v in strips.items()},
                                 idx.to(**dev), pad, n, gh, gw,
                                 center.to(**dev))
    assert torch.equal(got_c.cpu(), ref) and torch.equal(got_s.cpu(), ref)
    assert kernels.launches["halo_canvas"] == before["halo_canvas"] + 1
    assert kernels.launches["halo_strips"] == before["halo_strips"] + 1


def _halo_full_grid(device, bs, c, pad, dtype, n_set, k, seed):
    """Both entry points on a 1024x2048 grid at block 128 (8x16 blocks):
    ``n_set`` of them executed, ``k - n_set`` padding slots; bitwise against
    the plain version."""
    n, gh, gw = 1, 8, 16
    total = n * gh * gw
    gen = torch.Generator().manual_seed(seed)
    canvas = torch.randn((total + 1, bs, bs, c), generator=gen).to(dtype)
    canvas[-1] = 0
    grid = torch.zeros(total, dtype=torch.bool)
    grid[torch.randperm(total, generator=gen)[:n_set]] = True
    idx = TG.exec_indices(grid.view(n, gh, gw), k)
    center = torch.randn((k, bs, bs, c), generator=gen).to(dtype)
    strips = {"rows": torch.cat([canvas[:, :pad], canvas[:, -pad:]], 1),
              "cols": torch.cat([canvas[:, :, :pad], canvas[:, :, -pad:]], 2)}
    ref = H.halo_gather_canvas_plain(canvas, idx, pad, n, gh, gw, center)
    dev = {"device": device}
    got_c = H.halo_gather_canvas(canvas.to(**dev), idx.to(**dev), pad, n,
                                 gh, gw, center.to(**dev))
    got_s = H.halo_gather_strips({k: v.contiguous().to(**dev)
                                  for k, v in strips.items()},
                                 idx.to(**dev), pad, n, gh, gw,
                                 center.to(**dev))
    assert torch.equal(got_c.cpu(), ref) and torch.equal(got_s.cpu(), ref)
    got_p = H.halo_pieces({k: v.contiguous().to(**dev)
                           for k, v in strips.items()}, idx.to(**dev), pad, n,
                          gh, gw)
    ref_p = H.gather_halo_strips_plain(strips, idx, pad, n, gh, gw)
    assert all(torch.equal(got_p[name].cpu(), ref_p[name]) for name in ref_p)


# every (bs, C) of the halo sites of the semseg paths at block 128 and 256
# and of the detection path
PIECE_SHAPES = sorted({(32, 48), (32, 64), (32, 128), (16, 256), (8, 512),
                       (4, 512), (8, 128), (16, 128), (64, 48), (64, 64),
                       (64, 128), (32, 256), (16, 512), (32, 768)})


def _pieces_matches_plain(device, bs, c, pad, dtype, seed, share=0.5):
    """The ``halo_pieces`` entry bitwise against its plain version on two
    images' 3x4 grids, ``share`` of the blocks executed and 3 padding slots
    after them (border neighbours read the zero sentinel): one launch a
    call, every piece a contiguous 16-byte-aligned view of one buffer."""
    n, gh, gw = 2, 3, 4
    total = n * gh * gw
    gen = torch.Generator().manual_seed(seed)
    rows = torch.randn((total + 1, 2 * pad, bs, c), generator=gen)
    cols = torch.randn((total + 1, bs, 2 * pad, c), generator=gen)
    rows[-1] = 0
    cols[-1] = 0
    strips = {"rows": rows.to(dtype), "cols": cols.to(dtype)}
    grid = torch.rand((n, gh, gw), generator=gen) < share
    idx = TG.exec_indices(grid, int(grid.sum()) + 3)
    ref = H.gather_halo_strips_plain(strips, idx, pad, n, gh, gw)
    before = dict(kernels.launches)
    got = H.halo_pieces({k: v.to(device) for k, v in strips.items()},
                        idx.to(device), pad, n, gh, gw)
    assert kernels.launches == {
        **before, "halo_pieces": before["halo_pieces"] + 1}
    for name in H.PIECES:
        t = got[name]
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert t.dtype == dtype
        assert torch.equal(t.cpu(), ref[name]), (pad, dtype, name)


@pytest.mark.parametrize("bs,c", PIECE_SHAPES)
def test_halo_pieces_matches_plain(cuda_device, bs, c):
    """The ``halo_pieces`` entry bitwise against its plain version at pad 1
    and 3, in fp32 and bf16, on partial grids with 3 padding slots."""
    for pad in (1, 3):
        for dtype in (torch.float32, torch.bfloat16):
            _pieces_matches_plain(cuda_device, bs, c, pad, dtype,
                                  seed=bs + c + pad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,c,pad", [(1, 3, 1), (2, 6, 1), (4, 6, 3),
                                      (4, 16, 1), (8, 3, 2), (8, 64, 3)])
def test_halo_pieces_equal_shares(cuda_device, bs, c, pad, dtype):
    """The entry's equal shares of 1024 units at small pieces: 2-, 4- and
    16-byte units (C of 3, 6, 16 and 64), so that a share spans from part
    of one block up to tens of blocks and their pieces; every block of the
    two grids executed, then 3 padding slots; bitwise."""
    _pieces_matches_plain(cuda_device, bs, c, pad, dtype, seed=bs * c + pad,
                          share=1.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,c", [(32, 48), (16, 256), (8, 512), (4, 512)])
def test_halo_kernel_ladder_capacity_8(cuda_device, bs, c, dtype):
    """Ladder mode's smallest capacity at 1024x2048: 8 of 128 blocks, one
    of them a padding slot, at main-path (bs, C), both entry points."""
    _halo_full_grid(cuda_device, bs, c, 1, dtype, 7, 8, seed=bs + c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,c,pad", [(8, 512, 2), (32, 256, 1),
                                      (32, 768, 1)])
def test_halo_kernel_detection_shapes(cuda_device, bs, c, pad, dtype):
    """The detection path's three shapes the semseg path never makes: CSP
    layer4's dilated 3x3s (pad 2), the head's three blocked final convs
    (256 channels) and its 768-channel branch conv, at 38 of 128 blocks
    with 3 padding slots, both entry points."""
    _halo_full_grid(cuda_device, bs, c, pad, dtype, 35, 38, seed=bs + c + pad)


# the detection path's K1 sites (bs, C, pad): the stem's s2d planes,
# layer1's 3x3s, the strided first blocks of layer2 and layer3, layer4's
# dilated 3x3s, the head's fused branch conv and its three final convs
DET_HALO_SHAPES = [(32, 48, 1), (32, 64, 1), (32, 128, 1), (16, 256, 1),
                   (8, 512, 2), (32, 768, 1), (32, 256, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,c,pad", DET_HALO_SHAPES)
@pytest.mark.parametrize("k", [8, 128])
def test_halo_kernel_detection_ladder_capacities(cuda_device, k, bs, c, pad,
                                                 dtype):
    """Every detection shape at the detection ladder's extremes at
    1024x2048: K = 8 (7 blocks and a padding slot) and K = 128 (frame 1,
    every block), both entry points.  K2's detection shapes are RN50's
    layer2 and layer3 ones (``test_bottleneck_kernel_ladder_capacities``)."""
    _halo_full_grid(cuda_device, bs, c, pad, dtype, k - 1 if k < 128 else k,
                    k, seed=k + bs + c + pad)


def test_halo_kernel_refuses_bad_inputs(cuda_device):
    canvas = torch.zeros((9, 4, 4, 8), device=cuda_device)
    idx = torch.arange(2, device=cuda_device)
    center = torch.zeros((2, 4, 4, 8), device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        H.halo_gather_canvas(canvas, idx.int(), 1, 1, 2, 4, center)
    with pytest.raises(ValueError, match="contiguous"):
        H.halo_gather_canvas(canvas, idx, 1, 1, 2, 4,
                             center.transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        H.halo_gather_canvas(canvas[:-1], idx, 1, 1, 2, 4, center)


def _halo(seed, k, bs, cm, device="cpu", n_set=None):
    """K2's halo in strip form (``measure.strip_halo``): post-ReLU strips
    of the 1024x2048 block-128 grid (8x16 blocks, most of a small K's on
    the image's edge) and ``k`` indices, by default every slot an executed
    block at K = 1 and 128 (the full grid) and one padding slot else."""
    from blockcopy_tpu_torch.tools.measure import strip_halo
    if n_set is None:
        n_set = k if k in (1, 128) else k - 1
    gen = torch.Generator(device).manual_seed(seed)
    return strip_halo(gen, k, bs, cm, torch.float32, n_set, relu=True)


def _tail_inputs(rs, k, bs, cm, co):
    def arr(*shape, relu=False, scale=1.0):
        a = rs.randn(*shape).astype(np.float32) * scale
        return torch.from_numpy(np.maximum(a, 0) if relu else a)

    return [arr(k, bs, bs, cm, relu=True), arr(k, bs, bs, co),
            _halo(int(rs.randint(1 << 30)), k, bs, cm),
            arr(cm, cm, 3, 3, scale=0.05), 1 + arr(cm, scale=0.1),
            arr(cm, scale=0.1), arr(co, cm, 1, 1, scale=0.05),
            1 + arr(co, scale=0.1), arr(co, scale=0.1)]


def _to(a, device, dtype):
    """A tensor, or a ``StripHalo``'s strips, in ``dtype`` on ``device``
    (its indices stay int64)."""
    if isinstance(a, StripHalo):
        return dataclasses.replace(a, rows=a.rows.to(device, dtype),
                                   cols=a.cols.to(device, dtype),
                                   idx=a.idx.to(device))
    return a.to(device, dtype)


def _gpu(args, device, dtype):
    return [_to(a, device, dtype) for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,cm,co", [(8, 256, 1024), (16, 128, 512)])
def test_bottleneck_kernel_matches_plain(cuda_device, bs, cm, co, dtype):
    """The RN50 layer3 and layer2 shapes: 1e-4 in fp32 (TF32 off), 3e-2 in
    bf16 (the kernel and the plain version round at the same points but
    sum in another order)."""
    gpu = _gpu(_tail_inputs(np.random.RandomState(bs), 6, bs, cm, co),
               cuda_device, dtype)
    ref = BT.bottleneck_tail_strips_plain(*gpu)
    key = ("bottleneck_tail" if dtype == torch.bfloat16
           else "bottleneck_tail_f32")
    before = dict(kernels.launches)
    got = BT.bottleneck_tail(*gpu)
    assert kernels.launches == {**before, key: before[key] + 1}
    assert got.dtype == dtype and got.shape == (6, bs, bs, co)
    t = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), ref.float(), rtol=t, atol=t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,cm,co", [(8, 256, 1024), (16, 128, 512)])
@pytest.mark.parametrize("k", [8, 128])
def test_bottleneck_kernel_ladder_capacities(cuda_device, k, bs, cm, co,
                                             dtype):
    """Ladder mode's smallest and largest capacities at 1024x2048: K = 8
    (16 CTAs in bf16) and K = 128 (256 CTAs, two waves on 132 SMs), at 3e-2
    in bf16 and 1e-4 in fp32.  The shapes are the semseg and the detection
    ladders' both (RN50 and CSP-R50 layer2 and layer3)."""
    gpu = _gpu(_tail_inputs(np.random.RandomState(k + cm), k, bs, cm, co),
               cuda_device, dtype)
    got = BT.bottleneck_tail(*gpu)
    t = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(),
                               BT.bottleneck_tail_strips_plain(*gpu).float(),
                               rtol=t, atol=t)


@pytest.mark.parametrize("k", [1, 5, 64, 65])
@pytest.mark.parametrize("bs,cm,co", [(8, 256, 1024), (16, 128, 512),
                                      (8, 128, 256)])
def test_bottleneck_bf16_block_counts(cuda_device, bs, cm, co, k):
    """bf16 at 1 to 65 blocks (2 to 130 CTAs in clusters of 2), within
    3e-2 of the plain version."""
    gpu = _gpu(_tail_inputs(np.random.RandomState(k + bs), k, bs, cm, co),
               cuda_device, torch.bfloat16)
    got = BT.bottleneck_tail(*gpu)
    torch.testing.assert_close(got.float(),
                               BT.bottleneck_tail_strips_plain(*gpu).float(),
                               rtol=3e-2, atol=3e-2)


def test_bottleneck_weight_update_in_place(cuda_device):
    """The prepared weights follow an in-place update of w2 between two
    calls (the cache keys on the tensor's version)."""
    gpu = _gpu(_tail_inputs(np.random.RandomState(7), 4, 16, 128, 512),
               cuda_device, torch.bfloat16)
    first = BT.bottleneck_tail(*gpu)
    gpu[3].mul_(-1.5)
    second = BT.bottleneck_tail(*gpu)
    ref = BT.bottleneck_tail_strips_plain(*gpu).float()
    torch.testing.assert_close(second.float(), ref, rtol=3e-2, atol=3e-2)
    assert not torch.allclose(first.float(), ref, rtol=3e-2, atol=3e-2)


# one block shape of each route (the wgmma route's two, the row route's at
# RN50's block 256, fp32) with its key in ``kernels.launches``
ROUTE_CASES = [(torch.bfloat16, 16, 128, 512, "bottleneck_tail"),
               (torch.bfloat16, 8, 256, 1024, "bottleneck_tail"),
               (torch.bfloat16, 32, 128, 512, "bottleneck_tail_rows"),
               (torch.bfloat16, 16, 256, 1024, "bottleneck_tail_rows"),
               (torch.float32, 16, 128, 512, "bottleneck_tail_f32"),
               (torch.float32, 8, 256, 1024, "bottleneck_tail_f32")]


@pytest.mark.parametrize("k,n_set", [(128, 128), (64, 61)],
                         ids=["full", "partial"])
@pytest.mark.parametrize("dtype,bs,cm,co,key", ROUTE_CASES)
def test_bottleneck_strips_every_route(cuda_device, dtype, bs, cm, co, key,
                                       k, n_set):
    """K2 reading its halo in place from the strips, on every route,
    against its plain version (the plain gather's pieces, then the plain
    tail; 3e-2 bf16, 1e-4 fp32): on the 1024x2048 grid at block 128, full
    (all 128 blocks, interior ones with 8 live neighbours) and partial (61
    blocks and 3 padding slots, those on the image's edge reading the zero
    sentinel).  One launch, on the route's key; no ``halo_pieces``."""
    args = _tail_inputs_cuda(k + bs + cm, k, bs, cm, co, n_set)
    args = _bf16(args) if dtype == torch.bfloat16 else args
    before = dict(kernels.launches)
    got = BT.bottleneck_tail(*args)
    assert kernels.launches == {**before, key: before[key] + 1}
    t = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(
        got.float(), BT.bottleneck_tail_strips_plain(*args).float(), rtol=t,
        atol=t)


def test_bottleneck_refuses_bad_halo(cuda_device):
    """The wrapper checks the strips as it checks the other inputs: pad,
    shape, index dtype; nothing launches."""
    args = _gpu(_tail_inputs(np.random.RandomState(1), 4, 16, 128, 512),
                cuda_device, torch.bfloat16)
    halo = args[2]
    bad = [(dataclasses.replace(halo, pad=2), "pad"),
           (dataclasses.replace(halo, cols=halo.rows), "cols"),
           (dataclasses.replace(halo, gw=halo.gw - 1), "rows"),
           (dataclasses.replace(halo, idx=halo.idx.int()), "idx")]
    before = dict(kernels.launches)
    for h, match in bad:
        with pytest.raises(ValueError, match=match):
            BT.bottleneck_tail(*args[:2], h, *args[3:])
    assert kernels.launches == before


def test_bottleneck_kernel_refuses_unsupported_width(cuda_device):
    # Cm, then Co, not a multiple of the 64-column tile, in both dtypes;
    # nothing launches
    before = dict(kernels.launches)
    for cm, co in ((96, 256), (128, 480)):
        args = _tail_inputs(np.random.RandomState(0), 2, 8, cm, co)
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="Cm"):
                BT.bottleneck_tail(*_gpu(args, cuda_device, dtype))
    assert kernels.launches == before


def _tail_inputs_cuda(seed, k, bs, cm, co, n_set=None):
    """``_tail_inputs``' tensors with weights scaled by their fan-in, drawn
    on the card (the block-256 shapes at K = 128 are hundreds of MB)."""
    gen = torch.Generator("cuda").manual_seed(seed)

    def arr(*shape, relu=False, scale=1.0):
        a = torch.randn(shape, generator=gen, device="cuda") * scale
        return a.clamp_min(0) if relu else a

    return [arr(k, bs, bs, cm, relu=True), arr(k, bs, bs, co),
            _halo(seed + 1, k, bs, cm, "cuda", n_set),
            arr(cm, cm, 3, 3, scale=(9 * cm) ** -0.5), 1 + arr(cm, scale=0.1),
            arr(cm, scale=0.1), arr(co, cm, 1, 1, scale=cm ** -0.5),
            1 + arr(co, scale=0.1), arr(co, scale=0.1)]


# RN50's fused blocks at block 128 (layer2, layer3) and at block 256
# (layer2, layer3, layer4)
F32_SHAPES = [(16, 128, 512), (8, 256, 1024), (32, 128, 512),
              (16, 256, 1024), (8, 512, 2048)]


@pytest.mark.parametrize("bs,cm,co", F32_SHAPES)
@pytest.mark.parametrize("k", [1, 5, 8, 64, 65, 128])
def test_bottleneck_f32_matches_plain(cuda_device, k, bs, cm, co):
    """The 3xTF32 kernel within 1e-4 of the plain version (TF32 off) from
    1 to 128 blocks: one launch of the wrapper, two kernels."""
    args = _tail_inputs_cuda(k * 7 + bs + cm, k, bs, cm, co)
    before = dict(kernels.launches)
    got = BT.bottleneck_tail(*args)
    assert kernels.launches == {
        **before, "bottleneck_tail_f32": before["bottleneck_tail_f32"] + 1}
    assert got.dtype == torch.float32 and got.shape == (k, bs, bs, co)
    torch.testing.assert_close(got, BT.bottleneck_tail_strips_plain(*args),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,bs,cm,co", [(1, 12, 128, 256), (3, 12, 64, 128),
                                        (5, 4, 512, 2048), (2, 3, 256, 192),
                                        (3, 5, 192, 320)])
def test_bottleneck_f32_ragged_rows(cuda_device, k, bs, cm, co):
    """K bs^2 not a multiple of the row tile (144, 432, 80, 18 and 75
    rows): the last tile's rows past the end are masked.  Any Cm and Co
    that are multiples of 64 are taken (192 and 320 included)."""
    args = _tail_inputs_cuda(k + bs, k, bs, cm, co)
    torch.testing.assert_close(BT.bottleneck_tail(*args),
                               BT.bottleneck_tail_strips_plain(*args),
                               rtol=1e-4, atol=1e-4)


# the bf16 row route's blocks: RN50's fused blocks at block 256 (layer2,
# layer3, layer4), wide_resnet50_2's at block 128 (layer1, layer2, layer3)
ROW_SHAPES = [(32, 128, 512), (16, 256, 1024), (8, 512, 2048),
              (32, 128, 256), (16, 256, 512), (8, 512, 1024)]
K2_KEYS = ("bottleneck_tail", "bottleneck_tail_rows", "bottleneck_tail_f32")


def _bf16(args):
    return [_to(a, a.rows.device if isinstance(a, StripHalo) else a.device,
                torch.bfloat16) for a in args]


@pytest.mark.parametrize("bs,cm,co", ROW_SHAPES)
@pytest.mark.parametrize("k", [1, 2, 3, 5, 16, 17, 32, 65])
def test_bottleneck_rows_matches_plain(cuda_device, k, bs, cm, co):
    """The bf16 row route within 3e-2 of the plain version from 1 to 65
    blocks: plans with clusters of 1 to 4 CTAs and one or two m64 tiles a
    band, and ragged K (1, 3, 17) whose plans differ from their
    neighbours'; one launch of the wrapper, counted under
    ``bottleneck_tail_rows`` alone, outputs finite."""
    args = _bf16(_tail_inputs_cuda(k * 11 + bs + cm, k, bs, cm, co))
    ref = BT.bottleneck_tail_strips_plain(*args).float()
    before = dict(kernels.launches)
    got = BT.bottleneck_tail(*args)
    assert kernels.launches == {
        **before, "bottleneck_tail_rows": before["bottleneck_tail_rows"] + 1}
    assert got.dtype == torch.bfloat16 and got.shape == (k, bs, bs, co)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), ref, rtol=3e-2, atol=3e-2)


def _tail_plain_f64(h1, x, halo, w2, s2, b2, w3, s3, b3):
    """``bottleneck_tail_strips_plain`` with both products summed in float64
    (one rounding of each sum to bf16, then the same bf16 steps)."""
    dt = h1.dtype
    pieces = H.gather_halo_strips_plain(halo.strips, halo.idx, halo.pad,
                                        halo.n, halo.gh, halo.gw)
    full = BT._padded(h1, pieces).permute(0, 3, 1, 2).double()
    acc = torch.nn.functional.conv2d(full, w2.to(dt).double())
    h2 = torch.clamp_min(acc.permute(0, 2, 3, 1).to(dt) * s2.to(dt)
                         + b2.to(dt), 0)
    y = torch.matmul(h2.double(), w3.to(dt)[:, :, 0, 0].t().double())
    return torch.clamp_min(y.to(dt) * s3.to(dt) + b3.to(dt) + x.to(dt), 0)


@pytest.mark.parametrize("k,bs,cm,co", [(16, 32, 128, 512),
                                        (16, 16, 256, 1024),
                                        (16, 8, 512, 2048),
                                        (32, 8, 256, 1024)])
def test_bottleneck_rows_rounds_as_pallas(cuda_device, k, bs, cm, co):
    """The row route rounds where the Pallas kernel does (acc -> bf16, x s,
    + b, + x, each to bf16): at least 99% of its outputs equal, bit for
    bit, the result of exact sums taken through those roundings.  Only the
    fp32 sums' order and the tensor cores' rounding differ; an epilogue that
    fused a multiply and an add into one rounding fails it by far."""
    args = _bf16(_tail_inputs_cuda(k * 3 + cm, k, bs, cm, co))
    got = (BT._bottleneck_tail_rows(*args) if (bs, cm) in BT.BF16_BLOCKS
           else BT.bottleneck_tail(*args))
    same = (got == _tail_plain_f64(*args)).float().mean().item()
    assert same >= 0.99, same


@pytest.mark.parametrize("k,bs,cm,co", [(16, 16, 128, 640), (3, 12, 64, 192),
                                        (5, 8, 128, 320), (2, 3, 256, 64),
                                        (4, 16, 256, 1024)])
def test_bottleneck_rows_other_widths(cuda_device, k, bs, cm, co):
    """Blocks only the row route takes: Co not a multiple of 256 (640, 192,
    320, 64), Cm 64, bs 12 and 3 (rows that end in a part of a tile), and
    (16, 256), a wgmma-sized Cm at a bs the wgmma route does not hold."""
    args = _bf16(_tail_inputs_cuda(k + bs + co, k, bs, cm, co))
    assert BT.route(torch.bfloat16, bs, cm, co) == "bottleneck_tail_rows"
    torch.testing.assert_close(BT.bottleneck_tail(*args).float(),
                               BT.bottleneck_tail_strips_plain(*args).float(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("bs,cm,co", [(16, 128, 512), (8, 256, 1024),
                                      (8, 128, 512)])
@pytest.mark.parametrize("k", [8, 64])
def test_bottleneck_rows_at_wgmma_blocks(cuda_device, k, bs, cm, co):
    """The row route forced at the wgmma route's blocks (the private entry
    ``chip_smoke.py`` times it through) agrees with the plain version and
    the wgmma route, each counted under its own key."""
    args = _bf16(_tail_inputs_cuda(k + cm, k, bs, cm, co))
    before = dict(kernels.launches)
    rows = BT._bottleneck_tail_rows(*args).float()
    wgmma = BT.bottleneck_tail(*args).float()
    assert kernels.launches == {
        **before, "bottleneck_tail": before["bottleneck_tail"] + 1,
        "bottleneck_tail_rows": before["bottleneck_tail_rows"] + 1}
    ref = BT.bottleneck_tail_strips_plain(*args).float()
    for got in (rows, wgmma):
        torch.testing.assert_close(got, ref, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("k", [1, 2, 3, 16, 17, 32, 64, 128])
def test_bottleneck_rows_plan_matches_mirror(cuda_device, k):
    """The library's launch plan (``bottleneck_rows_plan``) equals the
    Python mirror ``row_plan`` on this card's SM count, at every row-route
    shape the tests and ``chip_smoke.py`` run, and on 132 SMs."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = ROW_SHAPES + [(16, 128, 640), (12, 64, 192), (8, 128, 320),
                           (3, 256, 64), (16, 256, 1024), (16, 128, 512),
                           (8, 256, 1024), (8, 128, 512), (64, 128, 256),
                           (8, 1024, 2048), (4, 2048, 64)]
    for bs, cm, co in shapes:
        for n in (sms, 132):
            assert BT.row_plan_c(k, bs, cm, co, n) == \
                BT.row_plan(k, bs, cm, co, n), (k, bs, cm, co, n)


def test_bottleneck_rows_weight_update_in_place(cuda_device):
    """On the row route too the prepared weights follow an in-place update
    of w3 between two calls."""
    gpu = _bf16(_tail_inputs_cuda(9, 4, 32, 128, 512))
    first = BT.bottleneck_tail(*gpu)
    gpu[6].mul_(-1.5)
    second = BT.bottleneck_tail(*gpu)
    ref = BT.bottleneck_tail_strips_plain(*gpu).float()
    torch.testing.assert_close(second.float(), ref, rtol=3e-2, atol=3e-2)
    assert not torch.allclose(first.float(), ref, rtol=3e-2, atol=3e-2)


def test_bottleneck_launches_by_route(cuda_device):
    """Each launch lands on its route's key and no other: bf16 (16, 128,
    512) on the wgmma route, bf16 (32, 128, 512) on the row route, fp32 on
    the fp32 route."""
    cases = [((16, 128, 512), torch.bfloat16, "bottleneck_tail"),
             ((32, 128, 512), torch.bfloat16, "bottleneck_tail_rows"),
             ((16, 128, 512), torch.float32, "bottleneck_tail_f32"),
             ((32, 128, 512), torch.float32, "bottleneck_tail_f32")]
    for (bs, cm, co), dtype, key in cases:
        args = _tail_inputs_cuda(bs, 2, bs, cm, co)
        args = _bf16(args) if dtype == torch.bfloat16 else args
        assert BT.route(dtype, bs, cm, co) == key
        before = dict(kernels.launches)
        BT.bottleneck_tail(*args)
        assert kernels.launches == {**before, key: before[key] + 1}, key


def _ladder_rn50(device, dtype, block, frames, draws):
    """RN50 256x512 ladder engine at ``block`` over ``frames`` with
    injected draws: outputs, executed counts and K2 launches per frame."""
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.core.engine import BlockCopyModel
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    cfg = SwiftNetConfig(backbone="resnet50", num_classes=19)
    params = init_swiftnet(cfg, seed=0, dtype=dtype, device=device)
    blocks = (256 // block) * (512 // block)
    model = BlockCopyModel(make_apply_fn(cfg), params, default_settings(
        block_size=block, block_quantize_number_exec=1 / blocks),
        device=device)
    outs, counts, tails = [], [], []
    for frame, d in zip(frames, draws):
        d = None if d is None else tuple(x.to(device) for x in d)
        before = dict(kernels.launches)
        outs.append(model(frame.to(device, dtype), d).float().cpu())
        counts.append(model.policy_meta["num_exec"])
        tails.append({k: kernels.launches[k] - before[k] for k in K2_KEYS})
    return outs, counts, tails


@pytest.mark.parametrize("block,dtype,per_frame,tol", [
    (256, torch.bfloat16, 10, 3e-2), (256, torch.float32, 10, 1e-3),
    (128, torch.bfloat16, 8, 3e-2), (128, torch.float32, 8, 1e-3)])
def test_rn50_ladder_frames_by_block_size(cuda_device, monkeypatch, block,
                                          dtype, per_frame, tol):
    """RN50 ladder frames on the card against the CPU run (plain versions),
    within ``tol`` of the largest |CPU output| (bf16: 3e-2; fp32: 1e-3, a
    3-frame clip through the whole net), with K2's launches per executed
    frame by route: at block 256 layers 2-4 (3 + 5 + 2), on the row route in
    bf16; at block 128 layers 2-3 (3 + 5), on the wgmma route in bf16; fp32
    on its own route."""
    from blockcopy_tpu_torch.policy import net as policy_net
    from blockcopy_tpu_torch.tools.measure import synthetic_frames
    monkeypatch.setattr(policy_net, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    gh, gw = 256 // block, 512 // block
    frames = synthetic_frames((1, 256, 512, 3), 3, torch.float32, seed=2,
                              device="cpu")
    gen = torch.Generator().manual_seed(block)
    draws = [None]
    for n_exec in (1, gh * gw - 1):
        u = torch.full((gh * gw,), 2.0)
        u[torch.randperm(gh * gw, generator=gen)[:n_exec]] = -1.0
        draws.append((u.view(1, gh, gw), torch.rand((gh * gw,),
                                                    generator=gen)))
    gpu, counts, tails = _ladder_rn50("cuda", dtype, block, frames, draws)
    cpu, cpu_counts, _ = _ladder_rn50("cpu", dtype, block, frames, draws)
    assert counts == cpu_counts == [gh * gw, 1, gh * gw - 1]
    key = ("bottleneck_tail_f32" if dtype == torch.float32 else
           "bottleneck_tail" if block == 128 else "bottleneck_tail_rows")
    assert tails == [{k: per_frame if k == key else 0 for k in K2_KEYS}] * 3
    for a, b in zip(gpu, cpu):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= tol * b.abs().max().item()


def test_detection_step_matches_cpu(cuda_device, monkeypatch):
    """The detection step on the card (K1, K2) against the CPU (plain
    versions): CSP (1, 2, 2, 1) 256x512 fp32, capacity 4, 3 frames with
    injected draws (``tools/measure.py:detection_clip``).  Grids, ``valid``
    and ``labels`` equal; canvases and dets within 1e-3 of their largest
    |CPU value|.  Per frame 9 K1 launches (the stem, one per layer1 and
    layer4 block, layer2/3's strided blocks, the head's 4) and 2 K2."""
    from blockcopy_tpu_torch.policy import net as policy_net
    from blockcopy_tpu_torch.tools.measure import compare_clips, detection_clip
    monkeypatch.setattr(policy_net, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    before = dict(kernels.launches)
    gpu = detection_clip("cuda")
    used = {k: kernels.launches[k] - before[k] for k in before}
    cpu = detection_clip("cpu")
    assert used["halo_strips"] == 27 and used["bottleneck_tail_f32"] == 6
    grids, canvas_err, dets_err = compare_clips(gpu, cpu)
    assert grids and canvas_err <= 1e-3
    assert None not in dets_err and max(dets_err) <= 1e-3
    assert all(int(f["dets"][2].sum()) > 0 for f in cpu)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_csp_full_depth_launches(cuda_device, dtype):
    """CSP-R50 at full depth, block 128 (a 256x512 clip, capacity 4): 13 K1
    and 8 K2 launches a frame, layer2 blocks 1-3 and layer3 blocks 1-5
    fused in both dtypes."""
    from blockcopy_tpu_torch.tools.measure import csp_stepper, synthetic_frames
    shape = (1, 256, 512, 3)
    params, st = csp_stepper(shape, 4, dtype, cuda_device)
    frames = synthetic_frames(shape, 2, dtype, device=cuda_device)
    before = dict(kernels.launches)
    state = st.first_step(params, st.init_state(params, seed=1), frames[0])
    state = st.step(params, state, frames[1])
    used = {k: kernels.launches[k] - before[k] for k in before}
    key = ("bottleneck_tail" if dtype == torch.bfloat16
           else "bottleneck_tail_f32")
    assert used["halo_strips"] == 26 and used[key] == 16
    assert bool(torch.isfinite(state["dets"]).all())


def _frame_syncs(fn):
    """``fn()`` under torch's sync debug mode: its result and the number
    of synchronizing CUDA calls it made."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    hits = [w for w in caught if "synchronizing" in str(w.message)]
    return out, len(hits), [f"{w.filename}:{w.lineno}" for w in hits]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_csp_ladder_frames(cuda_device, dtype):
    """``CSPBlockCopy`` from the shipped 0.3 config (CSP-R50 at full depth,
    ``rl_objectdetection``, ``ref`` policy, verbose, REINFORCE every 4th
    frame) on two 256x512 clips of 5 frames, the ``csp_cls`` bias 0: per
    frame of the second clip the host syncs are the count, the NaN guard
    where the policy ran, the boxes' one transfer where blocks ran and the
    verbose print on a train frame (the first clip warms the process up: a
    process's first frame makes one more, once); 13 K1 and 8 K2 launches
    per executed frame; the gain's masks on the card in fp32; boxes inside
    the image, scores at least the config's ``score_thr`` 0.1."""
    from blockcopy_tpu_torch.models.builder import build_detector
    from blockcopy_tpu_torch.tools.measure import synthetic_frames
    from blockcopy_tpu_torch.utils.registry import load_config
    model = build_detector(load_config(DET_CONFIG), dtype=dtype,
                           device=cuda_device)
    model.params["head"]["csp_cls"]["b"].zero_()
    frames = synthetic_frames((1, 256, 512, 3), 5, dtype, device=cuda_device)
    for clip in range(2):
        model.reset_temporal()
        for t, frame in enumerate(frames, start=1):
            _check_ladder_frame(model, frame, t, check_syncs=clip == 1,
                                dtype=dtype)
    meta = model.policy_meta
    assert isinstance(meta["information_gain"], torch.Tensor)
    assert meta["information_gain"].device.type == "cuda"


def _check_ladder_frame(model, frame, t, check_syncs, dtype):
    """One ``CSPBlockCopy`` frame: its syncs (``check_syncs``), launches
    (K2 on the route of ``dtype``), gain tensors and boxes."""
    key = ("bottleneck_tail" if dtype == torch.bfloat16
           else "bottleneck_tail_f32")
    before = dict(kernels.launches)
    boxes, syncs, where = _frame_syncs(lambda: model(frame))
    meta = model.policy_meta
    count, ran = meta["num_exec"], meta.get("_rl_cache") is not None
    want = 1 + ran + (count > 0) + (t % 4 == 0)
    if check_syncs:
        assert syncs == want, (t, syncs, want, where)
    used = {k: kernels.launches[k] - before[k]
            for k in ("halo_strips", key)}
    assert used == ({"halo_strips": 13, key: 8} if count
                    else {"halo_strips": 0, key: 0})
    assert meta["output_repr"].device.type == "cuda"
    assert meta["output_repr"].dtype == torch.float32
    if t == 1:
        assert count == 8 and len(boxes[0]) >= 8
    live = boxes[0]
    assert np.all((live[:, 4] >= 0.1) & (live[:, 0] >= 0)
                  & (live[:, 2] <= 511) & (live[:, 3] <= 255))


@pytest.mark.parametrize("extra", [["--half"], ["--half", "--speed-mode"],
                                   []])
def test_detection_cli_on_card(cuda_device, extra):
    """The detection CLI at 256x512 on the card (``--device cuda``) from
    the shipped 0.3 config, random weights: the JSON line's keys and
    ranges, 13 K1 and 8 K2 launches per frame that ran blocks (every frame
    in speed mode)."""
    from blockcopy_tpu_torch.models.csp import CSPBlockCopy
    from blockcopy_tpu_torch.tasks.detection import eval as cli
    executed = [0]
    decode = CSPBlockCopy._decode

    def counted(self, maps):
        executed[0] += 1
        return decode(self, maps)

    CSPBlockCopy._decode = counted
    before = dict(kernels.launches)
    try:
        res = cli.main(["--synthetic", "--res", "256", "--clip-length", "4",
                        "--num-clips-warmup", "1", "--num-clips-eval", "1",
                        "--workers", "1", "--device", "cuda", "--config",
                        DET_CONFIG, *extra])
    finally:
        CSPBlockCopy._decode = decode
    used = {k: kernels.launches[k] - before[k] for k in before}
    frames = 8 if "--speed-mode" in extra else executed[0]
    assert frames >= 2
    assert used["halo_strips"] == 13 * frames
    key = "bottleneck_tail" if "--half" in extra else "bottleneck_tail_f32"
    assert used[key] == 8 * frames
    assert all(0 <= res[f"MR_{k}"] <= 100 or res[f"MR_{k}"] == -1
               for k in ("Reasonable", "All"))
    assert res["fps"] > 0 and res["gmacs_per_image"] > 0
    assert 0 < res["perc_exec"] <= 1 and res["block_target"] == 0.3


def test_train_step_matches_cpu(cuda_device):
    """Two detection train steps of CSP (1, 2, 2, 1) at 128x256 fp32 on the
    card against the CPU, TF32 off (``tools/measure.py:train_parity``, as
    ``chip_smoke.py`` phase 11c): losses within 1e-4 relative, every
    gradient leaf within 1e-4 of its largest |CPU value| with the card's
    ReLUs given the CPU's masks (disagreeing only within 1e-5 of the
    input's largest value), the same key sets, and the Adam + EMA update
    fed the same gradients within 1e-6; no kernel launch."""
    from blockcopy_tpu_torch.tools.measure import train_parity
    before = dict(kernels.launches)
    report = train_parity(steps=2)
    assert kernels.launches == before
    for r in report:
        assert r["loss_err"] <= 1e-4 and r["grad_err"] <= 1e-4, r
        assert r["grad_keys_equal"] and r["flip_max_rel_input"] <= 1e-5, r
        assert r["update_err"] <= 1e-6, r


def test_trained_checkpoint_ladder_frames(cuda_device, tmp_path):
    """A teacher checkpoint written by the train CLI on the card (2 steps at
    256x512) serves through ``CSPBlockCopy`` from the shipped 0.3 config in
    bf16: 13 K1 and 8 K2 launches per executed frame of a 256x512 clip."""
    from blockcopy_tpu_torch.models.builder import build_detector
    from blockcopy_tpu_torch.tasks.detection import train_cli
    from blockcopy_tpu_torch.tools.measure import synthetic_frames
    from blockcopy_tpu_torch.utils.registry import load_config
    res = train_cli.main([
        "--synthetic", "--crop-height", "256", "--crop-width", "512",
        "--epochs", "1", "--steps-per-epoch", "2", "--batch-size", "1",
        "--num-samples", "2", "--workers", "1", "--warmup-iters", "0",
        "--out", str(tmp_path)])
    assert res["step"] == 2
    model = build_detector(load_config(DET_CONFIG), dtype=torch.bfloat16,
                           device=cuda_device,
                           checkpoint=str(tmp_path / "epoch_1_teacher.npz"))
    frames = synthetic_frames((1, 256, 512, 3), 4, torch.bfloat16,
                              device=cuda_device)
    model.reset_temporal()
    executed = 0
    for frame in frames:
        before = dict(kernels.launches)
        model(frame)
        used = {k: kernels.launches[k] - before[k]
                for k in ("halo_strips", "bottleneck_tail")}
        ran = model.policy_meta["num_exec"] > 0
        executed += ran
        assert used == {"halo_strips": 13 * ran, "bottleneck_tail": 8 * ran}
    assert executed >= 1           # frame 1 runs every block


def test_two_ranks_on_one_card(cuda_device, monkeypatch):
    """Two gloo ranks on ``cuda:0`` (NCCL takes one rank per GPU), RN18
    256x512 fp32, each on its own clip: every frame of each rank launches
    the halo kernel, and the policy stays bitwise equal across the ranks
    after every frame, the averaged updates (frames 2 and 4) included."""
    from blockcopy_tpu_torch.parallel import clip_parallel
    from torch_rank_workers import card_rank
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    spec = clip_parallel.make_group(2, ["cuda:0", "cuda:0"], backend="gloo")
    (l0, d0), (l1, d1) = clip_parallel.spawn(spec, card_rank, timeout=600)
    assert d0 == d1
    assert d0[0] != d0[1] == d0[2] != d0[3]     # trained at frames 2, 4
    for launches in (l0, l1):
        assert launches["halo_strips"] > 0 and launches["halo_strips"] % 4 \
            == 0, launches


@pytest.mark.parametrize("rows,k,n", [(128, 64, 8), (128, 160, 136),
                                      (384, 1152, 128), (16896, 96, 24),
                                      (512, 1152, 136), (4096, 2304, 256),
                                      (8576, 160, 136)])
def test_mm_kernels_match_plain(cuda_device, rows, k, n):
    """int8 bitwise, bf16 within one bf16 ulp (rtol 2^-7, 1e-3 near 0; TF32
    off).  k 160 and 96 end in a short chunk, n 136 and 24 in a partial
    column tile (of 128 columns, and of 256 at 8576 rows), n 8 in one mostly
    empty tile; 384, 512 and 4096 rows split k; 128, 384 and 8576 rows run
    single CTAs, the others 2-CTA clusters (``MM.plan``)."""
    rs = np.random.RandomState(rows + k + n)
    xb = torch.from_numpy(rs.randn(rows, k).astype(np.float32))
    wb = torch.from_numpy(rs.randn(k, n).astype(np.float32))
    xi = torch.from_numpy(rs.randint(-128, 128, (rows, k)).astype(np.int8))
    wi = torch.from_numpy(rs.randint(-128, 128, (k, n)).astype(np.int8))
    xb, wb = (t.to(cuda_device, torch.bfloat16) for t in (xb, wb))
    xi, wi = xi.to(cuda_device), wi.to(cuda_device)
    before = dict(kernels.launches)
    got = MM.mm_bf16(xb, wb)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, n)
    torch.testing.assert_close(got.float(), MM.mm_bf16_plain(xb, wb).float(),
                               rtol=2 ** -7, atol=1e-3)
    got = MM.mm_int8(xi, wi)
    assert got.dtype == torch.int32
    assert torch.equal(got, MM.mm_int8_plain(xi, wi))
    assert kernels.launches["mm_bf16"] == before["mm_bf16"] + 1
    assert kernels.launches["mm_int8"] == before["mm_int8"] + 1


@pytest.mark.parametrize("rows,k,n,splits", [(512, 1152, 136, 2),
                                             (16896, 96, 24, 1)])
def test_mm_cluster_plan_matches_plain(cuda_device, monkeypatch, rows, k, n,
                                       splits):
    """2-CTA clusters (each w tile multicast to both) with 256-column tiles
    and k splits, a plan ``plan`` does not make at these shapes."""
    monkeypatch.setattr(MM, "plan", lambda rows, k, n, sms, itemsize:
                        MM.Plan(256 if n > 128 else 128, 2, splits))
    rs = np.random.RandomState(rows + k)
    xb = torch.from_numpy(rs.randn(rows, k).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    wb = torch.from_numpy(rs.randn(k, n).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    xi = torch.from_numpy(rs.randint(-128, 128, (rows, k)).astype(
        np.int8)).to(cuda_device)
    wi = torch.from_numpy(rs.randint(-128, 128, (k, n)).astype(
        np.int8)).to(cuda_device)
    torch.testing.assert_close(MM.mm_bf16(xb, wb).float(),
                               MM.mm_bf16_plain(xb, wb).float(),
                               rtol=2 ** -7, atol=1e-3)
    assert torch.equal(MM.mm_int8(xi, wi), MM.mm_int8_plain(xi, wi))


def test_mm_kernels_refuse_bad_inputs(cuda_device):
    """Refused before any launch: the counts do not move."""
    i8 = dict(dtype=torch.int8, device=cuda_device)
    bf = dict(dtype=torch.bfloat16, device=cuda_device)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="rows"):
        MM.mm_bf16(torch.zeros((100, 64), **bf), torch.zeros((64, 8), **bf))
    with pytest.raises(ValueError, match="multiple"):
        MM.mm_int8(torch.zeros((128, 48), **i8), torch.zeros((48, 8), **i8))
    with pytest.raises(ValueError, match="multiple"):
        MM.mm_bf16(torch.zeros((128, 64), **bf), torch.zeros((64, 12), **bf))
    with pytest.raises(ValueError, match="dtype"):
        MM.mm_int8(torch.zeros((128, 64), **bf), torch.zeros((64, 8), **bf))
    with pytest.raises(ValueError, match="contiguous"):
        MM.mm_bf16(torch.zeros((64, 128), **bf).t(),
                   torch.zeros((64, 8), **bf))
    assert kernels.launches == before


# -- the steps as CUDA graphs (core/graphs.py) --------------------------------


def _graph_states(stepper, params, frames, draws, graphs):
    """The stepper's states after every frame of ``frames`` (CPU copies),
    eager or through ``StepperGraphs``, and the launches of each frame."""
    from blockcopy_tpu_torch.core.graphs import StepperGraphs
    from blockcopy_tpu_torch.policy.optim import tree_map
    run = StepperGraphs(stepper) if graphs else stepper
    state = stepper.init_state(params, seed=1)
    states, launches = [], []
    for t, frame in enumerate(frames):
        before = dict(kernels.launches)
        if t == 0:
            state = run.first_step(params, state, frame)
        else:
            state = run.step(params, state, frame,
                             draws=None if draws is None else draws[t - 1])
        launches.append({k: kernels.launches[k] - before[k] for k in before})
        states.append(tree_map(
            lambda x: x.cpu().clone() if isinstance(x, torch.Tensor) else x,
            {k: v for k, v in state.items() if k != "policy"}
            | {"params": state["policy"]["params"]}))
    return states, launches


def _rn18_stepper(device):
    from blockcopy_tpu_torch.tools.measure import (swiftnet_stepper,
                                                   synthetic_frames)
    params, stepper = swiftnet_stepper("resnet18", (1, 256, 512, 3), 4,
                                       torch.float32, device,
                                       train_interval=2)
    return params, stepper, synthetic_frames((1, 256, 512, 3), 6,
                                             torch.float32, device=device)


def test_captured_step_matches_eager(cuda_device, monkeypatch):
    """RN18 256x512 fp32, capacity 4, REINFORCE every 2nd frame, 6 frames
    with injected draws: the step as CUDA graphs (three captured: first,
    plain, train; replays from frame 4) against the eager step: the same
    grids, launches a frame and frame counters, every other tensor
    bitwise (cuDNN deterministic)."""
    from blockcopy_tpu_torch.policy import net as policy_net
    monkeypatch.setattr(policy_net, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    params, stepper, frames = _rn18_stepper(cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(3)
    draws = [(torch.rand((1, 2, 4), generator=gen, device=cuda_device),
              torch.rand((8,), generator=gen, device=cuda_device))
             for _ in frames[1:]]
    eager, e_launches = _graph_states(stepper, params, frames, draws, False)
    graphs, g_launches = _graph_states(stepper, params, frames, draws, True)
    assert g_launches == e_launches and e_launches[-1]["halo_strips"] > 0
    for t, (a, b) in enumerate(zip(eager, graphs), 1):
        assert a["frame_idx"] == b["frame_idx"] == t
        for x, y in zip(_tensor_leaves(a), _tensor_leaves(b)):
            assert torch.equal(x, y), f"frame {t}"


def _tensor_leaves(tree):
    from blockcopy_tpu_torch.policy.optim import tree_leaves
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def test_captured_step_draws_from_its_generator(cuda_device):
    """Without injected draws the captured steps draw from the state's
    generator, registered with each graph: every replay draws a new grid
    of exactly ``capacity`` blocks, the same grids as the eager step from
    the same seed."""
    params, stepper, frames = _rn18_stepper(cuda_device)
    frames = frames + frames
    eager, _ = _graph_states(stepper, params, frames, None, False)
    graphs, _ = _graph_states(stepper, params, frames, None, True)
    grids = [s["prev_grid"] for s in graphs[1:]]
    assert all(int(g.sum()) == stepper.capacity for g in grids)
    # replays (frames 4-12) draw grids of their own
    assert len({tuple(g.flatten().tolist()) for g in grids[2:]}) > 3
    assert all(torch.equal(a["prev_grid"], b["prev_grid"])
               for a, b in zip(eager, graphs))


def test_captured_step_refuses_a_rebound_state(cuda_device):
    """A state whose tensors are not those the graph captured raises at
    the next replay: the graph would read the old buffers."""
    params, stepper, frames = _rn18_stepper(cuda_device)
    from blockcopy_tpu_torch.core.graphs import StepperGraphs
    graphs = StepperGraphs(stepper)
    state = graphs.first_step(params, stepper.init_state(params, seed=1),
                              frames[0])
    state = graphs.first_step(params, state, frames[0])
    state["prev_grid"] = state["prev_grid"].clone()
    with pytest.raises(RuntimeError, match="stale CUDA graph"):
        graphs.first_step(params, state, frames[0])


def test_captured_ladder_matches_eager(cuda_device, monkeypatch):
    """The ladder engine with a graph per capacity against the op-by-op
    engine: RN50 256x512 fp32 (ladder {2, 4, 6, 8}), 5 frames with
    injected draws at counts 8, 4, 6, 4, 2: the same counts, outputs
    bitwise, one graph for each capacity, and the previous output kept
    apart from the next replay's."""
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.core.engine import BlockCopyModel
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    from blockcopy_tpu_torch.policy import net as policy_net
    from blockcopy_tpu_torch.tools.measure import synthetic_frames
    monkeypatch.setattr(policy_net, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = SwiftNetConfig(backbone="resnet50", num_classes=19)
    params = init_swiftnet(cfg, seed=0, device=cuda_device)
    frames = synthetic_frames((1, 256, 512, 3), 5, torch.float32, seed=2,
                              device=cuda_device)
    gen = torch.Generator().manual_seed(6)
    draws = [None]
    for n_exec in (3, 5, 4, 2):
        u = torch.full((8,), 2.0)
        u[torch.randperm(8, generator=gen)[:n_exec]] = -1.0
        draws.append((u.view(1, 2, 4).to(cuda_device),
                      torch.rand((8,), generator=gen).to(cuda_device)))
    runs = {}
    for graphs in (False, True):
        model = BlockCopyModel(make_apply_fn(cfg), params, default_settings(
            block_quantize_number_exec=0.25), device=cuda_device,
            graphs=graphs)
        outs, counts = [], []
        for t, (frame, d) in enumerate(zip(frames, draws)):
            outs.append(model(frame, d).clone())
            counts.append(model.policy_meta["num_exec"])
            if t:
                assert torch.equal(model.policy_meta["outputs_prev"],
                                   outs[-2])
        runs[graphs] = (outs, counts, sorted(model._steps))
    assert runs[False][1] == runs[True][1] == [8, 4, 6, 4, 2]
    assert runs[True][2] == [2, 4, 6, 8]
    for a, b in zip(runs[False][0], runs[True][0]):
        assert torch.equal(a, b)


def test_blocked_group_norm_is_deterministic(cuda_device):
    """The blocked GroupNorm (CSP's head) sums its statistics per image as
    a masked reduction, not with float atomics: repeated calls on 128 bf16
    blocks agree bitwise, so two runs of a detection step do too."""
    from blockcopy_tpu_torch.core.blocked import BlockPack
    from blockcopy_tpu_torch.ops import layers
    gen = torch.Generator(cuda_device).manual_seed(0)
    k, bs, c = 128, 32, 256
    d = torch.randn((k, bs, bs, c), generator=gen, device=cuda_device) * 3
    x = BlockPack(d.to(torch.bfloat16), torch.arange(k, device=cuda_device),
                  1, 8, 16)
    gamma = torch.rand((c,), generator=gen, device=cuda_device)
    beta = torch.randn((c,), generator=gen, device=cuda_device)
    outs = [layers.group_norm(x, 32, gamma, beta).data for _ in range(8)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
