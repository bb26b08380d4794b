"""The CUDA kernels against their plain versions, on a GPU.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Without a GPU every case skips (decided when the test runs).
"""

import numpy as np
import pytest
import torch

from blockcopy_tpu_torch.core import grid as TG
from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
from blockcopy_tpu_torch.ops.kernels import halo as H
from blockcopy_tpu_torch.ops.kernels import mm as MM

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,c", [(32, 48), (16, 256), (8, 512), (4, 512)])
def test_halo_kernel_ladder_capacity_8(cuda_device, bs, c, dtype):
    """Ladder mode's smallest capacity at 1024x2048: 8 of 128 blocks, one
    of them a padding slot, at main-path (bs, C), both entry points."""
    n, gh, gw, pad = 1, 8, 16, 1
    total = n * gh * gw
    gen = torch.Generator().manual_seed(bs + c)
    canvas = torch.randn((total + 1, bs, bs, c), generator=gen).to(dtype)
    canvas[-1] = 0
    grid = torch.zeros(total, dtype=torch.bool)
    grid[torch.randperm(total, generator=gen)[:7]] = True
    idx = TG.exec_indices(grid.view(n, gh, gw), 8)
    center = torch.randn((8, bs, bs, c), generator=gen).to(dtype)
    strips = {"rows": torch.cat([canvas[:, :pad], canvas[:, -pad:]], 1),
              "cols": torch.cat([canvas[:, :, :pad], canvas[:, :, -pad:]], 2)}
    ref = H.halo_gather_canvas_plain(canvas, idx, pad, n, gh, gw, center)
    dev = {"device": cuda_device}
    got_c = H.halo_gather_canvas(canvas.to(**dev), idx.to(**dev), pad, n,
                                 gh, gw, center.to(**dev))
    got_s = H.halo_gather_strips({k: v.contiguous().to(**dev)
                                  for k, v in strips.items()},
                                 idx.to(**dev), pad, n, gh, gw,
                                 center.to(**dev))
    assert torch.equal(got_c.cpu(), ref) and torch.equal(got_s.cpu(), ref)


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


def _tail_inputs(rs, k, bs, cm, co):
    def arr(*shape, relu=False, scale=1.0):
        a = rs.randn(*shape).astype(np.float32) * scale
        return torch.from_numpy(np.maximum(a, 0) if relu else a)

    shapes = {"top": (k, 1, bs, cm), "bottom": (k, 1, bs, cm),
              "left": (k, bs, 1, cm), "right": (k, bs, 1, cm)}
    pieces = {name: arr(*shapes.get(name, (k, 1, 1, cm)), relu=True)
              for name in BT.PIECES}
    return [arr(k, bs, bs, cm, relu=True), arr(k, bs, bs, co), pieces,
            arr(cm, cm, 3, 3, scale=0.05), 1 + arr(cm, scale=0.1),
            arr(cm, scale=0.1), arr(co, cm, 1, 1, scale=0.05),
            1 + arr(co, scale=0.1), arr(co, scale=0.1)]


def _gpu(args, device, dtype):
    return [{k: v.to(device, dtype) for k, v in a.items()}
            if isinstance(a, dict) else a.to(device, dtype) for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,cm,co", [(8, 256, 1024), (16, 128, 512)])
def test_bottleneck_kernel_matches_plain(cuda_device, bs, cm, co, dtype):
    """The RN50 layer3 and layer2 shapes: 1e-4 in fp32 (TF32 off), 3e-2 in
    bf16 (the kernel and the plain version round at the same points but
    sum in another order)."""
    gpu = _gpu(_tail_inputs(np.random.RandomState(bs), 6, bs, cm, co),
               cuda_device, dtype)
    ref = BT.bottleneck_tail_plain(*gpu)
    before = kernels.launches["bottleneck_tail"]
    got = BT.bottleneck_tail(*gpu)
    assert kernels.launches["bottleneck_tail"] == before + 1
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
    in bf16 and 1e-4 in fp32."""
    gpu = _gpu(_tail_inputs(np.random.RandomState(k + cm), k, bs, cm, co),
               cuda_device, dtype)
    got = BT.bottleneck_tail(*gpu)
    t = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(),
                               BT.bottleneck_tail_plain(*gpu).float(),
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
                               BT.bottleneck_tail_plain(*gpu).float(),
                               rtol=3e-2, atol=3e-2)


def test_bottleneck_weight_update_in_place(cuda_device):
    """The prepared weights follow an in-place update of w2 between two
    calls (the cache keys on the tensor's version)."""
    gpu = _gpu(_tail_inputs(np.random.RandomState(7), 4, 16, 128, 512),
               cuda_device, torch.bfloat16)
    first = BT.bottleneck_tail(*gpu)
    gpu[3].mul_(-1.5)
    second = BT.bottleneck_tail(*gpu)
    ref = BT.bottleneck_tail_plain(*gpu).float()
    torch.testing.assert_close(second.float(), ref, rtol=3e-2, atol=3e-2)
    assert not torch.allclose(first.float(), ref, rtol=3e-2, atol=3e-2)


def test_bottleneck_kernel_refuses_unsupported_width(cuda_device):
    args = _tail_inputs(np.random.RandomState(0), 2, 8, 192, 256)
    with pytest.raises(ValueError, match="Cm"):
        BT.bottleneck_tail(*_gpu(args, cuda_device, torch.float32))
    args = _tail_inputs(np.random.RandomState(0), 2, 16, 256, 1024)
    with pytest.raises(ValueError, match="Cm"):
        BT.bottleneck_tail(*_gpu(args, cuda_device, torch.bfloat16))


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
