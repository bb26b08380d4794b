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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,cm,co", [(8, 256, 1024), (16, 128, 512)])
def test_bottleneck_kernel_matches_plain(cuda_device, bs, cm, co, dtype):
    """The RN50 layer3 and layer2 shapes: 1e-4 in fp32 (TF32 off), 3e-2 in
    bf16 (the kernel and the plain version round at the same points but
    sum in another order)."""
    args = _tail_inputs(np.random.RandomState(bs), 6, bs, cm, co)
    gpu = [{k: v.to(cuda_device, dtype) for k, v in a.items()}
           if isinstance(a, dict) else a.to(cuda_device, dtype) for a in args]
    ref = BT.bottleneck_tail_plain(*gpu)
    before = kernels.launches["bottleneck_tail"]
    got = BT.bottleneck_tail(*gpu)
    assert kernels.launches["bottleneck_tail"] == before + 1
    assert got.dtype == dtype and got.shape == (6, bs, bs, co)
    t = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), ref.float(), rtol=t, atol=t)


def test_bottleneck_kernel_refuses_unsupported_width(cuda_device):
    args = _tail_inputs(np.random.RandomState(0), 2, 8, 192, 256)
    gpu = [{k: v.to(cuda_device) for k, v in a.items()}
           if isinstance(a, dict) else a.to(cuda_device) for a in args]
    with pytest.raises(ValueError, match="Cm"):
        BT.bottleneck_tail(*gpu)
