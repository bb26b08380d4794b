"""The CUDA kernels against their plain versions, on a GPU.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Without a GPU every case skips (decided when the test runs).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from blockcopy_tpu_torch.core import grid as TG
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
    in bf16 and 1e-4 in fp32.  The shapes are the semseg and the detection
    ladders' both (RN50 and CSP-R50 layer2 and layer3)."""
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
    # fp32: Cm not a multiple of the kernel's 64-column tile
    args = _tail_inputs(np.random.RandomState(0), 2, 8, 96, 256)
    with pytest.raises(ValueError, match="Cm"):
        BT.bottleneck_tail(*_gpu(args, cuda_device, torch.float32))
    args = _tail_inputs(np.random.RandomState(0), 2, 16, 256, 1024)
    with pytest.raises(ValueError, match="Cm"):
        BT.bottleneck_tail(*_gpu(args, cuda_device, torch.bfloat16))


def _tail_inputs_cuda(seed, k, bs, cm, co):
    """``_tail_inputs``' tensors with weights scaled by their fan-in, drawn
    on the card (the block-256 shapes at K = 128 are hundreds of MB)."""
    gen = torch.Generator("cuda").manual_seed(seed)

    def arr(*shape, relu=False, scale=1.0):
        a = torch.randn(shape, generator=gen, device="cuda") * scale
        return a.clamp_min(0) if relu else a

    shapes = {"top": (k, 1, bs, cm), "bottom": (k, 1, bs, cm),
              "left": (k, bs, 1, cm), "right": (k, bs, 1, cm)}
    pieces = {name: arr(*shapes.get(name, (k, 1, 1, cm)), relu=True)
              for name in BT.PIECES}
    return [arr(k, bs, bs, cm, relu=True), arr(k, bs, bs, co), pieces,
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
    before = kernels.launches["bottleneck_tail"]
    got = BT.bottleneck_tail(*args)
    assert kernels.launches["bottleneck_tail"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (k, bs, bs, co)
    torch.testing.assert_close(got, BT.bottleneck_tail_plain(*args),
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
                               BT.bottleneck_tail_plain(*args),
                               rtol=1e-4, atol=1e-4)


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
        before = kernels.launches["bottleneck_tail"]
        outs.append(model(frame.to(device, dtype), d).float().cpu())
        counts.append(model.policy_meta["num_exec"])
        tails.append(kernels.launches["bottleneck_tail"] - before)
    return outs, counts, tails


@pytest.mark.parametrize("block,dtype,per_frame,tol", [
    (256, torch.bfloat16, 0, 3e-2), (256, torch.float32, 10, 1e-3),
    (128, torch.bfloat16, 8, 3e-2), (128, torch.float32, 8, 1e-3)])
def test_rn50_ladder_frames_by_block_size(cuda_device, monkeypatch, block,
                                          dtype, per_frame, tol):
    """RN50 ladder frames on the card against the CPU run (plain versions),
    within ``tol`` of the largest |CPU output| (bf16: 3e-2; fp32: 1e-3, a
    3-frame clip through the whole net), with K2's launches per executed
    frame: at block 256 the bf16 kernel takes none of the fused blocks,
    which run unfused (0), the fp32 kernel all of layers 2-4 (3 + 5 + 2);
    at block 128 both take layers 2-3 (3 + 5)."""
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
    assert tails == [per_frame] * 3
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
    assert used["halo_strips"] == 27 and used["bottleneck_tail"] == 6
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
    assert used["halo_strips"] == 26 and used["bottleneck_tail"] == 16
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
            _check_ladder_frame(model, frame, t, check_syncs=clip == 1)
    meta = model.policy_meta
    assert isinstance(meta["information_gain"], torch.Tensor)
    assert meta["information_gain"].device.type == "cuda"


def _check_ladder_frame(model, frame, t, check_syncs):
    """One ``CSPBlockCopy`` frame: its syncs (``check_syncs``), launches,
    gain tensors and boxes."""
    before = dict(kernels.launches)
    boxes, syncs, where = _frame_syncs(lambda: model(frame))
    meta = model.policy_meta
    count, ran = meta["num_exec"], meta.get("_rl_cache") is not None
    want = 1 + ran + (count > 0) + (t % 4 == 0)
    if check_syncs:
        assert syncs == want, (t, syncs, want, where)
    used = {k: kernels.launches[k] - before[k]
            for k in ("halo_strips", "bottleneck_tail")}
    assert used == ({"halo_strips": 13, "bottleneck_tail": 8} if count
                    else {"halo_strips": 0, "bottleneck_tail": 0})
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
    assert used["bottleneck_tail"] == 8 * frames
    assert all(0 <= res[f"MR_{k}"] <= 100 or res[f"MR_{k}"] == -1
               for k in ("Reasonable", "All"))
    assert res["fps"] > 0 and res["gmacs_per_image"] > 0
    assert 0 < res["perc_exec"] <= 1 and res["block_target"] == 0.3


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
