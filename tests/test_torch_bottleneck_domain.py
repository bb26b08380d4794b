"""The fused bottleneck tail's domain: the port's gate held against JAX's,
block by block, over the backbones and block sizes it meets; the route each
block takes in the kernel; and the kernel sites of the block-256 path that
``chip_smoke.py`` phase 4b counts on the card.  The CUDA routes are held
against the plain version in ``test_torch_kernels_gpu.py``."""

import jax
import jax.numpy as jnp
import pytest
import torch

import blockcopy_tpu.models.csp as JC
import blockcopy_tpu.models.swiftnet as JS
import blockcopy_tpu.ops.layers as JL
import blockcopy_tpu_torch.core.blocked as TB
import blockcopy_tpu_torch.models.csp as TC
import blockcopy_tpu_torch.models.swiftnet as TS
import blockcopy_tpu_torch.ops.layers as TL
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.core.blocked import ExecCtx as JCtx, split_dense as jsplit
from blockcopy_tpu_torch.core import grid as TG
from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import bottleneck as BT
from torch_port_util import two_torch_threads  # noqa: F401

# blocks each gate fuses per blocked pass (the counts JAX's gate gives with
# its switch on): RN50 layer2 (bs = block / 8, Cm 128), layer3 (block / 16,
# 256), layer4 (block / 32, 512) wherever bs >= 8; RN101 the same with 22
# fusable layer3 blocks; wide_resnet50_2 also layer1 (block / 4, Cm 128,
# Co 256); CSP-R50 layers 2-3 (its layer1 has Cm 64, its layer4 is dilated)
FUSED = {
    "resnet50": {64: 3, 128: 8, 256: 10},
    "resnet101": {64: 3, 128: 25, 256: 27},
    "wide_resnet50_2": {64: 5, 128: 10, 256: 12},
    "csp_r50": {64: 3, 128: 8, 256: 8},
}


def _stand_ins(monkeypatch, pkg_l, stems, out_channels, zeros):
    """Convolutions and BN that only shape their outputs, and stems that
    only shape theirs (block / 4, 64 channels): the pass then exercises the
    model's control flow and the gate and computes nothing."""
    def conv(ctx, name, x, w, b=None, stride=1, **kw):
        k, bs = x.data.shape[:2]
        return x.with_data(zeros((k, bs // stride, bs // stride,
                                  out_channels(w)), dtype=x.data.dtype))

    def stem(ctx, x, params):
        k, bs = x.data.shape[:2]
        return x.with_data(zeros((k, bs // 4, bs // 4, 64),
                                 dtype=x.data.dtype))

    monkeypatch.setattr(pkg_l, "conv2d", conv)
    monkeypatch.setattr(pkg_l, "batch_norm", lambda x, scale, bias: x)
    for module in stems:
        monkeypatch.setattr(module, "_stem", stem)


def _jax_fused(backbone, block, dtype, monkeypatch):
    """``{name: (bs, Cm, Co)}`` of the bottlenecks JAX's gate fuses, switch
    on, in one blocked (not building) pass over a 1 x 2 grid; parameters
    as shapes only (``jax.eval_shape``)."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    key = jax.random.PRNGKey(0)
    if backbone == "csp_r50":
        cfg = JC.CSPConfig()
        params = jax.eval_shape(lambda: JC.init_csp(key, cfg, jdt))[
            "backbone"]
        run = lambda x, ctx: JC.csp_backbone(params, x, ctx, cfg)
    else:
        cfg = JS.RESNETS[backbone]
        params = jax.eval_shape(lambda: JS.init_resnet(key, cfg, jdt))
        run = lambda x, ctx: JS.resnet_forward_down(params, x, ctx, cfg)
    fused = {}

    def record(ctx, name, x, p):
        fused[name] = (x.data.shape[1], p["conv2"]["w"].shape[2],
                       x.data.shape[-1])
        return x

    _stand_ins(monkeypatch, JL, [JS], lambda w: w.shape[3], jnp.zeros)
    monkeypatch.setattr(JS, "FUSED_BOTTLENECK", True)
    monkeypatch.setattr(JS, "_fused_bottleneck", record)
    idx = JG.exec_indices(jnp.ones((1, 1, 2), bool), 2)
    x = jsplit(jnp.zeros((1, block, 2 * block, 3), jdt), idx, 1, 1, 2)
    run(x, JCtx.blocked(idx, 1, 1, 2, {}, building=False))
    return fused


def _port_fused(backbone, block, dtype, monkeypatch):
    """The same for the port's gate at its default (on); parameters on the
    meta device, made by the port's own initialisers."""
    monkeypatch.setattr(TS._Init, "conv", lambda self, kh, kw, cin, cout,
                        bias=False: {"w": torch.empty(
                            (cout, cin, kh, kw), dtype=self.dtype,
                            device="meta")})
    if backbone == "csp_r50":
        cfg = TC.CSPConfig()
        params = TC.init_csp(cfg, dtype=dtype, device="meta")["backbone"]
        run = lambda x, ctx: TC.csp_backbone(params, x, ctx, cfg)
    else:
        cfg = TS.RESNETS[backbone]
        params = TS.init_resnet(TS._Init(None, dtype, torch.device("meta")),
                                cfg)
        run = lambda x, ctx: TS.resnet_forward_down(params, x, ctx, cfg)
    fused = {}

    def record(ctx, name, x, p):
        fused[name] = (x.data.shape[1], p["conv2"]["w"].shape[1],
                       x.data.shape[-1])
        return x

    _stand_ins(monkeypatch, TL, [TS, TC], lambda w: w.shape[0], torch.zeros)
    monkeypatch.setattr(TS, "FUSED_BOTTLENECK", None)   # port default: on
    monkeypatch.setattr(TS, "_fused_bottleneck", record)
    idx = TG.exec_indices(torch.ones((1, 1, 2), dtype=torch.bool), 2)
    x = TB.split_dense(torch.zeros((1, block, 2 * block, 3), dtype=dtype),
                       idx, 1, 1, 2)
    run(x, TB.ExecCtx.blocked(idx, 1, 1, 2, {}, building=False))
    return fused


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("backbone", sorted(FUSED))
def test_gate_fuses_what_jax_fuses(backbone, block, dtype, monkeypatch):
    """Block by block, the port's gate fuses exactly the bottlenecks JAX's
    gate fuses with ``FUSED_BOTTLENECK`` on, with the same (bs, Cm, Co);
    the kernel of ``dtype`` takes every one of them."""
    with monkeypatch.context() as m:
        ref = _jax_fused(backbone, block, dtype, m)
    got = _port_fused(backbone, block, dtype, monkeypatch)
    assert got == ref
    assert len(ref) == FUSED[backbone][block]
    assert all(BT.kernel_takes(dtype, *shape) for shape in ref.values())


@pytest.mark.parametrize("dtype,bs,cm,co,key", [
    (torch.bfloat16, 16, 128, 512, "bottleneck_tail"),
    (torch.bfloat16, 8, 256, 1024, "bottleneck_tail"),
    (torch.bfloat16, 8, 128, 256, "bottleneck_tail"),
    (torch.bfloat16, 16, 128, 640, "bottleneck_tail_rows"),
    (torch.bfloat16, 32, 128, 512, "bottleneck_tail_rows"),
    (torch.bfloat16, 16, 256, 1024, "bottleneck_tail_rows"),
    (torch.bfloat16, 8, 512, 2048, "bottleneck_tail_rows"),
    (torch.float32, 16, 128, 512, "bottleneck_tail_f32"),
    (torch.float32, 32, 128, 512, "bottleneck_tail_f32"),
])
def test_route(dtype, bs, cm, co, key):
    """The wgmma route holds (bs, Cm) of ``BF16_BLOCKS`` at Co a multiple
    of 256; every other bf16 block runs the row route, fp32 its own; each
    route is a key of ``kernels.launches``."""
    assert BT.route(dtype, bs, cm, co) == key
    assert key in kernels.launches


def test_row_entry_is_bf16():
    """The private entry that forces the row route refuses fp32 before it
    looks at the halo."""
    x = torch.zeros((1, 8, 8, 64))
    with pytest.raises(ValueError, match="bf16"):
        BT._bottleneck_tail_rows(x, x, None, None, None, None, None, None,
                                 None)


def test_rn50_block256_sites_per_frame(monkeypatch):
    """The kernel sites of one blocked frame of SwiftNet-RN50 at block 256
    (a 256x512 frame, capacity 1), routed on the CPU as on the card: 10 K1
    sites (bs, C): the stem's s2d planes, layer1's three 3x3s, the strided
    first blocks of layers 2-4 and the three upsample blends; 10 fused
    tails (bs, Cm, Co), layer2 blocks 1-3, layer3 1-5 and layer4 1-2, all
    on the bf16 row route.  ``chip_smoke.py`` phase 4b holds these counts
    at 1024x2048 on the card (``HALO_SHAPES_256``, ``TAIL_SHAPES_256``)."""
    from blockcopy_tpu_torch.tools.measure import swiftnet_stepper
    halo, tails = [], []
    real_halo, real_tail = TB.halo_gather_strips_kernel, TS.bottleneck_tail

    def record_halo(strips, idx, pad, *rest):
        halo.append((strips["cols"].shape[1], strips["cols"].shape[-1]))
        return real_halo(strips, idx, pad, *rest)

    def record_tail(h1, x, *rest):
        tails.append((h1.shape[1], h1.shape[-1], x.shape[-1]))
        return real_tail(h1, x, *rest)

    monkeypatch.setattr(TB, "halo_gather_strips_kernel", record_halo)
    monkeypatch.setattr(TS, "bottleneck_tail", record_tail)
    monkeypatch.setattr(TS, "FUSED_BOTTLENECK", None)   # port default: on
    shape = (1, 256, 512, 3)
    params, st = swiftnet_stepper("resnet50", shape, None, torch.bfloat16,
                                  "cpu", block_size=256)
    assert st.capacity == 1
    frame = torch.zeros(shape, dtype=torch.bfloat16)
    state = st.first_step(params, st.init_state(params, seed=1), frame)
    halo.clear()
    tails.clear()
    state = st.step(params, state, frame)
    assert halo == ([(64, 48)] + [(64, 64)] * 3
                    + [(64, 128), (32, 256), (16, 512), (16, 128),
                       (32, 128), (64, 128)])
    assert tails == ([(32, 128, 512)] * 3 + [(16, 256, 1024)] * 5
                     + [(8, 512, 2048)] * 2)
    assert {BT.route(torch.bfloat16, *t) for t in tails} == {
        "bottleneck_tail_rows"}
    assert bool(torch.isfinite(state["outputs"].float()).all())


def test_stepper_capacity_follows_the_grid():
    """``swiftnet_stepper``'s capacity is half the grid by default: 64 of 128
    blocks at 1024x2048 and block 128, 16 of 32 at block 256."""
    from blockcopy_tpu_torch.tools.measure import swiftnet_stepper
    for block, want in ((128, 64), (256, 16)):
        _, st = swiftnet_stepper("resnet18", (1, 1024, 2048, 3), None,
                                 torch.float32, "cpu", block_size=block)
        assert st.capacity == want
