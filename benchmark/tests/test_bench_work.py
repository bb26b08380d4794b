"""The benchmark's work counts: K1's and K2's bytes and operations and
the card's peaks as ``chip_smoke.py`` has them, the launches K1 and K2
make per configuration and block size, and the MAC count; and, pinned,
the model every cell of ResNet-50 reads: its weights, MACs and tails as
they stood before the reference took its backbone from the
configuration."""

import hashlib
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
import reference
from harness.cell import BENCH
from harness.weights import _leaves, realize
from harness.window import model_spec
from reference import nets
from work import k1, k2, macs, peaks


def cfg(name, **change):
    return dict(json.loads((BENCH / "configs" / f"{name}.json").read_text()),
                **change)


SEMSEG, DET = "swiftnet-rn50-cityscapes", "csp-r50-citypersons"
RN18 = "swiftnet-rn18-cityscapes"


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("k", [1, 8, 38, 64, 128])
def test_tail_cost_is_chip_smokes(itemsize, k):
    for bs, cm, co in set(chip_smoke.TAIL_SHAPES + chip_smoke.TAIL_SHAPES_256
                          + chip_smoke.WIDE_TAIL_SHAPES):
        assert k2.tail_cost(bs, cm, co, itemsize, k) == \
            chip_smoke.tail_cost(bs, cm, co, itemsize, k=k)


def test_peaks_are_chip_smokes():
    assert peaks.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert peaks.BF16_FLOPS == chip_smoke.BF16_FLOPS
    assert peaks.TF32_FLOPS == chip_smoke.TF32_FLOPS
    assert peaks.flops_for("bfloat16") == 989e12
    assert peaks.flops_for("float32") == 495e12


@pytest.mark.parametrize("name, bs, shapes", [
    (SEMSEG, 128, chip_smoke.TAIL_SHAPES),
    (SEMSEG, 256, chip_smoke.TAIL_SHAPES_256),
    (DET, 128, chip_smoke.DET_TAIL_SHAPES)])
def test_tails_per_configuration(name, bs, shapes):
    assert k2.tails(cfg(name), bs) == shapes


@pytest.mark.parametrize("backbone, shapes", [
    ("wide_resnet50_2", chip_smoke.WIDE_TAIL_SHAPES), ("resnet18", []),
    ("resnet34", []), ("resnext50_32x4d", []), ("resnext101_32x8d", [])])
def test_tails_follow_the_backbone(backbone, shapes):
    """Basic blocks and grouped 3x3s are out of K2's reach."""
    assert k2.tails(cfg(SEMSEG, backbone=backbone), 128) == shapes


def test_resnet18_has_no_tails():
    assert k2.tails(cfg(RN18), 128) == k2.tails(cfg(RN18), 256) == []


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("k", [1, 8, 38, 64, 128])
def test_halo_bytes_are_chip_smokes(itemsize, k):
    shapes = set(chip_smoke.DET_HALO_SHAPES) | {
        (bs, c, 1) for bs, c in chip_smoke.HALO_SHAPES
        + chip_smoke.HALO_SHAPES_256 + chip_smoke.PIECE_SHAPES}
    for bs, c, p in shapes:
        assert k1.halo_bytes(bs, c, p, itemsize, k) == \
            chip_smoke.halo_bytes(bs, c, p, itemsize, k=k)
        assert k1.pieces_bytes(bs, c, p, itemsize, k) == \
            chip_smoke.pieces_bytes(bs, c, p, itemsize, k=k)


@pytest.mark.parametrize("name, bs, gather, pieces", [
    (SEMSEG, 128, [(b, c, 1) for b, c in chip_smoke.HALO_SHAPES],
     chip_smoke.PIECE_SHAPES),
    (SEMSEG, 256, [(b, c, 1) for b, c in chip_smoke.HALO_SHAPES_256],
     chip_smoke.PIECE_SHAPES_256),
    (DET, 128, chip_smoke.DET_HALO_SHAPES, chip_smoke.PIECE_SHAPES)])
def test_k1_launches_are_chip_smokes(name, bs, gather, pieces):
    assert k1.launches(cfg(name), bs) == {
        "gather": gather, "pieces": [(b, c, 1) for b, c in pieces]}


@pytest.mark.parametrize("workload", ["semseg-rn18-b128-t05",
                                      "semseg-rn50-b128-t05"])
def test_k1_launches_are_the_programs(monkeypatch, workload):
    """The halo exchanges the served program makes at the tiny size on
    the CPU (where K2's gate lets stage 2 through at 8 px and stops stage
    3 at 4), one frame's list after another; its shape pass, which fuses
    nothing, left out."""
    from benchcell import run, spy_k1, tiny
    seen = spy_k1(monkeypatch)
    cell = tiny(workload, 4)
    run(cell, seconds=0.01)
    want = k1.launches(cell.cfg, cell.traffic["block_size"])
    frames = len(seen["pieces"]) // len(want["pieces"])
    assert frames >= 4
    for kind in ("gather", "pieces"):
        assert seen[kind] == want[kind] * frames


def test_k1_launches_of_resnet18():
    """The stem's two, layer1's four 3x3s at 32 px, two stages of four
    3x3s at each lower stride (the first strided, at its input's size),
    the three blends: 20 gathers and the stem pool's pieces (PERF.md's
    kernel table: 240 K1 launches in 12 RN18 frames)."""
    got = k1.launches(cfg(RN18), 128)
    assert got["gather"] == [(32, 48, 1)] + [(32, 64, 1)] * 5 \
        + [(16, 128, 1)] * 4 + [(8, 256, 1)] * 4 + [(4, 512, 1)] * 3 \
        + [(8, 128, 1), (16, 128, 1), (32, 128, 1)]
    assert got["pieces"] == [(32, 256, 1)]
    # K = 64 bf16: the bytes' bound of a frame
    assert k1.bound_s(cfg(RN18), 128, 64) == pytest.approx(7.5277e-5,
                                                           rel=1e-4)
    assert k1.bound_s(cfg(SEMSEG), 128, 64) == pytest.approx(6.3616e-5,
                                                             rel=1e-4)


def test_k2_bound_at_the_main_path():
    # PERF.md's kernel table: 0.0705 ms a semseg frame at K = 64, 0.0841 a
    # block-256 frame at K = 16
    assert k2.bound_s(cfg(SEMSEG), 128, 64) == pytest.approx(7.047e-5,
                                                             rel=1e-3)
    assert k2.bound_s(cfg(SEMSEG), 256, 16) == pytest.approx(8.407e-5,
                                                             rel=1e-3)
    assert k2.launches_per_tail("float32") == 2


@pytest.mark.parametrize("name, bs, backbone", [
    (SEMSEG, 128, None), (SEMSEG, 256, None), (DET, 128, None),
    (RN18, 128, None), (RN18, 128, "resnext101_32x8d"),
    (RN18, 128, "wide_resnet50_2")])
def test_macs_at_all_blocks_are_the_dense_count(name, bs, backbone):
    c = cfg(name) if backbone is None else cfg(name, backbone=backbone)
    total = (c["height"] // bs) * (c["width"] // bs)
    forward, spec = reference.model(c)
    grid = torch.ones((c["height"] // bs, c["width"] // bs),
                      dtype=torch.bool, device="meta")
    x = torch.empty((1, 3, c["height"], c["width"]), device="meta")
    with FlopCounterMode(display=False) as fc:
        forward(nets.Frame(grid, {}), macs._meta(spec(c)), x, c)
    dense = fc.get_total_flops() / 2
    m = macs.frame_macs(c, bs, total)
    assert m["first"] == pytest.approx(dense, rel=1e-12)
    pol = macs.policy_macs(c, bs)
    assert m["plain"] == pytest.approx(dense + pol, rel=1e-12)
    assert m["train"] == pytest.approx(dense + 3 * pol, rel=1e-12)


def test_macs_scale_with_executed_blocks():
    c = cfg(SEMSEG)
    tally = macs.model_tally(c, 128)
    blocked = sum(v for v, b in tally.values() if b)
    dense = sum(v for v, b in tally.values() if not b)
    m = macs.frame_macs(c, 128, 64)
    assert m["plain"] - macs.policy_macs(c, 128) == pytest.approx(
        blocked / 2 + dense)
    # SPP is the dense part; the decoder and backbone run over blocks
    assert {k for k, (_, b) in tally.items() if not b} == {
        "spp.bn", "spp.level0", "spp.level1", "spp.level2", "spp.fuse"}


# What the cells of ResNet-50 read, as the benchmark had it before its
# reference took the backbone from the configuration: a digest of the
# weights drawn from seed 12345 (paths and float32 values, in the draw's
# order), and MACs and tails at the cells' block sizes and capacities.
PINNED = {
    SEMSEG: {
        "digest": "e3d5da25558ac3e9eba0dd052e650350649aced7e59d4ac40176247f"
                  "eb610d70",
        "params": 24502991,
        "macs": {128: (64, 204632082432.0, 110151337984.0, 125217572864.0),
                 256: (16, 204632082432.0, 104501499904.0, 108268058624.0)},
        "tails": {128: [(16, 128, 512)] * 3 + [(8, 256, 1024)] * 5,
                  256: [(32, 128, 512)] * 3 + [(16, 256, 1024)] * 5
                  + [(8, 512, 2048)] * 2}},
    DET: {
        "digest": "eee7472cd32fbaee36d6a7a7d93fc06065971442b563219ae80c2331"
                  "9133d5ac",
        "params": 43508806,
        "macs": {128: (38, 1128200667136.0, 341788213248.0, 355495493632.0),
                 256: (16, 1128200667136.0, 565813743616.0,
                       569240563712.0)},
        "tails": {128: [(16, 128, 512)] * 3 + [(8, 256, 1024)] * 5,
                  256: [(32, 128, 512)] * 3 + [(16, 256, 1024)] * 5}},
}


@pytest.mark.parametrize("name", [SEMSEG, DET])
def test_weights_are_pinned(name):
    tree = realize(model_spec(cfg(name)), 12345, torch.float32, "cpu")
    h, count = hashlib.sha256(), 0
    for path, t in _leaves(tree):
        h.update(path.encode())
        h.update(t.contiguous().numpy().tobytes())
        count += t.numel()
    assert (h.hexdigest(), count) == (PINNED[name]["digest"],
                                      PINNED[name]["params"])


@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("name", [SEMSEG, DET])
def test_macs_and_tails_are_pinned(name, bs):
    k, first, plain, train = PINNED[name]["macs"][bs]
    assert macs.frame_macs(cfg(name), bs, k) == {
        "first": first, "plain": plain, "train": train}
    assert k2.tails(cfg(name), bs) == PINNED[name]["tails"][bs]
