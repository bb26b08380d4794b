"""The benchmark's work counts: K2's operations and bytes and the card's
peaks as ``chip_smoke.py`` has them, the tails K2 computes per
configuration and block size, and the MAC count."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
from harness.cell import BENCH
from reference import nets
from work import k2, macs, peaks


def cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


SEMSEG, DET = "swiftnet-rn50-cityscapes", "csp-r50-citypersons"


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


def test_k2_bound_at_the_main_path():
    # PERF.md's kernel table: 0.0705 ms a semseg frame at K = 64, 0.0841 a
    # block-256 frame at K = 16
    assert k2.bound_s(cfg(SEMSEG), 128, 64) == pytest.approx(7.047e-5,
                                                             rel=1e-3)
    assert k2.bound_s(cfg(SEMSEG), 256, 16) == pytest.approx(8.407e-5,
                                                             rel=1e-3)
    assert k2.launches_per_tail("float32") == 2


@pytest.mark.parametrize("name, bs", [(SEMSEG, 128), (SEMSEG, 256),
                                      (DET, 128)])
def test_macs_at_all_blocks_are_the_dense_count(name, bs):
    c = cfg(name)
    total = (c["height"] // bs) * (c["width"] // bs)
    spec = nets.spec_csp(c) if c["task"] == "detection" \
        else nets.spec_swiftnet(c)
    grid = torch.ones((c["height"] // bs, c["width"] // bs),
                      dtype=torch.bool, device="meta")
    x = torch.empty((1, 3, c["height"], c["width"]), device="meta")
    with FlopCounterMode(display=False) as fc:
        (nets.csp if c["task"] == "detection" else nets.swiftnet)(
            nets.Frame(grid, {}), macs._meta(spec), x, c)
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
