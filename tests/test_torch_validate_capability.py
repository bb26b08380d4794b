"""The port's semseg validation tool
(``blockcopy_tpu_torch/tools/validate_capability.py``): its clips against
the root ``tools/validate_capability.py``, its moving-block count pinned
where it counts a block past the box, and a tiny end-to-end run on the
CPU."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from blockcopy_tpu_torch.tools import validate_capability as TV
from torch_port_util import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def JV():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_capability", ROOT / "tools" / "validate_capability.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("index,frames,h,w,amp", [
    (0, 4, 192, 256, 2.5), (7, 3, 256, 512, 8.0),
    (10_001, 10, 512, 1024, 2.5)])
def test_make_clip_bitwise(JV, index, frames, h, w, amp):
    clip, tracks = TV.make_clip(index, frames, h, w, amp=amp)
    rclip, rtracks = JV.make_clip(index, frames, h, w, amp=amp)
    assert tracks == rtracks and len(clip) == frames
    for a, b in zip(clip, rclip):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _jax_count(grid, boxes, bs):
    """The JAX tool's inline loop (``tools/validate_capability.py``)."""
    hits, total = 0, 0
    for (y, x0) in boxes:
        for gy in range(y // bs, min((y + 140) // bs + 1, grid.shape[0])):
            for gx in range(x0 // bs, min((x0 + 140) // bs + 1,
                                          grid.shape[1])):
                total += 1
                hits += int(grid[gy, gx])
    return hits, total


def test_moving_block_count_pinned():
    """y + 140 = 256 is a block border at bs 128: rows 116-255 lie in block
    rows 0-1, and the count takes row 2 as well (JAX's bound, kept)."""
    grid = np.zeros((4, 8), bool)
    grid[2, :] = True                    # only the block row past the box
    grid[0, 1] = True
    assert TV.moving_block_hits(grid, [(116, 0)], 128) == (3, 6)
    # one row less: y + 140 = 240 ends inside block row 1
    assert TV.moving_block_hits(grid, [(100, 0)], 128) == (1, 4)
    # clipped at the grid's edge (block rows 2-3, column 7 only), and two
    # boxes at once
    boxes = [(116, 0), (372, 900)]
    assert TV.moving_block_hits(grid, boxes, 128) == (3 + 1, 6 + 2)
    rs = np.random.RandomState(0)
    for _ in range(20):
        g = rs.rand(4, 8) < 0.5
        b = [(int(rs.randint(0, 352)), int(rs.randint(0, 864)))
             for _ in range(2)]
        assert TV.moving_block_hits(g, b, 128) == _jax_count(g, b, 128)


def test_tool_end_to_end_tiny(tmp_path, capsys):
    """RN18 at 256x512 (2 x 4 blocks of 128; make_clip's offsets need sides
    above 160 px), 1 + 1 clips of 3 frames: the keys of the JAX record,
    rates in [0, 1], frames 0-1 skipped, ``--out`` writes only where told."""
    out = tmp_path / "v.json"
    res = TV.main(["--device", "cpu", "--height", "256", "--width", "512",
                   "--warmup-clips", "1", "--eval-clips", "1",
                   "--clip-length", "3", "--out", str(out)])
    record = json.loads((ROOT / "VALIDATION.json").read_text())
    assert list(res) == list(record)
    assert json.loads(out.read_text()) == res
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == res
    for key in ("exec_rate_final_mean", "running_cost",
                "agreement_vs_dense", "agreement_frozen_baseline",
                "moving_block_exec_rate"):
        assert 0 <= res[key] <= 1, key
    assert res["frames_evaluated"] == 1 and res["gmacs_per_image"] > 0
    assert (res["target"], res["policy_arch"], res["backbone"]) == (
        0.5, "ref", "resnet18")
    # no file by default: the root VALIDATION*.json are JAX's records
    assert TV.build_argparser().parse_args([]).out == ""


def test_tool_refuses_small_frames():
    with pytest.raises(ValueError, match="160"):
        TV.main(["--device", "cpu", "--height", "128", "--width", "256"])
