"""The control: the reference in the program's place, computed in the
precision below the configuration's (SwiftNet's bf16 -> fp8, CSP's fp32
with TF32 -> bf16, the policy's bf16 -> fp8), must come out not correct.
At a size a test run holds on the CPU; the same at the cells' own size on the card (marked
``cuda``, three seeds a cell)."""

import pytest
import torch

from benchcell import SEED, tiny
from harness.check import limits, verdict


@pytest.mark.parametrize("workload", ["semseg-rn50-b128-t05",
                                      "det-csp-r50-b128-t03",
                                      "semseg-rn18-b128-t05"])
def test_control_is_not_correct(workload):
    from calibrate import control_gaps
    cell = tiny(workload, 8)
    cell.cfg["dtype"] = "bfloat16" if cell.cfg["precision"]["model"] == \
        "bf16" else "float32"
    gaps = control_gaps(cell, SEED, torch.device("cpu"))
    ok, lines = verdict(gaps, limits(workload))
    assert not ok, lines


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["semseg-rn50-b128-t05",
                                      "det-csp-r50-b128-t03",
                                      "semseg-rn50-b256-t05",
                                      "semseg-rn18-b128-t05"])
def test_control_is_not_correct_at_full_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from calibrate import control_gaps
    from harness import cell as cells
    cell = cells.load(workload)
    for seed in (2 ** 40 + 101, 2 ** 40 + 102, 2 ** 40 + 103):
        gaps = control_gaps(cell, seed, torch.device("cuda", 0))
        ok, lines = verdict(gaps, limits(workload))
        assert not ok, lines
