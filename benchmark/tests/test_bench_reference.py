"""The plain reference against the served program on the CPU at a small
size (the program through its plain versions, float32, its policy
convolutions in float32 too): the blocked model, the policy, its grid,
its REINFORCE update and the detection decode agree to float32 rounding.
This is what makes the reference a reference for the blocked program."""

import pytest

from benchcell import run, tiny


@pytest.mark.parametrize("workload, length", [
    ("semseg-rn50-b128-t05", 7), ("det-csp-r50-b128-t03", 5),
    ("semseg-rn18-b128-t05", 7)])
def test_reference_follows_the_program(workload, length):
    out = run(tiny(workload, length))
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"], checks
    assert checks["out_gap"] < 1e-4
    assert checks["grid_gap"] == 0.0
    assert checks["grad_gap"] < 1e-3
    assert set(checks) >= {"out_gap", "grid_gap", "grad_gap"}
    if "box_gap" in checks:
        assert checks["box_gap"] == 0.0


def test_grid_gap_is_the_least_margin_that_explains_the_grid():
    """Against every assignment of samples, on small grids."""
    import itertools
    import numpy as np
    from reference.policy import grid_gap, select
    rs = np.random.RandomState(0)
    for _ in range(200):
        n, cap = 8, rs.randint(1, 8)
        p, u, u_rank = (rs.rand(n).astype(np.float32) for _ in range(3))
        grid = np.zeros(n, bool)
        grid[rs.choice(n, cap, replace=False)] = True
        on = u < p
        margin = np.abs(u.astype(np.float64) - p)
        best = 1.0
        for bits in itertools.product((False, True), repeat=n):
            f = np.array(bits)
            if np.array_equal(select(f.astype(np.float32), u_rank, cap),
                              grid):
                best = min(best, margin[f != on].max(initial=0.0))
        assert grid_gap(p, u, u_rank, grid, cap) == best
    # the draws' own selection reads 0; a grid of the wrong size reads 1
    assert grid_gap(p, u, u_rank, select(on.astype(np.float32), u_rank, 3),
                    3) == 0.0
    assert grid_gap(p, u, u_rank, np.ones(n, bool), 3) == 1.0
