"""The clip-parallel cell's path on the CPU: two gloo ranks through the
program's launcher (``parallel/clip_parallel.py``), one clip a rank, the
window's end agreed, the reference averaging its gradients over the
ranks; and the two faults only ranks can have, planted in the program's
gradient average: the exchange left out, and half the ranks left out of
the mean."""

import pytest

from benchcell import run_ranks, serve_as_rank


def _exchange_left_out():
    from blockcopy_tpu_torch.parallel.distributed import Group
    Group.mean_tree = lambda self, tree: tree


def _half_the_ranks():
    from blockcopy_tpu_torch.parallel.distributed import Group
    from blockcopy_tpu_torch.policy.optim import tree_map
    orig = Group.mean_tree

    def half(self, tree):
        keep = 1.0 if self.rank < self.size // 2 else 0.0
        out = orig(self, tree_map(lambda v: v * keep, tree))
        return tree_map(lambda v: v * 2.0, out)
    Group.mean_tree = half


def test_two_ranks_are_correct():
    out, _ = run_ranks(serve_as_rank)
    assert out["correct"], out["checks"]
    assert out["checks"]["rank_gap"]["value"] == 0.0
    assert out["attempted"] % 2 == 0


@pytest.mark.parametrize("fault", [_exchange_left_out, _half_the_ranks],
                         ids=["exchange", "half"])
def test_a_rank_fault_is_not_correct(fault):
    out, _ = run_ranks(serve_as_rank, fault)
    assert out["correct"] is False, out["checks"]
