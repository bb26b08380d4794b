"""Helpers shared by the ``test_torch_*`` files: move numpy/JAX values into
the port and compare the two packages' results."""

import jax
import numpy as np
import torch

from blockcopy_tpu_torch.utils.convert import to_numpy, to_torch

# float tolerances of the JAX suite's own re-lowerings
# (tests/test_fused_bottleneck.py:72)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def tol(dtype) -> float:
    return TOL[np.dtype(dtype).name if not isinstance(dtype, torch.dtype)
               else str(dtype).split(".")[-1]]


def tt(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor, bit for bit (bf16 included)."""
    return to_torch(np.asarray(a), device="cpu")


def npf(x) -> np.ndarray:
    """JAX array or tensor as numpy; bf16 widens to fp32 exactly."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def jtree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_same(ref, got, msg=""):
    """Bitwise equality (after exact widening)."""
    np.testing.assert_array_equal(npf(got), npf(ref), err_msg=msg)


def assert_close(ref, got, rtol, atol=None, msg=""):
    np.testing.assert_allclose(npf(got), npf(ref), rtol=rtol,
                               atol=rtol if atol is None else atol,
                               err_msg=msg)


def assert_tree(ref, got, check, path=""):
    """Apply ``check(ref_leaf, got_leaf, msg)`` over two trees of the same
    structure (dicts by key, lists/tuples by position)."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), (path, sorted(ref), sorted(got))
        for k in ref:
            assert_tree(ref[k], got[k], check, f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_tree(a, b, check, f"{path}[{i}]")
    else:
        check(ref, got, path)
