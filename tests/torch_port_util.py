"""Helpers shared by the ``test_torch_*`` files: move numpy/JAX values into
the port and compare the two packages' results."""

import jax
import numpy as np
import torch

from blockcopy_tpu_torch.utils.convert import to_numpy, to_torch
from torch_threads import two_torch_threads  # noqa: F401

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


# -- the two packages' steppers side by side ---------------------------------


def moving_square_frames(shape, count, seed=0):
    """Synthetic moving frames: a bright square sliding over fixed noise."""
    base = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    out = []
    for t in range(count):
        f = base.copy()
        s = 24 * t
        f[:, s:s + 96, s:s + 96] += 2.0
        out.append(f)
    return out


def stepper_draws(policy_state, probs_shape, total):
    """The uniforms the JAX stepper's ``step`` draws from this policy
    state's key (``stepper.py:456`` split, then ``:367-371``)."""
    _, k_use = jax.random.split(policy_state["key"])
    k1, k2 = jax.random.split(k_use)
    return (jax.random.uniform(k1, probs_shape),
            jax.random.uniform(k2, (total,)))


# -- the two packages' ladder engines side by side ---------------------------

ENGINE_H, ENGINE_W, ENGINE_BS = 256, 512, 128
_ENGINE_PARAMS = {}


def engine_pair(policy, backbone="resnet18", **kw):
    """The JAX and the port ``BlockCopyModel`` on the same parameters
    (``params_from_jax``), 256x512 frames, block 128, quantum 0.5 (ladder
    {4, 8}); ``kw`` are further settings."""
    from blockcopy_tpu.core.argparser import default_settings as jset
    from blockcopy_tpu.core.engine import BlockCopyModel as JModel
    from blockcopy_tpu.models import swiftnet as JS
    from blockcopy_tpu_torch.core.argparser import default_settings as tset
    from blockcopy_tpu_torch.core.engine import BlockCopyModel as TModel
    from blockcopy_tpu_torch.models import swiftnet as TS
    from blockcopy_tpu_torch.utils.convert import (params_from_jax,
                                                   params_to_numpy)

    if backbone not in _ENGINE_PARAMS:
        # drawn by the port (JAX's eager init is slow on the CPU), carried
        # to JAX through the converter's inverse
        tp = TS.init_swiftnet(TS.SwiftNetConfig(backbone=backbone), seed=0,
                              device="cpu")
        jp = jax.tree.map(jax.numpy.asarray, params_to_numpy(tp))
        _ENGINE_PARAMS[backbone] = (jp, params_from_jax(jtree(jp),
                                                        device="cpu"))
    jp, tp = _ENGINE_PARAMS[backbone]
    kw = dict(block_policy=policy, block_size=ENGINE_BS,
              block_quantize_number_exec=0.5, **kw)
    jm = JModel(JS.make_apply_fn(JS.SwiftNetConfig(backbone=backbone)), jp,
                jset(**kw))
    tm = TModel(TS.make_apply_fn(TS.SwiftNetConfig(backbone=backbone)), tp,
                tset(**kw), device="cpu")
    return jm, tm


def engine_clip(frames=4, n=1, seed=0):
    """A square moving through one corner over fixed noise."""
    base = np.random.RandomState(seed).randn(
        n, ENGINE_H, ENGINE_W, 3).astype(np.float32)
    out = []
    for t in range(frames):
        f = base.copy()
        f[:, 8 * t:8 * t + 40, 8 * t:8 * t + 40] += 3.0 * (t > 0)
        out.append(f)
    return out


def jax_draws(jm, n):
    """The numbers the JAX policy draws in its next ``forward`` for a batch
    of ``n`` (its key chain, ``policies.py:196-198`` and ``:266-273``), as
    the port's ``draws``; None where it draws none."""
    pol, meta = jm.policy, jm.policy_meta
    shape = (n, ENGINE_H // ENGINE_BS, ENGINE_W // ENGINE_BS)
    kind = type(pol).__name__
    if (kind == "PolicyRandom" and meta.get("outputs_prev") is not None) or \
            (kind == "PolicyTrainRL" and meta.get("outputs") is not None):
        _, sub = jax.random.split(pol.key)
        k1, k2 = jax.random.split(sub)
        first = jax.random.normal(k1, shape) if kind == "PolicyRandom" \
            else jax.random.uniform(k1, shape)
        return tt(first), tt(jax.random.uniform(k2, (int(np.prod(shape)),)))
    return None


def close_rel(ref, got, tol, msg=""):
    """Within ``tol`` relative, and ``tol`` of the largest |ref| absolute
    (random-init activations reach ~1e3)."""
    ref, got = npf(ref), npf(got)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale,
                               err_msg=msg)


def engine_frame(jm, tm, frame, t, tol=1e-4):
    """One frame through both engines, the port fed JAX's draws: grids and
    counts equal, outputs, ``frame_state`` and every canvas within
    ``tol``.  Returns the port's output."""
    draws = jax_draws(jm, frame.shape[0])
    ref = jm(jax.numpy.asarray(frame))
    got = tm(tt(frame), draws)
    jmeta, tmeta = jm.policy_meta, tm.policy_meta
    np.testing.assert_array_equal(npf(tmeta["grid"]), npf(jmeta["grid"]),
                                  err_msg=f"grid, frame {t + 1}")
    assert (tmeta["num_exec"], tmeta["perc_exec"]) == \
        (jmeta["num_exec"], jmeta["perc_exec"])
    close_rel(ref, got, tol, f"outputs, frame {t + 1}")
    close_rel(jmeta["frame_state"], tmeta["frame_state"], tol,
              f"frame_state, frame {t + 1}")
    jc, tc = jtree(jm.temporal["canvases"]), tm.temporal["canvases"]
    assert sorted(jc) == sorted(tc)
    assert_tree(jc, tc, lambda a, b, m: close_rel(
        a, b, tol, f"frame {t + 1} canvas{m}"))
    return got
