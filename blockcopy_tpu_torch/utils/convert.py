"""Convert the JAX package's parameters, carried state and detection train
state into the port's, and back for comparisons.

Inputs are numpy pytrees: nested dicts, lists and tuples (the JAX RMSprop
state is a NamedTuple) of ``np.ndarray``, as ``jax.tree.map(np.asarray, t)``
gives them, so this module never imports JAX.  bfloat16 arrays (the
``ml_dtypes`` dtype numpy reports as ``bfloat16``) are carried bit for bit.

Layout rules: every conv weight (a 4-D ``"w"`` leaf) is HWIO in JAX and OIHW
here, except the CSP neck's transposed convs (``neck.p3/p4/p5.w``), whose
HWIO kernel (I = in, O = out) becomes torch's (in, out, kh, kw) with no
flip; everything else (folded BN, biases, GN, BN statistics, 0-d scales,
canvases in NHWC block layout) keeps its shape.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from blockcopy_tpu_torch.device import resolve_device


def to_torch(a, device=None) -> torch.Tensor:
    """One numpy array (bf16 included) as a tensor on ``device``: ``None``
    means CUDA, and raises where it is absent (``device.resolve_device``).
    A tensor given with ``device=None`` stays where it is."""
    if isinstance(a, torch.Tensor) and device is None:
        return a
    device = resolve_device(device)
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 widens to fp32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _map(tree, fn, path=()):
    """Map ``fn(leaf, path)`` over a tree; ``path`` holds the dict keys
    from the root (list positions are not part of it)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, path) for v in tree]
    return fn(tree, path)


# HWIO -> the port's layout, by the leaf's path: (in, out, kh, kw) for the
# CSP neck's transposed convs, OIHW for every other 4-D "w"
_TRANSPOSED = {("neck", p, "w") for p in ("p3", "p4", "p5")}


def _to_port(path) -> tuple:
    return (2, 3, 0, 1) if path[-3:] in _TRANSPOSED else (3, 2, 0, 1)


def _to_jax(path) -> tuple:
    return (2, 3, 0, 1) if path[-3:] in _TRANSPOSED else (2, 3, 1, 0)


def params_from_jax(tree, device=None):
    """SwiftNet, CSP or policy parameters (or any tree shaped like them,
    such as RMSprop moments): HWIO conv weights -> the port's layout, on
    ``device`` (``None``: CUDA, as ``to_torch``)."""
    def conv(a, path):
        t = to_torch(a, device)
        return t.permute(*_to_port(path)).contiguous() \
            if path[-1:] == ("w",) and t.dim() == 4 else t
    return _map(tree, conv)


def params_to_numpy(tree):
    """Inverse of ``params_from_jax``: back to HWIO numpy (bf16 as
    fp32)."""
    def conv(t, path):
        a = to_numpy(t)
        return a.transpose(*_to_jax(path)) \
            if path[-1:] == ("w",) and a.ndim == 4 else a
    return _map(tree, conv)


def policy_state_from_jax(pol: Dict, device=None) -> Dict:
    """The JAX stepper's ``state["policy"]`` (minus its PRNG key) as the
    port's: params, ``bn_state``, RMSprop state, ``running_cost``."""
    square_avg, momentum_buf = pol["opt"]
    return {
        "params": params_from_jax(pol["params"], device),
        "bn_state": params_from_jax(pol["bn_state"], device),
        "opt": {"square_avg": params_from_jax(square_avg, device),
                "momentum_buf": params_from_jax(momentum_buf, device)},
        "running_cost": to_torch(pol["running_cost"], device),
    }


def ladder_policy_state_from_jax(state: Dict, device=None) -> Dict:
    """The JAX ``PolicyTrainRL.state()`` (numpy leaves; ``running_cost`` a
    host float or None) as the port policy's ``load_state`` input; the
    JAX ``key`` is dropped."""
    square_avg, momentum_buf = state["opt_state"]
    rc = state["running_cost"]
    return {
        "net_params": params_from_jax(state["net_params"], device),
        "bn_state": params_from_jax(state["bn_state"], device),
        "opt_state": {"square_avg": params_from_jax(square_avg, device),
                      "momentum_buf": params_from_jax(momentum_buf, device)},
        "running_cost": None if rc is None else float(rc),
    }


_STEPPER_KEYS = ("canvases", "prev_grid", "frame_idx", "policy")


def _task_keys(state: Dict):
    """The task outputs a stepper state carries (each key of the task's
    ``task_keys`` and its ``_prev`` copy): every key but the stepper's
    own."""
    return [k for k in state if k not in _STEPPER_KEYS]


def stepper_state_from_jax(state: Dict, device=None) -> Dict:
    """Carried stepper state: canvases by name (tensors or strip dicts),
    the task outputs, ``prev_grid``, ``frame_idx`` (a host int here) and the
    policy state.  The port's ``generator`` is not part of the JAX state;
    the caller adds it."""
    out = {
        "canvases": _map(state["canvases"],
                         lambda a, _: to_torch(a, device)),
        "prev_grid": to_torch(state["prev_grid"], device),
        "frame_idx": int(np.asarray(state["frame_idx"])),
        "policy": policy_state_from_jax(state["policy"], device),
    }
    for key in _task_keys(state):
        out[key] = to_torch(state[key], device)
    return out


def stepper_state_to_numpy(state: Dict) -> Dict:
    """Inverse of ``stepper_state_from_jax`` for comparisons: the same
    structure as the JAX state's numpy tree (no key or generator)."""
    pol = state["policy"]
    out = {
        "canvases": _map(state["canvases"], lambda t, _: to_numpy(t)),
        "prev_grid": to_numpy(state["prev_grid"]),
        "frame_idx": np.int32(state["frame_idx"]),
        "policy": {
            "params": params_to_numpy(pol["params"]),
            "bn_state": params_to_numpy(pol["bn_state"]),
            "opt": (params_to_numpy(pol["opt"]["square_avg"]),
                    params_to_numpy(pol["opt"]["momentum_buf"])),
            "running_cost": to_numpy(pol["running_cost"]),
        },
    }
    for key in _task_keys(state):
        out[key] = to_numpy(state[key])
    return out


_TRAIN_TREES = ("params", "ema_params", "m", "v")


def train_state_from_jax(state: Dict, device=None) -> Dict:
    """The JAX detection train state ``{params, ema_params, m, v, step}``
    as the port's: the four trees by the parameters' layout rule (the
    path-tail rule covers ``m/neck/p3/w`` as well) on ``device``, ``step``
    a 0-d int32 tensor on the CPU (``tasks/detection/train.py``)."""
    out = {k: params_from_jax(state[k], device) for k in _TRAIN_TREES}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32)
    return out


def train_state_to_numpy(state: Dict) -> Dict:
    """Inverse of ``train_state_from_jax``, for comparisons and saving."""
    out = {k: params_to_numpy(state[k]) for k in _TRAIN_TREES}
    out["step"] = np.int32(int(state["step"]))
    return out
