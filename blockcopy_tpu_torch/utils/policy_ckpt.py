"""Policy-state persistence (counterpart of
``blockcopy_tpu/utils/policy_ckpt.py``).

The reference retrains the online policy from scratch in every run's
warmup; saving it amortizes that warmup.  Two layouts, both the JAX
package's flat npz (HWIO conv weights), so files move between the packages:

* ladder engine (``BlockCopyModel``): the policy's ``state()`` with
  ``net_params``, ``bn_state``, ``opt_state`` and ``running_cost`` (None
  stored as the -1.0 sentinel);
* fixed-capacity stepper, one replica: ``params``, ``bn_state``, ``opt``,
  ``running_cost``.

RMSprop state is ``{"square_avg", "momentum_buf"}`` here and a NamedTuple in
the JAX package, stored as ``.../0/...`` and ``.../1/...``.  A JAX file's
sampling ``key`` is not read: draws stay with the caller's generator.
"""

from __future__ import annotations

import os

import torch

from blockcopy_tpu_torch.policy.optim import tree_leaves
from blockcopy_tpu_torch.utils.checkpoint import load_npz, save_params


def _opt_out(opt):
    return [opt["square_avg"], opt["momentum_buf"]]


def _opt_in(pair):
    return {"square_avg": pair[0], "momentum_buf": pair[1]}


def _refuse_mesh(path: str, devices: int) -> None:
    if devices or os.path.isdir(path):
        raise NotImplementedError(
            "mesh-mode policy state (orbax directories, devices > 0) is not "
            "ported yet: ROADMAP Queue 1 item 13")


# -- ladder engine ----------------------------------------------------------

def save_ladder_policy(policy, path: str) -> None:
    state = policy.state()
    if not state:
        return
    rc = state["running_cost"]
    # explicit None check: a running cost of 0.0 must not become the sentinel
    save_params(path, {
        "net_params": state["net_params"],
        "bn_state": state["bn_state"],
        "opt_state": _opt_out(state["opt_state"]),
        "running_cost": torch.tensor(-1.0 if rc is None else rc,
                                     dtype=torch.float32),
    })


def load_ladder_policy(policy, path: str) -> None:
    like = policy.state()
    if not like:
        return
    _refuse_mesh(path, 0)
    loaded = load_npz(path, {
        "net_params": like["net_params"],
        "bn_state": like["bn_state"],
        "opt_state": _opt_out(like["opt_state"]),
        "running_cost": 0,
    }, device=tree_leaves(like["net_params"])[0].device)
    rc = float(loaded["running_cost"])
    policy.load_state({
        "net_params": loaded["net_params"],
        "bn_state": loaded["bn_state"],
        "opt_state": _opt_in(loaded["opt_state"]),
        "running_cost": None if rc < 0 else rc,
    })


# -- fixed-capacity stepper ---------------------------------------------------

def load_stepper_policy(path: str, pol, devices: int = 0):
    """The restored policy state for a stepper; ``pol`` is the current
    ``state["policy"]`` (the template, whose generator is kept).  A file
    in the ladder engine's naming loads too."""
    _refuse_mesh(path, devices)
    device = pol["running_cost"].device
    like = {"params": pol["params"], "bn_state": pol["bn_state"],
            "opt": _opt_out(pol["opt"]), "running_cost": 0}
    try:
        tr = load_npz(path, like, device=device)
    except KeyError:
        tr = load_npz(path, {"net_params": like["params"],
                             "bn_state": like["bn_state"],
                             "opt_state": like["opt"],
                             "running_cost": 0}, device=device)
        tr = {"params": tr["net_params"], "bn_state": tr["bn_state"],
              "opt": tr["opt_state"], "running_cost": tr["running_cost"]}
    return {**pol, "params": tr["params"], "bn_state": tr["bn_state"],
            "opt": _opt_in(tr["opt"]),
            "running_cost": tr["running_cost"].float()}


def save_stepper_policy(path: str, pol, devices: int = 0) -> None:
    _refuse_mesh(path, devices)
    save_params(path, {"params": pol["params"], "bn_state": pol["bn_state"],
                       "opt": _opt_out(pol["opt"]),
                       "running_cost": pol["running_cost"]})
