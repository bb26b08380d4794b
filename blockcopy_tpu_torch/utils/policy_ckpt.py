"""Policy-state persistence (counterpart of
``blockcopy_tpu/utils/policy_ckpt.py``).

The reference retrains the online policy from scratch in every run's
warmup; saving it amortizes that warmup.  Three layouts; the npz files are
the JAX package's flat npz (HWIO conv weights), so they move between the
packages:

* ladder engine (``BlockCopyModel``): the policy's ``state()`` with
  ``net_params``, ``bn_state``, ``opt_state`` and ``running_cost`` (None
  stored as the -1.0 sentinel);
* fixed-capacity stepper, one replica: ``params``, ``bn_state``, ``opt``,
  ``running_cost``.  In clip-parallel (mesh) mode an ``.npz`` path holds
  this too: rank 0 saves it (the ranks share their parameters), every rank
  loads it and keeps its own generator;
* fixed-capacity stepper, mesh mode, any other path: a directory of one
  ``rank<r>.npz`` per rank, each with that rank's whole policy state
  (its own ``bn_state`` and running cost too) and its generator's state
  under ``generator_state``; each rank saves and restores its own file.
  This stands where the JAX package writes an orbax directory of the
  mesh-stacked state; the port refuses orbax directories
  (``utils/checkpoint.py`` ``refuse_orbax``).

RMSprop state is ``{"square_avg", "momentum_buf"}`` here and a NamedTuple in
the JAX package, stored as ``.../0/...`` and ``.../1/...``.  A JAX file's
sampling ``key`` is not read: draws stay with the caller's generator.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from blockcopy_tpu_torch.policy.optim import tree_leaves
from blockcopy_tpu_torch.utils.checkpoint import (load_npz, refuse_orbax,
                                                  save_params)


def _opt_out(opt):
    return [opt["square_avg"], opt["momentum_buf"]]


def _opt_in(pair):
    return {"square_avg": pair[0], "momentum_buf": pair[1]}


def rank_file(path: str, rank: int) -> str:
    """Rank ``rank``'s file of a mesh-mode policy directory."""
    return os.path.join(path, f"rank{rank}.npz")


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
    refuse_orbax(path)
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: ladder-engine policy "
                         f"state is one .npz file")
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

def load_stepper_policy(path: str, pol, rank: int = 0):
    """The restored policy state for a stepper; ``pol`` is the current
    ``state["policy"]`` (the template).  From an npz (one replica; a file
    in the ladder engine's naming loads too) the template's generator is
    kept; from a mesh-mode directory rank ``rank``'s file is read, its
    generator state included."""
    refuse_orbax(path)
    directory = os.path.isdir(path)
    if directory:
        path = rank_file(path, rank)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no policy state for rank {rank}: "
                                    f"{path} is missing")
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
    generator = pol["generator"]
    if directory:
        with np.load(path) as data:
            state = torch.from_numpy(data["generator_state"].copy())
        generator = torch.Generator(generator.device)
        generator.set_state(state)
    return {**pol, "params": tr["params"], "bn_state": tr["bn_state"],
            "opt": _opt_in(tr["opt"]),
            "running_cost": tr["running_cost"].float(),
            "generator": generator}


def save_stepper_policy(path: str, pol, devices: int = 0,
                        rank: int = 0) -> None:
    """Save a stepper's policy state.  ``devices`` > 0 is mesh mode with
    this process as rank ``rank``: a non-``.npz`` path is a directory of
    one file per rank, an ``.npz`` path rank 0's replica.  A path that is
    a directory already takes the directory layout in any mode."""
    tree = {"params": pol["params"], "bn_state": pol["bn_state"],
            "opt": _opt_out(pol["opt"]),
            "running_cost": pol["running_cost"]}
    refuse_orbax(path)
    if (devices or os.path.isdir(path)) and not path.endswith(".npz"):
        os.makedirs(path, exist_ok=True)
        tree["generator_state"] = pol["generator"].get_state()
        save_params(rank_file(path, rank), tree)
    elif rank == 0:
        save_params(path, tree)
