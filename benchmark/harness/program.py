"""The system under test: the program's fixed-capacity stepper of a
configuration, built by the module its ``program`` key names
(``programs/``) as its CLI's speed mode builds it, driven through its CUDA
graphs (``core/graphs.py`` ``StepperGraphs``), or on clip-parallel ranks
through ``parallel/clip_parallel.py``.  What the benchmark reads back
here: the policy's state (the served outputs and grid are the module's
``served``)."""

from __future__ import annotations

from typing import Dict

import torch

import programs
from reference.policy import flatten


def make_stepper(cfg: Dict, block_size: int, device):
    """The configuration's stepper (its program module's ``stepper``) over
    one stream of the cell's frames, at the capacity its target gives."""
    from blockcopy_tpu_torch.core.stepper import StepperConfig
    gh, gw = cfg["height"] // block_size, cfg["width"] // block_size
    capacity = max(1, int(round(cfg["target"] * gh * gw)))
    scfg = StepperConfig(
        block_size=block_size, block_target=cfg["target"],
        complexity_weight=cfg["complexity_weight"],
        cost_momentum=cfg["cost_momentum"],
        train_interval=cfg["train_interval"], lr=cfg["lr"],
        weight_decay=cfg["weight_decay"], momentum=cfg["momentum"],
        num_classes=cfg["num_classes"] if cfg["task"] == "semseg"
        else cfg["num_classes"] - 1,
        policy_arch=cfg["policy_arch"])
    shape = (1, cfg["height"], cfg["width"], 3)
    return programs.of(cfg).stepper(cfg, scfg, shape, capacity,
                                    getattr(torch, cfg["dtype"]), device)


def build(cfg: Dict, block_size: int, params, device, group=None,
          policy_seed: int = 1):
    """(stepper, state, first_step, step)."""
    stepper = make_stepper(cfg, block_size, device)
    if group is None:
        from blockcopy_tpu_torch.core.graphs import StepperGraphs
        state = stepper.init_state(params, seed=policy_seed)
        graphs = StepperGraphs(stepper)
        first, step = graphs.first_step, graphs.step
    else:
        from blockcopy_tpu_torch.parallel import clip_parallel
        state = clip_parallel.init_parallel_state(stepper, params,
                                                  policy_seed, group.rank)
        first, step = clip_parallel.build_parallel_steps(stepper, group)
    return stepper, state, first, step


def policy_tensors(state) -> Dict[str, torch.Tensor]:
    """The policy's carried tensors by path: ``params/...``,
    ``sq/...`` (RMSprop square averages), ``buf/...`` (its momentum
    buffers) and ``running_cost``."""
    pol = state["policy"]
    out = {f"params/{k}": v for k, v in flatten(pol["params"]).items()}
    out.update({f"sq/{k}": v for k, v in
                flatten(pol["opt"]["square_avg"]).items()})
    out.update({f"buf/{k}": v for k, v in
                flatten(pol["opt"]["momentum_buf"]).items()})
    out["running_cost"] = pol["running_cost"]
    return out


def load_policy(state, values: Dict[str, torch.Tensor]) -> None:
    """Copy ``values`` (``policy_tensors``' paths) into the state's own
    tensors, which the graphs hold."""
    own = policy_tensors(state)
    if set(own) != set(values):
        raise KeyError(f"policy paths differ: "
                       f"{sorted(set(own) ^ set(values))}")
    with torch.no_grad():
        for k, v in values.items():
            own[k].copy_(v)
