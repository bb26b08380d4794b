"""The system under test: the program's fixed-capacity stepper of a
configuration, built as its CLIs' speed mode builds it, driven through its
CUDA graphs (``core/graphs.py`` ``StepperGraphs``), or on clip-parallel
ranks through ``parallel/clip_parallel.py``.  What the benchmark reads
back: the served outputs, the grid, the policy's state."""

from __future__ import annotations

from typing import Dict

import torch

from reference.policy import flatten


def build(cfg: Dict, block_size: int, params, device, group=None,
          policy_seed: int = 1):
    """(stepper, state, first_step, step)."""
    from blockcopy_tpu_torch.core.stepper import (FixedCapacityStepper,
                                                  StepperConfig)
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
    dtype = getattr(torch, cfg["dtype"])
    if cfg["task"] == "semseg":
        from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                         make_apply_fn)
        mcfg = SwiftNetConfig(backbone=cfg["backbone"],
                              num_classes=cfg["num_classes"],
                              num_features=cfg["num_features"],
                              spp_grids=tuple(cfg["spp_grids"]),
                              spp_levels=cfg["spp_levels"])
        stepper = FixedCapacityStepper(make_apply_fn(mcfg), scfg, shape,
                                       capacity, dtype=dtype, device=device)
    else:
        from blockcopy_tpu_torch.models.csp import CSPConfig
        from blockcopy_tpu_torch.tasks.detection.stepper import \
            DetectionStepper
        keys = ("strides", "dilations", "neck_out", "head_feat",
                "stacked_convs", "num_classes", "head_stride", "wh_ratio",
                "l2norm_scale", "gn_groups", "nms_pre", "score_thr",
                "nms_iou", "max_per_img")
        mcfg = CSPConfig(**{k: tuple(cfg[k]) if isinstance(cfg[k], list)
                            else cfg[k] for k in keys})
        stepper = DetectionStepper(mcfg, scfg, shape, capacity, dtype=dtype,
                                   device=device)
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


def served(state, detection: bool) -> Dict[str, torch.Tensor]:
    """The state's tensors that hold the frame's served outputs and grid
    (views, no copy): semseg ``outputs`` (N, H/4, W/4, C); detection the
    three maps' canvases (block layout) and ``dets``, ``labels``,
    ``valid``; and ``prev_grid``."""
    out = {"grid": state["prev_grid"]}
    if not detection:
        out["outputs"] = state["outputs"]
        return out
    for k in ("csp_cls", "csp_reg", "csp_offset"):
        out[k] = state["canvases"][f"head.{k}.out"]
    for k in ("dets", "labels", "valid"):
        out[k] = state[k]
    return out


def reference_layout(rec: Dict[str, torch.Tensor], geom, detection: bool):
    """A recorded frame in the reference's layout: (semseg logits (1, C,
    h, w), or detection ``{"maps": (cls, reg, offset), "boxes": (dets,
    labels, valid)}``), and the grid (gh, gw)."""
    grid = rec["grid"][0]
    if not detection:
        return rec["outputs"].permute(0, 3, 1, 2), grid
    n, gh, gw = geom
    total, b = n * gh * gw, rec["csp_cls"].shape[1]

    def dense(blocks):
        c = blocks.shape[-1]
        x = blocks[:total].reshape(n, gh, gw, b, b, c).permute(
            0, 5, 1, 3, 2, 4)
        return x.reshape(n, c, gh * b, gw * b)
    maps = tuple(dense(rec[k]) for k in ("csp_cls", "csp_reg", "csp_offset"))
    return {"maps": maps, "boxes": (rec["dets"], rec["labels"],
                                    rec["valid"])}, grid
