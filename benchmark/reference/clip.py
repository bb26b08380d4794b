"""One clip through the reference: BlockCopy's frame loop in plain
PyTorch, to serve a clip (the control) or to judge a served one.

Served clips are ``Served`` records: each frame's grid and task output,
and the policy's RMSprop state and parameters after each train frame.
Judging follows the served clip frame by frame: the grid the served
program chose drives the reference model, and the served previous output
feeds the policy and its reward, as a served model's tokens feed the
reference that checks them.  The reference's model state (every site) is
its own from the clip's start.

Its policy takes the served policy's parameters as they stood before
each frame (from the clip's start, then after each update), since the
policy amplifies rounding from one update to the next: its logits are
sums of large terms.  From those parameters it works out
- ``grid_gap``: each frame's least margin ``|u - p|`` within which
  flipped samples explain the served grid, its mean over the clip's
  frames (the widest, ``grid_gap_max``, is reported, not compared);
- ``grad_gap``: on a train frame, one less the cosine between the
  gradient the served RMSprop step took (worked out from the parameters'
  change and the square averages after it) and the reference's; an update
  not made reads 1.  In a bf16 backward the leaves behind a BatchNorm
  carry rounding of the order of their own size (its backward removes a
  batch mean of large, nearly equal terms), so the direction is compared,
  where that noise enters squared; ``grad_norm_gap``, the relative gap of
  the two norms, is reported, not compared;
- ``step_gap``: on a train frame, the relative gap between the norm of
  the served parameters' change and that of the reference's own RMSprop
  step (its gradient, its square averages updated from the served ones
  before the frame): a step of the wrong size (a wrong learning rate or
  decay, square averages left unchanged) reads far from 0;
- ``rms_gap``: the served square averages after the update against
  RMSprop's own law for the gradient the served step implies,
  ``alpha * sq_before + (1 - alpha) * g^2``, the norm of the difference
  over the law's: on an update from square averages of zero (the first
  of the window's first clip) square averages left unchanged read 1, a
  doubled learning rate 0.75.  (Over the update's part alone, a frame
  whose gradient is small against the averages would read fp32's
  rounding of the averages as a gap.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from reference import model, nets, tasks
from reference.policy import (RMS_ALPHA, RMS_EPS, grid_gap,
                              policy_input, policy_logits, reinforce_grads,
                              select, unflatten)

FS_BS = 32      # the frame state: each block nearest-sampled to 32 x 32


@dataclasses.dataclass
class Served:
    """A served clip.  ``outputs[t]``: semseg (1, C, h, w) logits; detection
    a dict of ``maps`` (cls, reg, offset) and ``boxes`` (dets, labels,
    valid).  ``sq[t]`` and ``params_after[t]``: the RMSprop square averages
    and the policy's parameters (flat paths) after train frame t
    (1-based); ``params_end``: the parameters at the clip's end."""
    grids: List[torch.Tensor] = dataclasses.field(default_factory=list)
    outputs: List = dataclasses.field(default_factory=list)
    sq: Dict[int, Dict] = dataclasses.field(default_factory=dict)
    params_after: Dict[int, Dict] = dataclasses.field(default_factory=dict)
    params_end: Optional[Dict] = None


@dataclasses.dataclass
class Start:
    """The policy at a clip's start (flat paths): parameters, RMSprop
    square averages, the running cost (a 0-d tensor, -1 before any
    frame)."""
    params: Dict
    sq: Dict
    running_cost: torch.Tensor


class Task:
    """What differs between semantic segmentation and detection."""

    def __init__(self, cfg: Dict, img_hw, block_size: int):
        self.cfg = cfg
        self.img_hw = tuple(img_hw)
        self.bs = block_size
        self.detection = cfg["task"] == "detection"
        self.forward = model(cfg)[0]

    def model(self, fr, p, x):
        return self.forward(fr, p, x, self.cfg)

    def served(self, out):
        """The served form of the model's output."""
        if not self.detection:
            return out
        return {"maps": out, "boxes": tasks.decode(out, self.img_hw,
                                                   self.cfg)}

    def out_repr(self, served, hw):
        if not self.detection:
            return served.float()
        return tasks.instance_mask(*served["boxes"], hw,
                                   self.cfg["num_classes"] - 1,
                                   0.25 * 128 / self.bs)

    def gain(self, cur, prev):
        if not self.detection:
            return tasks.semseg_gain(cur, prev)
        return tasks.detection_gain(cur["boxes"], prev["boxes"], self.img_hw)

    def compare(self, served, out) -> Dict[str, float]:
        """The gaps of a served output against the reference's output."""
        if not self.detection:
            return {"out_gap": rel_gap(served, out)}
        gaps = [rel_gap(s, r) for s, r in zip(served["maps"], out)]
        decoded = tasks.decode(served["maps"], self.img_hw, self.cfg)
        return {"out_gap": max(gaps),
                "box_gap": tasks.box_gap(served["boxes"], decoded,
                                         self.img_hw)}


def rel_gap(served, ref) -> float:
    """The largest difference, over the reference's largest magnitude."""
    return float((served.float() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def _norm(tree: Dict[str, torch.Tensor]) -> float:
    """The norm of a whole tree."""
    return sum(float((v * v).sum()) for v in tree.values()) ** 0.5


def _mean_over(grads: Dict[str, torch.Tensor], group) -> Dict:
    """The gradients averaged over clip-parallel ranks."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    parts = iter(torch.split(flat, [g.numel() for g in grads.values()]))
    return {key: next(parts).view(g.shape) for key, g in grads.items()}


def run_clip(task: Task, p, frames, draws, start: Start, capacity: int,
             prec: str = "fp32", given: Optional[Served] = None,
             group=None, policy_prec: Optional[str] = None) -> tuple:
    """The clip ``frames`` ((1, 3, H, W) fp32 each; ``draws[t]`` the
    uniforms (u, u_rank) of frame t + 2, flat) from the policy ``start``.
    Serves it where ``given`` is None; else judges ``given``, the served
    frames counted ``len(given.outputs)``.  ``group`` averages the
    REINFORCE gradients over clip-parallel ranks.  ``policy_prec`` computes
    the policy's convolutions in another precision than the model's (the
    control's).  Returns (the reference's
    ``Served``, the worst of each gap; {} when serving)."""
    cfg = task.cfg
    rnd = nets.rounder(prec)
    prnd = nets.rounder(policy_prec or prec)
    gh, gw = task.img_hw[0] // task.bs, task.img_hw[1] // task.bs
    dev = frames[0].device
    params = {k: v.detach().clone() for k, v in start.params.items()}
    sq = {k: v.detach().clone() for k, v in start.sq.items()}
    rc = start.running_cost.clone()
    sites: Dict = {}
    mine = Served()
    gaps: Dict[str, float] = {}
    worst = lambda k, v: gaps.__setitem__(k, max(gaps.get(k, 0.0), v))
    n = len(frames) if given is None else len(given.outputs)
    k = task.bs // FS_BS
    scale = 0.25 * 128 / task.bs
    hw_pol = (int(task.img_hw[0] * scale), int(task.img_hw[1] * scale))
    prev_served = prev_grid = px = None
    margins = []
    for t in range(1, n + 1):
        x = frames[t - 1]
        small = x[:, :, ::k, ::k]
        if t == 1:
            grid = torch.ones((gh, gw), dtype=torch.bool, device=dev)
        else:
            fs = sites["frame_state"]
            px = policy_input(x, fs, task.out_repr(prev_served, hw_pol),
                              prev_grid, task.bs)
            with torch.no_grad():
                probs = torch.sigmoid(policy_logits(unflatten(params), px,
                                                    prnd))[0, 0]
            u, u_rank = (d.float().reshape(-1).cpu().numpy()
                         for d in draws[t - 2])
            pr = probs.reshape(-1).cpu().numpy()
            if given is None:
                sel = select((u < pr).astype("float32"), u_rank, capacity)
                grid = torch.from_numpy(sel).to(dev).reshape(gh, gw)
            else:
                grid = given.grids[t - 1].to(dev).bool()
                margins.append(grid_gap(pr, u, u_rank,
                                        grid.reshape(-1).cpu().numpy(),
                                        capacity))
        fr = nets.Frame(grid, sites, rnd)
        with torch.no_grad():
            out = task.model(fr, p, x)
            fr.site("frame_state", small)
            served = task.served(out) if given is None else given.outputs[
                t - 1]
        if given is not None:
            for key, v in task.compare(served, out).items():
                worst(key, v)
        mine.grids.append(grid)
        mine.outputs.append(served)
        perc = grid.float().mean()
        m = cfg["cost_momentum"]
        if t == 1:
            rc = torch.where(rc < 0, torch.ones_like(rc), rc) * m + (1 - m)
        else:
            rc = torch.where(rc < 0, perc, rc) * m + (1 - m) * perc
        if t >= 2 and t % cfg["train_interval"] == 0:
            reward_c = -(rc - cfg["target"])
            reward_c = reward_c * reward_c.abs() * cfg["complexity_weight"]
            with torch.no_grad():
                reward = tasks.pool_to_grid(task.gain(served, prev_served),
                                            (gh, gw)) + reward_c
            signed = torch.where(grid, reward, -reward)
            grads = reinforce_grads(unflatten(params), px, grid, signed, prnd)
            if group is not None:
                grads = _mean_over(grads, group)
            wd = cfg["weight_decay"]
            g = {key: grads[key] + wd * params[key] for key in params}
            sq_before = sq
            sq = {key: RMS_ALPHA * sq[key] + (1 - RMS_ALPHA) * g[key] ** 2
                  for key in params}
            step = {key: -cfg["lr"] * g[key] / (torch.sqrt(sq[key])
                                                 + RMS_EPS)
                    for key in params}
            if given is None:
                params = {key: params[key] + step[key] for key in params}
                mine.sq[t] = sq
                mine.params_after[t] = params
            else:
                # the gradient the program's RMSprop took: the sign and the
                # size of its step over its square averages after it
                after, sq_after = given.params_after[t], given.sq[t]
                change = {key: after[key] - params[key] for key in params}
                g_prog = {key: -change[key] / cfg["lr"]
                          * (torch.sqrt(sq_after[key]) + RMS_EPS)
                          for key in params}
                dot = sum(float((g_prog[key] * g[key]).sum())
                          for key in params)
                size = _norm(g_prog) * _norm(g)
                worst("grad_gap", 1.0 - dot / size if size > 0 else 1.0)
                worst("grad_norm_gap", abs(_norm(g_prog) / max(_norm(g), 1e-30)
                                           - 1.0))
                worst("step_gap", abs(_norm(change)
                                      / max(_norm(step), 1e-30) - 1.0))
                law = {key: RMS_ALPHA * sq_before[key]
                       + (1 - RMS_ALPHA) * g_prog[key] ** 2
                       for key in params}
                off = {key: sq_after[key] - law[key] for key in params}
                worst("rms_gap", _norm(off) / max(_norm(law), 1e-30))
                params, sq = dict(after), dict(sq_after)
        prev_served, prev_grid = served, grid
    mine.params_end = params
    if margins:
        gaps["grid_gap"] = sum(margins) / len(margins)
        gaps["grid_gap_max"] = max(margins)
    return mine, gaps
