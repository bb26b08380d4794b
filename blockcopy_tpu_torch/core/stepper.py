"""Fixed-capacity per-frame step: policy forward + blocked model + REINFORCE
update (counterpart of ``blockcopy_tpu/core/stepper.py``).

The sampled grid is rounded to exactly ``capacity`` executed blocks, so
every frame runs the same shapes with zero host syncs: all index bookkeeping
stays on the device, and the train decision comes from a host-side frame
counter (``state["frame_idx"]`` is a Python int here).

The carried state is a dict: per-layer canvases (updated in place), the
previous grid and outputs, the frame counter, and the policy state (params,
BN running statistics, RMSprop state, running cost, and the
``torch.Generator`` the grid draws come from).

At tracing level 3 (``utils/profiler.py``) a step marks the device where
its layers end, so that the marks are captured into its CUDA graph.  The
in-place forms open a step of their kind (``first``, ``plain``, ``train``,
the gloo split's ``grads`` and ``update``) and close it after the write
back; each mark ends the span it names:

* ``policy``: policy-input assembly, the policy forward, the grid's
  sampling and the executed indices (not on the first frame);
* ``blocks``: ``split_dense``, the frame-state scatter and the blocked
  model (backbone, then the decoder or the neck and head);
* ``outputs``: the task outputs (semseg the output store; detection the
  decode and NMS);
* ``reinforce``: the running cost, and on a train frame the reward grid,
  the REINFORCE backward, the gradients' all-reduce and RMSprop (not on
  the first frame; the ``update`` step is RMSprop alone);
* ``writeback``: the copy into the state's tensors (the first frame's
  running cost too).

So a first step marks 4 times (enter, blocks, outputs, exit), a plain,
train or grads step 6 times, an update step 3 times.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from blockcopy_tpu_torch.core import grid as gridlib
from blockcopy_tpu_torch.core.blocked import (
    ExecCtx,
    block_layout_to_dense,
    scatter_pack,
    split_dense,
)
from blockcopy_tpu_torch.device import resolve_device
from blockcopy_tpu_torch.ops.layers import (
    adaptive_max_pool2d,
    resize_bilinear,
)
from blockcopy_tpu_torch.policy import net as _polnet
from blockcopy_tpu_torch.policy import optim as rmsprop
from blockcopy_tpu_torch.policy.information_gain import (
    semseg_information_gain,
)
from blockcopy_tpu_torch.policy.net import (
    assemble_policy_input,
    assemble_policy_input_split,
    init_policy_net,
    policy_in_channels,
    policy_net_apply,
)
from blockcopy_tpu_torch.policy.policies import (reinforce_grads,
                                                 reinforce_update)
from blockcopy_tpu_torch.utils import profiler
from blockcopy_tpu_torch.utils.flops import policy_net_macs

FRAME_STATE = "__frame_state__"
OUT = "__out__"
# The JAX package's off-by-default output layouts (``stepper.py:61-68``),
# read when a step runs.  OUT_BLOCKS carries the semseg outputs in block
# layout, (N*GH*GW+1, bs/4, bs/4, C), and computes the reward per block;
# PACKED_OUT stores the OUT canvas lane-packed as (N*GH*GW+1, bs/4,
# bs/4*C).  OUT_BLOCKS wins where both are set.  Readers of the outputs go
# through ``fetch_outputs``.
OUT_BLOCKS = os.environ.get("BLOCKCOPY_TPU_OUT_BLOCKS", "0") == "1"
PACKED_OUT = os.environ.get("BLOCKCOPY_TPU_PACKED_OUT", "0") == "1"
# The policy reads the frame-state composite at 32 px per block, so the
# canvas stores blocks already nearest-downsampled to 32x32.
FS_BS = 32


@dataclasses.dataclass(frozen=True)
class StepperConfig:
    block_size: int = 128
    block_target: float = 0.5
    complexity_weight: float = 5.0
    cost_momentum: float = 0.9
    train_interval: int = 4
    lr: float = 1e-4
    weight_decay: float = 1e-3
    momentum: float = 0.0
    num_classes: int = 19
    # 'ref' = the reference PolicyNet; 'fast' = space-to-depth trunk
    policy_arch: str = "ref"

    @classmethod
    def from_settings(cls, s: dict) -> "StepperConfig":
        """From a settings dict (``core/argparser.py`` keys)."""
        return cls(
            block_size=s["block_size"],
            block_target=s["block_target"],
            complexity_weight=s["block_complexity_weight"],
            cost_momentum=s["block_cost_momentum"],
            train_interval=s["block_train_interval"],
            lr=s["block_optim_lr"],
            weight_decay=s["block_optim_wd"],
            momentum=s["block_optim_momentum"],
            num_classes=s["block_num_classes"],
            policy_arch=s.get("block_policy_arch", "ref"),
        )


class FixedCapacityStepper:
    """``first_step`` / ``step`` over a fixed geometry.

    ``apply_fn(params, x, ctx)`` is the blocked model.  ``step`` and
    ``first_step`` update the canvases of the state they are given in place
    and return the new state."""

    task_keys = ("outputs",)

    def __init__(self, apply_fn: Callable, cfg: StepperConfig, frame_shape,
                 capacity: int, dtype=torch.float32, device=None):
        self.apply_fn = apply_fn
        self.cfg = cfg
        self.device = resolve_device(device)
        n, h, w, _ = frame_shape
        self.frame_shape = tuple(frame_shape)
        gh, gw = gridlib.grid_shape(h, w, cfg.block_size)
        self.geom = (n, gh, gw)
        self.total = n * gh * gw
        self.capacity = min(capacity, self.total)
        self.dtype = dtype

    def _store_frame_state(self, ctx, pack) -> None:
        """Scatter this frame's blocks into the FRAME_STATE canvas at policy
        resolution (nearest-downsampled per block)."""
        k = pack.block_size // FS_BS
        small = pack
        if k > 1:
            r = torch.arange(FS_BS, device=pack.data.device) * k
            small = pack.with_data(
                pack.data.index_select(1, r).index_select(2, r))
        scatter_pack(ctx.canvas_for(FRAME_STATE, small), small)

    # -- task hooks ----------------------------------------------------------

    def _model_fn(self, params, pack, ctx) -> Dict:
        """The blocked model's stride-4 logits: dense, or the block-layout
        canvas under ``OUT_BLOCKS`` (a copy: the canvas is updated in
        place next frame, while the state keeps this frame's outputs as
        ``outputs_prev``)."""
        out = self.apply_fn(params, pack, ctx)
        profiler.mark("blocks", pack.data)
        if OUT_BLOCKS:
            task = {"outputs": ctx.store_blocks(OUT, out).clone()}
        elif PACKED_OUT:
            task = {"outputs": self._store_dense_packed(ctx, out)}
        else:
            task = {"outputs": ctx.store_dense(OUT, out)}
        profiler.mark("outputs", pack.data)
        return task

    def _store_dense_packed(self, ctx, out) -> torch.Tensor:
        """``store_dense`` through a lane-packed (total+1, bs, bs*C) canvas
        (``stepper.py:169``); returns the same dense (N, H/4, W/4, C).  A
        contiguous packed canvas is the same memory as ``store_dense``'s
        (total+1, bs, bs, C) one: the store is ``store_dense``'s, and the
        carried canvas is its packed view."""
        _, b, _, c = out.data.shape
        if OUT in ctx.canvases:
            ctx.canvases[OUT] = ctx.canvases[OUT].view(self.total + 1, b, b,
                                                       c)
        dense = ctx.store_dense(OUT, out)
        ctx.canvases[OUT] = ctx.canvases[OUT].view(self.total + 1, b, b * c)
        return dense

    def _blocks_out(self, state) -> bool:
        return OUT_BLOCKS and "outputs" in state \
            and state["outputs"].shape[0] == self.total + 1

    def fetch_outputs(self, state) -> torch.Tensor:
        """Dense (N, H/4, W/4, C) task outputs whatever the carried layout
        (callers: the CLIs, tools, tests)."""
        if self._blocks_out(state):
            n, gh, gw = self.geom
            return block_layout_to_dense(state["outputs"], n, gh, gw)
        return state["outputs"]

    def _output_repr(self, state):
        """The previous outputs for the policy input.  Under
        ``OUT_BLOCKS`` each block is nearest-resized to the policy's 32 px
        and then laid out dense, which equals resizing the dense image:
        block borders align with the sampling groups."""
        if not self._blocks_out(state):
            return state["outputs"]
        n, gh, gw = self.geom
        blocks = state["outputs"][: self.total]
        b = blocks.shape[1]
        if b != FS_BS:
            r = torch.arange(FS_BS, device=blocks.device) * b // FS_BS
            blocks = blocks.index_select(1, r).index_select(2, r)
        return block_layout_to_dense(blocks, n, gh, gw)

    def _information_gain(self, state):
        return semseg_information_gain(state["outputs"],
                                       state["outputs_prev"])

    def _reward_grid(self, state) -> torch.Tensor:
        """(n, gh, gw) information gain, max-pooled per block.  Under
        ``OUT_BLOCKS`` the KL is taken per block on the canvases, equal to
        the dense pipeline: the 0.25 bilinear taps stay inside aligned 4 px
        groups (``stepper.py:220``)."""
        n, gh, gw = self.geom
        if self._blocks_out(state):
            cur = state["outputs"][: self.total].float()
            prev = state["outputs_prev"][: self.total].float()
            oh = max(1, cur.shape[1] // 4)
            log_p = torch.log_softmax(resize_bilinear(cur, (oh, oh)), dim=-1)
            log_q = torch.log_softmax(resize_bilinear(prev, (oh, oh)), dim=-1)
            kl = (torch.exp(log_q) * (log_q - log_p)).mean(dim=-1)
            return kl.amax(dim=(1, 2)).reshape(n, gh, gw)
        return adaptive_max_pool2d(self._information_gain(state),
                                   (gh, gw))[..., 0]

    # -- state --------------------------------------------------------------

    def init_policy_state(self, seed: int) -> Dict:
        # fast arch: logit-head bias starts at logit(block_target)
        t = min(max(self.cfg.block_target, 1e-3), 1 - 1e-3)
        head_bias = math.log(t / (1.0 - t)) \
            if self.cfg.policy_arch == "fast" else 0.0
        params, bn_state = init_policy_net(
            policy_in_channels(self.cfg.num_classes), seed=seed,
            arch=self.cfg.policy_arch, head_bias=head_bias,
            device=self.device)
        return {
            "params": params,
            "bn_state": bn_state,
            "opt": rmsprop.init(params),
            "running_cost": torch.full((), -1.0, device=self.device),
            "generator": torch.Generator(self.device).manual_seed(seed),
        }

    def _shape_pass(self, model_params, blocks: int):
        """One building pass of the model over ``blocks`` executed blocks
        on the meta device (no values, no kernel): the context with its
        canvases and MAC tally, and the task outputs."""
        n, gh, gw = self.geom
        meta = torch.device("meta")
        meta_params = rmsprop.tree_map(lambda t: t.to(meta), model_params)
        idx = torch.arange(blocks, device=meta)
        ctx = ExecCtx.blocked(idx, n, gh, gw, {}, building=True)
        frame = torch.empty(self.frame_shape, dtype=self.dtype, device=meta)
        pack = split_dense(frame, idx, n, gh, gw)
        with torch.no_grad():
            self._store_frame_state(ctx, pack)
            task = self._model_fn(meta_params, pack, ctx)
        return ctx, task

    def init_state(self, model_params, seed: int = 0) -> Dict:
        """Carried state with zeroed canvases, their shapes found by one
        building pass of the model on the meta device."""
        n, gh, gw = self.geom
        ctx, task = self._shape_pass(model_params, self.total)
        zeros = lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                      device=self.device)
        state = {
            "canvases": rmsprop.tree_map(zeros, ctx.canvases),
            "prev_grid": torch.zeros((n, gh, gw), device=self.device),
            "frame_idx": 0,
            "policy": self.init_policy_state(seed),
        }
        for k in self.task_keys:
            state[k] = zeros(task[k])
            state[f"{k}_prev"] = zeros(task[k])
        return state

    def macs_breakdown_per_step(self, model_params,
                                policy: bool = True) -> Dict[str, float]:
        """Per-module MACs of one steady step (``capacity`` blocks), plus
        the policy net's under ``policy``; counted from shapes."""
        ctx, _ = self._shape_pass(model_params, self.capacity)
        breakdown = ctx.macs_by_module()
        if policy:
            _, h, w, _ = self.frame_shape
            scale = 0.25 * 128 / self.cfg.block_size
            breakdown["policy"] = policy_net_macs(
                int(h * scale), int(w * scale), self.cfg.num_classes,
                arch=self.cfg.policy_arch)
        return breakdown

    def macs_per_step(self, model_params, policy: bool = True) -> float:
        return sum(self.macs_breakdown_per_step(model_params, policy).values())

    @staticmethod
    def check_policy_finite(policy_state: Dict, phase: str) -> None:
        """Phase-boundary NaN guard: one bad REINFORCE update would
        silently spoil the policy for the rest of a run.  Sums every
        parameter leaf and the running cost: one host read."""
        total = policy_state["running_cost"].float().sum()
        for leaf in rmsprop.tree_leaves(policy_state["params"]):
            total = total + leaf.float().sum()
        if not bool(torch.isfinite(total)):
            raise FloatingPointError(
                f"policy state non-finite after {phase} (running_cost="
                f"{policy_state['running_cost'].tolist()}); training "
                f"diverged")

    def reset_temporal(self, state: Dict) -> Dict:
        """New clip: reset the frame counter (the all-exec first frame
        overwrites every canvas; the policy state persists)."""
        return {**state, "frame_idx": 0}

    # -- internals ----------------------------------------------------------

    def _run_model(self, params, state, frame, idx):
        n, gh, gw = self.geom
        pack = split_dense(frame, idx, n, gh, gw)
        ctx = ExecCtx.blocked(idx, n, gh, gw, state["canvases"])
        self._store_frame_state(ctx, pack)
        task = self._model_fn(params, pack, ctx)
        return ctx.canvases, task

    def _sample_grid(self, probs, draws: Optional[Tuple] = None,
                     generator: Optional[torch.Generator] = None):
        """Bernoulli sample, then round to exactly ``capacity`` blocks: keep
        sampled blocks (ranked by a random tie-break), fill with the highest
        scoring unsampled ones.  ``draws=(u_bernoulli, u_rank)`` of shapes
        ``probs.shape`` and ``(total,)`` replaces the generator's draws."""
        if draws is None:
            u = torch.rand(probs.shape, generator=generator,
                           device=probs.device)
            u_rank = torch.rand((probs.numel(),), generator=generator,
                                device=probs.device)
        else:
            u, u_rank = draws
        flat = (u < probs).float().reshape(-1)
        scores = u_rank + 2.0 * flat
        order = torch.argsort(-scores, stable=True)
        rank = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=order.device))
        return (rank < self.capacity).reshape(probs.shape)

    def _policy_optim(self, state, grid_f, cache_x, group=None,
                      grads_out=None):
        """Running cost, and the REINFORCE update on train frames, its
        gradients averaged over ``group`` where given (only the gradients:
        the running cost and BN statistics stay per rank, as per device in
        the JAX package).  With ``grads_out`` (a tree shaped as the policy
        parameters) a train frame writes its own gradients there and leaves
        the parameters and RMSprop state as they were
        (``apply_policy_grads_`` makes the update)."""
        cfg = self.cfg
        pol = state["policy"]
        perc = grid_f.mean()
        rc = pol["running_cost"]
        rc = torch.where(rc < 0, perc, rc)
        rc = rc * cfg.cost_momentum + (1 - cfg.cost_momentum) * perc
        if not self.is_train_frame(state["frame_idx"]):
            return {**pol, "running_cost": rc}

        reward_c = -(rc - cfg.block_target)
        reward_c = reward_c * reward_c.abs() * cfg.complexity_weight
        # reward_c is a scalar, so pooling the IG first and adding it after
        # is exactly max(ig + c) per block
        reward_grid = self._reward_grid(state) + reward_c
        signed = torch.where(grid_f > 0, reward_grid, -reward_grid)

        if grads_out is not None:
            grads, _ = reinforce_grads(pol["params"], pol["bn_state"],
                                       cache_x, grid_f, signed,
                                       cfg.policy_arch)
            rmsprop.tree_copy_(grads_out, grads)
            return {**pol, "running_cost": rc}
        params, opt, _ = reinforce_update(
            pol["params"], pol["bn_state"], pol["opt"], cache_x, grid_f,
            signed, cfg.policy_arch, cfg.lr, cfg.weight_decay, cfg.momentum,
            grad_reduce=None if group is None else group.mean_tree)
        return {**pol, "params": params, "opt": opt, "running_cost": rc}

    def is_train_frame(self, frame_idx: int) -> bool:
        """Whether the step that makes frame ``frame_idx`` (counted from 1)
        runs the REINFORCE update: a host decision, as in JAX."""
        return frame_idx % self.cfg.train_interval == 0 and frame_idx >= 2

    # -- steps --------------------------------------------------------------

    def first_step(self, model_params, state, frame):
        """Frame 1 of a clip: execute every block."""
        n, gh, gw = self.geom
        idx = torch.arange(self.total, device=frame.device)
        with torch.no_grad():
            canvases, task = self._run_model(model_params, state, frame, idx)
            pol = dict(state["policy"])
            rc = pol["running_cost"]
            rc = torch.where(rc < 0, 1.0, rc)
            pol["running_cost"] = rc * self.cfg.cost_momentum \
                + (1 - self.cfg.cost_momentum) * 1.0
        new = {
            **state,
            "canvases": canvases,
            "prev_grid": torch.ones((n, gh, gw), device=frame.device),
            "frame_idx": 1,
            "policy": pol,
        }
        for k in self.task_keys:
            new[k] = task[k]
            new[f"{k}_prev"] = task[k]
        return new

    def step(self, model_params, state, frame, draws: Optional[Tuple] = None,
             group=None, grads_out=None):
        """Steady-state frame: sample a grid of ``capacity`` blocks, run
        them, update the policy.  ``draws`` injects the grid's uniforms (see
        ``_sample_grid``).  ``group`` (a ``parallel.distributed.Group``,
        the counterpart of JAX's ``psum_axis``) averages the REINFORCE
        gradients over clip-parallel ranks: one ``all_reduce`` on a train
        frame, none on the others (every rank knows the train frames from
        its host-side frame counter).  ``grads_out``: see
        ``_policy_optim``."""
        n, gh, gw = self.geom
        pol = state["policy"]
        with torch.no_grad():
            fs_dense = block_layout_to_dense(state["canvases"][FRAME_STATE],
                                             n, gh, gw)
            if self.cfg.policy_arch == "fast" \
                    and _polnet.POLICY_SPLIT_STEM \
                    and _polnet.POLICY_STEM_CONV4:
                # the four sources apart: the stem convolves each, and the
                # REINFORCE backward recomputes from this tuple
                cache_x = assemble_policy_input_split(
                    frame, fs_dense, self._output_repr(state),
                    state["prev_grid"], self.cfg.block_size)
            else:
                cache_x = assemble_policy_input(
                    frame, fs_dense, self._output_repr(state),
                    state["prev_grid"], self.cfg.block_size,
                    # fast arch: bf16 assembly (its convs run bf16 anyway)
                    dtype=torch.bfloat16 if self.cfg.policy_arch == "fast"
                    else torch.float32)
            logits, bn_state = policy_net_apply(
                pol["params"], pol["bn_state"], cache_x, update_stats=True,
                arch=self.cfg.policy_arch)
            grid = self._sample_grid(torch.sigmoid(logits[..., 0]), draws,
                                     pol["generator"])
            grid_f = grid.float()
            idx = gridlib.exec_indices(grid, self.capacity)
            profiler.mark("policy", frame)
            canvases, task = self._run_model(model_params, state, frame, idx)
        mid = {
            **state,
            "canvases": canvases,
            "prev_grid": grid_f,
            "frame_idx": state["frame_idx"] + 1,
            "policy": {**pol, "bn_state": bn_state},
        }
        for k in self.task_keys:
            mid[k] = task[k]
            mid[f"{k}_prev"] = state[k]
        pol = self._policy_optim(mid, grid_f, cache_x, group, grads_out)
        profiler.mark("reinforce", frame)
        return {**mid, "policy": pol}

    # -- in-place steps (the counterpart of donation) -------------------------

    def _write(self, state, new) -> None:
        """Copy every tensor of ``new`` into ``state``'s own (skipping
        those already in place, as the canvases) and take its frame
        counter.  The ``*_prev`` keys go first: ``new["outputs_prev"]`` is
        ``state["outputs"]``, which the copy into ``state["outputs"]``
        then overwrites."""
        def put(dst, src):
            if isinstance(dst, torch.Tensor) \
                    and dst.data_ptr() != src.data_ptr():
                dst.copy_(src)

        with torch.no_grad():
            for key in sorted(state, key=lambda k: not k.endswith("_prev")):
                if key != "frame_idx":
                    rmsprop.tree_map(put, state[key], new[key])
        state["frame_idx"] = new["frame_idx"]

    def first_step_(self, model_params, state, frame):
        """``first_step`` written into ``state``'s tensors; returns
        ``state``.  Its tensors keep their storage, so a CUDA graph can
        take them as static buffers (``core/graphs.py``)."""
        profiler.enter_step("first", frame)
        self._write(state, self.first_step(model_params, state, frame))
        profiler.exit_step(frame)
        return state

    def step_(self, model_params, state, frame, draws: Optional[Tuple] = None,
              group=None, grads_out=None):
        """``step`` written into ``state``'s tensors: the new canvases,
        outputs and ``outputs_prev``, ``prev_grid``, the policy's params,
        BN statistics, RMSprop state and running cost.  Returns
        ``state``."""
        kind = "grads" if grads_out is not None else "train" \
            if self.is_train_frame(state["frame_idx"] + 1) else "plain"
        profiler.enter_step(kind, frame)
        self._write(state, self.step(model_params, state, frame, draws,
                                     group, grads_out))
        profiler.exit_step(frame)
        return state

    def apply_policy_grads_(self, state, grads) -> None:
        """The RMSprop update of a train frame from ``grads`` (those
        ``grads_out`` received, averaged over the ranks), written into the
        state's policy parameters and RMSprop state."""
        cfg = self.cfg
        pol = state["policy"]
        where = pol["running_cost"]
        profiler.enter_step("update", where)
        rmsprop.update_(grads, pol["opt"], pol["params"], lr=cfg.lr,
                        weight_decay=cfg.weight_decay, momentum=cfg.momentum)
        profiler.mark("reinforce", where)
        profiler.exit_step(where)
