"""BlockCopy execution engine: the per-frame pipeline in ladder mode
(counterpart of ``blockcopy_tpu/core/engine.py``).

Each frame: the policy picks the grid, the blocked model runs the executed
blocks padded to the smallest capacity on the quantization ladder, the
policy optimizes every ``train_interval`` frames.  Under ``graphs`` (the
default) every compiled program of the JAX engine is a CUDA graph
(``core/graphs.py``), captured at its first use, in the frame's order: the
policy's forward (JAX's ``_forward_jit``), the count read, the capacity's
model step (JAX's per-capacity compiled, donated ``_get_step``), a task's
decode (``CSPBlockCopy``) and on train frames the REINFORCE update (JAX's
``_optim_jit``).  Each capacity's MAC tally is recorded once.

The engine's only host sync per frame is the executed-block count
(``Policy._finalize``), which picks the capacity (a graph's first call
captures it, which synchronizes); a task's decode may add its own
(``CSPBlockCopy`` reads its boxes back).  A frame with count 0
runs no model and returns the previous outputs.  Temporal state is a dict
of per-layer canvases updated in place.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from blockcopy_tpu_torch.core import grid as gridlib
from blockcopy_tpu_torch.core.blocked import BlockPack, ExecCtx, split_dense
from blockcopy_tpu_torch.core.graphs import (CallGraphs, CapturedStep,
                                             graph_pool)
from blockcopy_tpu_torch.device import resolve_device
from blockcopy_tpu_torch.policy.optim import tree_map
from blockcopy_tpu_torch.policy.policies import build_policy_from_settings
from blockcopy_tpu_torch.utils.flops import FlopsTracker, policy_net_macs
from blockcopy_tpu_torch.utils.profiler import timings

FRAME_STATE = "__frame_state__"
OUT = "__out__"


def noblocks(ctx: ExecCtx, name: str, x, fn: Callable):
    """Run ``fn(dense_ctx, dense_x)`` densely inside a blocked model: combine
    the blocks through a persistent canvas, apply ``fn``, gather the executed
    blocks of the result (``engine.py:44``).  The dense view shares the
    context's MAC tally."""
    if not isinstance(x, BlockPack) or ctx.is_dense:
        return fn(ctx.as_dense(), x)
    dense = ctx.store_dense(name, x)
    y = fn(ctx.as_dense(), dense)
    return split_dense(y, ctx.idx, ctx.n, ctx.gh, ctx.gw)


# the reference decorator's name (``core/blockcopy.py:92``)
blockcopy_noblocks = noblocks


class BlockCopyModel:
    """A blocked model's apply function wrapped in the BlockCopy frame loop.

    Subclasses adapt it to a task through two hooks: ``_store_out`` keeps
    the model's output across frames (by default a canvas named ``OUT``,
    whose dense image is the frame's output) and ``_decode`` turns that
    into the frame's outputs (by default itself).

    Args:
        apply_fn: ``apply_fn(params, x, ctx)``, ``x`` a ``BlockPack`` or a
            dense NHWC tensor, ``ctx`` an ``ExecCtx``; the output stride
            against the input is constant.
        params: the model's parameter tree, on ``device``.
        settings: the BlockCopy settings dict (``core/argparser.py``).
        policy: a policy object; by default ``build_policy_from_settings``.
        device: default CUDA; raises where it is absent.
        graphs: run the policy's forward and update, each capacity's
            model step and the decode as CUDA graphs (on the CPU, the same
            bodies eagerly); ``False`` runs the frame op by op.  Read at
            every frame.
    """

    def __init__(self, apply_fn: Callable, params, settings: dict,
                 policy=None, device=None, graphs: bool = True):
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.params = params
        self.settings = settings
        self.policy = policy or build_policy_from_settings(settings,
                                                           self.device)
        self.block_size = settings["block_size"]
        self.train_interval = settings["block_train_interval"]
        self.quantum = settings.get("block_quantize_number_exec", 1.0 / 16.0)

        self._geom = None  # (n, gh, gw)
        self._frame_shape = None
        self.temporal = None
        self.flops = FlopsTracker()
        self.graphs = graphs
        self._steps = {}        # capacity -> CapturedStep
        self._pool = graph_pool(self.device)
        self._calls = CallGraphs(self.device, self._pool)  # policy, decode
        self._bufs = None       # (outputs, frame_state) the graphs write
        self.reset_temporal()

    # -- temporal state -----------------------------------------------------

    def reset_temporal(self):
        """Reset per-clip state (reference ``core/blockcopy.py:34-43``).
        Canvases stay allocated: the first frame executes every block and
        overwrites them all."""
        self.clip_length = 0
        self.policy_meta = {"inputs": None, "outputs": None,
                            "outputs_prev": None}

    def _init_temporal(self, frame):
        """Zeroed canvases on the device, their shapes found by one building
        pass of the model over every block on the meta device."""
        n, h, w, _ = frame.shape
        gh, gw = gridlib.grid_shape(h, w, self.block_size)
        self._geom = (n, gh, gw)
        self._frame_shape = tuple(frame.shape)
        total = n * gh * gw
        meta = torch.device("meta")
        idx = torch.arange(total, device=meta)
        ctx = ExecCtx.blocked(idx, n, gh, gw, {}, building=True)
        pack = split_dense(torch.empty(frame.shape, dtype=frame.dtype,
                                       device=meta), idx, n, gh, gw)
        with torch.no_grad():
            frame_state = ctx.store_dense(FRAME_STATE, pack)
            out = self.apply_fn(tree_map(lambda t: t.to(meta), self.params),
                                pack, ctx)
            outputs = self._store_out(ctx, out)
        zeros = lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                      device=self.device)
        self.temporal = {"canvases": tree_map(zeros, ctx.canvases)}
        self._bufs = tree_map(zeros, (outputs, frame_state))
        self._steps = {}
        if self.policy.is_trainable():
            scale = 0.25 * 128 / self.block_size
            self.flops.policy_macs = policy_net_macs(
                int(h * scale), int(w * scale),
                self.settings.get("block_num_classes", 19),
                arch=self.settings.get("block_policy_arch", "ref"))

    def _model_step(self, capacity: int, frame, grid):
        """Run the executed blocks of ``grid`` at ``capacity``; the canvases
        are updated in place.  Returns ``(outputs, frame_state)``.  Under
        ``graphs`` the capacity's graph writes them into the engine's
        buffers, outside its pool, and they are cloned out: the next replay
        leaves this frame's results, ``outputs_prev`` among them, as they
        were."""
        if not self.graphs:
            return self._run_blocks(capacity, self.params, self.temporal,
                                    frame, grid)
        step = self._steps.get(capacity)
        if step is None:
            step = self._steps[capacity] = CapturedStep(
                partial(self._graph_body, capacity), self.device, self._pool,
                "model_step")
        step(self.params, self.temporal, frame, grid)
        return tree_map(torch.clone, self._bufs)

    def _run_blocks(self, capacity: int, params, temporal, frame, grid):
        n, gh, gw = self._geom
        with torch.no_grad():
            idx = gridlib.exec_indices(grid, capacity)
            pack = split_dense(frame, idx, n, gh, gw)
            ctx = ExecCtx.blocked(idx, n, gh, gw, temporal["canvases"])
            frame_state = ctx.store_dense(FRAME_STATE, pack)
            out = self.apply_fn(params, pack, ctx)
            outputs = self._store_out(ctx, out)
        if capacity not in self.flops.macs_per_capacity:
            self.flops.record_trace(capacity, ctx.macs_by_module())
        return outputs, frame_state

    def _graph_body(self, capacity: int, params, temporal, frame, grid):
        """``_run_blocks`` with its results copied into the buffers."""
        res = self._run_blocks(capacity, params, temporal, frame, grid)
        with torch.no_grad():
            tree_map(lambda buf, x: buf.copy_(x), self._bufs, res)

    # -- task hooks -----------------------------------------------------------

    def _store_out(self, ctx: ExecCtx, out):
        """Keep the model's output: skipped blocks hold their last value."""
        return ctx.store_dense(OUT, out)

    def _decode(self, out):
        """The frame's outputs from ``_store_out``'s result."""
        return out

    # -- checkpoint / resume ------------------------------------------------

    def save_policy(self, path: str) -> None:
        from blockcopy_tpu_torch.utils.policy_ckpt import save_ladder_policy
        save_ladder_policy(self.policy, path)

    def load_policy(self, path: str) -> None:
        from blockcopy_tpu_torch.utils.policy_ckpt import load_ladder_policy
        load_ladder_policy(self.policy, path)

    # -- frame loop ---------------------------------------------------------

    def __call__(self, inputs, draws=None):
        """One frame.  ``inputs``: dense (N, H, W, 3), normalized, on the
        engine's device.  ``draws`` goes to the policy's ``forward``.  The
        ``timings`` spans (level 3: ``blockcopy/policy_forward``,
        ``blockcopy/model``, ``blockcopy/policy_optim``) time the host's
        part of each phase; nothing waits for the card, so device work
        queued there may finish in a later span (the count read of the
        next phase waits for it)."""
        self.clip_length += 1
        meta = self.policy_meta
        meta["inputs"] = inputs
        calls = self._calls if self.graphs else None

        with timings.env("blockcopy/policy_forward", 3):
            meta = self.policy(meta, draws, calls)

        with timings.env("blockcopy/model", 3):
            if self.temporal is None or self._geom is None:
                self._init_temporal(inputs)
            elif tuple(inputs.shape) != self._frame_shape:
                raise ValueError(
                    f"frame shape changed {self._frame_shape} -> "
                    f"{tuple(inputs.shape)}: the engine's temporal state "
                    f"is geometry-static; build a new BlockCopyModel for a "
                    f"different resolution")
            count = meta["num_exec"]
            if count == 0:
                out = meta["outputs"]
                capacity = 0
            else:
                capacity = gridlib.capacity_for_count(
                    count, meta["num_total"], self.quantum)
                out, meta["frame_state"] = self._model_step(
                    capacity, inputs, meta["grid"])
                with torch.no_grad():
                    out = self._decode(out)
            self.flops.record_frame(
                capacity, policy_ran=meta.get("_rl_cache") is not None,
                images=inputs.shape[0])
            meta["outputs_prev"] = meta["outputs"]
            meta["outputs"] = out

        with timings.env("blockcopy/policy_optim", 3):
            train_policy = self.clip_length % self.train_interval == 0
            self.policy_meta = self.policy.optim(meta, train=train_policy,
                                                 graphs=calls)
        return out

    forward = __call__
