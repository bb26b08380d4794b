"""Compiled, donated steps as CUDA graphs: the port's counterpart of
``jax.jit(step, donate_argnums=(1,))`` (the JAX package's
``tasks/semseg/eval.py:214-216``, ``tasks/detection/eval.py:187-189`` and
the ladder engine's per-capacity ``_get_step``, ``core/engine.py:141-157``).

``CapturedStep(fn, device, pool)`` wraps a step ``fn(params, state,
*inputs)`` that writes every result a caller keeps into the tensors of
``state`` (the counterpart of donation: those tensors are the graph's
static buffers, allocated outside its pool).  On CUDA its first call runs
``fn`` once on a side stream, which gives that call's result and does
what capture cannot (kernel builds, ``cudaFuncSetAttribute``, cuDNN's
algorithm choice, autograd's set-up), then captures ``fn`` over copies of
``inputs``; each later call copies ``inputs`` into those copies and
replays the graph.  A failed capture or replay raises: nothing falls back
to the eager step on the card.  On the CPU it calls ``fn`` eagerly.

``fn`` runs on a copy of the state's dicts (the same tensors), so it never
changes a host value of the state, such as a frame counter: a replay could
not either, and the caller keeps that bookkeeping on both paths.

The graphs of one stepper or engine share one memory pool.  It holds only
temporaries, since every kept result is copied into a buffer outside it,
so those graphs may be replayed in any order.

A graph is stale when what it captured is rebound: other model parameters,
or state tensors or generators that are not those it captured (loading a
policy must ``copy_`` into the state, not replace its tensors); a call
then raises.  An in-place change of the model parameters after capture is
not seen by K2, whose weights are prepared once (``ops/kernels/
bottleneck.py`` ``prepared_tail_weights``).

The kernel wrappers do not run on a replay, so each graph records the
launch counts of its capture (``ops/kernels`` ``launches``) and adds them
on every replay: the counts read the same per frame eager or replayed.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.policy.optim import tree_leaves, tree_map


def _host_copy(tree):
    """The dicts of ``tree`` copied, its leaves shared."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    return tree


def _bound(tree):
    """What a graph captured of ``tree``: each tensor's address and each
    generator."""
    return tuple(x.data_ptr() if isinstance(x, torch.Tensor) else x
                 for x in tree_leaves(tree)
                 if isinstance(x, (torch.Tensor, torch.Generator)))


def graph_pool(device):
    """A memory pool for the graphs of one stepper or engine (``None`` on
    the CPU)."""
    return torch.cuda.graph_pool_handle() \
        if torch.device(device).type == "cuda" else None


class CapturedStep:
    """``fn(params, state, *inputs)`` as one CUDA graph on ``device``,
    captured at the first call (see the module's docstring).  Calls return
    ``state``.  ``capture_s`` is the first call's seconds, its eager run
    included; ``launches`` the kernel launches a replay adds."""

    def __init__(self, fn: Callable, device, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.capture_s = None

    def __call__(self, params, state, *inputs):
        if self.device.type != "cuda":
            self.fn(params, _host_copy(state), *inputs)
            return state
        if self.graph is None:
            self._capture(params, state, inputs)
            return state
        if _bound(params) != self._params or _bound(state) != self._state:
            raise RuntimeError(
                "stale CUDA graph: the model parameters or the state's "
                "tensors or generators are not those it captured (update "
                "the state with copy_, do not replace its tensors)")
        given = [x for x in tree_leaves(inputs)
                 if isinstance(x, torch.Tensor)]
        if len(given) != len(self._inputs):
            raise ValueError(f"{len(given)} input tensors, the graph "
                             f"captured {len(self._inputs)}")
        for buf, x in zip(self._inputs, given):
            if x is not buf:
                buf.copy_(x)
        self.graph.replay()
        for key, n in self.launches.items():
            kernels.launches[key] += n
        return state

    def _capture(self, params, state, inputs):
        t0 = time.perf_counter()
        self._params, self._state = _bound(params), _bound(state)
        # the static inputs: copies made outside the pool
        static = tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x, inputs)
        self._inputs = [x for x in tree_leaves(static)
                        if isinstance(x, torch.Tensor)]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            # the eager run: this call's result, and the warm-up
            self.fn(params, _host_copy(state), *static)
        graph = torch.cuda.CUDAGraph()
        for gen in tree_leaves(state):
            if isinstance(gen, torch.Generator) \
                    and gen.device.type == "cuda":
                graph.register_generator_state(gen)
        counts = dict(kernels.launches)
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                self.fn(params, _host_copy(state), *static)
        finally:
            # capture launches nothing: its counts are the graph's
            self.launches = {k: v - counts[k]
                             for k, v in kernels.launches.items()}
            kernels.launches.update(counts)
        main.wait_stream(side)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0


class StepperGraphs:
    """A fixed-capacity stepper's ``first_step`` and ``step`` as the CLIs
    run them: JAX's ``jax.jit(stepper.first_step / stepper.step,
    donate_argnums=(1,))``, over the stepper's in-place forms
    (``first_step_`` / ``step_``).  Each kind of frame is a graph of its
    own, captured at its first call: the first step, a plain step and a
    train step (the REINFORCE branch is picked on the host from the frame
    counter), each step with or without injected ``draws`` (static inputs
    of their own).  On the CPU the in-place forms run eagerly."""

    def __init__(self, stepper):
        self.stepper = stepper
        self.pool = graph_pool(stepper.device)
        self.graphs: Dict[tuple, CapturedStep] = {}

    def _graph(self, key, fn) -> CapturedStep:
        if key not in self.graphs:
            self.graphs[key] = CapturedStep(fn, self.stepper.device,
                                            self.pool)
        return self.graphs[key]

    def first_step(self, model_params, state, frame):
        self._graph(("first",), self.stepper.first_step_)(
            model_params, state, frame)
        state["frame_idx"] = 1
        return state

    def step(self, model_params, state, frame, draws=None):
        train = self.stepper.is_train_frame(state["frame_idx"] + 1)
        key = ("train" if train else "plain", draws is not None)
        self._graph(key, self.stepper.step_)(
            model_params, state, frame,
            *(() if draws is None else (tuple(draws),)))
        state["frame_idx"] += 1
        return state
