"""Compiled, donated steps as CUDA graphs: the port's counterpart of the
JAX package's ``jax.jit`` sites, on its serving paths and in training.

``CapturedCall(fn, device, pool)`` wraps ``fn(held, *inputs)``.  ``held``
is what the graph reads and writes in place: parameters, state, generators
(the counterpart of donation: those tensors are the graph's static buffers,
allocated outside its pool).  On CUDA the first call runs ``fn`` once on a
side stream, which gives that call's result and does what capture cannot
(kernel builds, ``cudaFuncSetAttribute``, cuDNN's algorithm choice,
autograd's set-up), then captures ``fn`` over copies of ``inputs``, every
CUDA generator of ``held`` registered with the graph, so that a replay
draws what the eager call would draw next.  Each later call copies
``inputs`` into those copies (tensors with ``copy_``; a Python float, such
as a reward weight or a learning rate, with ``fill_`` into a 0-d fp32
tensor: no upload from pageable memory, so no host sync; ``fn`` sees that
tensor on every device) and replays the graph.  A tensor input must lie on
the card already: a host tensor raises, since copying it in would wait for
the host (``device.to_device`` uploads without that wait).  What ``fn``
returns (a tree of tensors, or None) the graph copies into static buffers
outside its pool, which every call returns: the next replay overwrites
them, so a caller clones what it keeps.
A failed capture or replay raises: nothing falls back to eager on the card.
Cyclic garbage collection is held off while a graph captures: a dead graph
or tensor it freed there would invalidate the capture.
On the CPU ``fn`` runs eagerly, and its results go into buffers kept across
calls as on the card (the first call's own), so that a caller who keeps
one without a clone sees it overwritten there too.

``CallGraphs`` keys such graphs as JAX's jit cache: by the static
arguments a caller names (``static_argnums``) and by the shapes and dtypes
of the inputs (the detection train step, ``tasks/detection/train.py``
``make_train_step``, is one: JAX's ``train_cli.py:98``); ``CapturedStep``
and ``StepperGraphs`` are the steppers' and the ladder engine's model
steps (``jax.jit(step, donate_argnums=(1,))``,
the JAX package's ``tasks/semseg/eval.py:214-216``,
``tasks/detection/eval.py:187-189``, ``core/engine.py:141-157``).

The graphs of one stepper, engine or CLI share one memory pool.  It holds
only temporaries, since every kept result is copied into a buffer outside
it, so those graphs may be replayed in any order.

A graph is stale when what it holds is rebound: other parameters, or state
tensors or generators that are not those it captured (loading a policy
must ``copy_`` into its tensors, not replace them); a call then raises.
An in-place change of the model parameters after capture is not seen by
K2, whose weights are prepared once (``ops/kernels/bottleneck.py``
``prepared_tail_weights``).

The kernel wrappers do not run on a replay, so each graph records the
launch counts of its capture (``ops/kernels`` ``launches``) and adds them
on every replay: the counts read the same per frame eager or replayed.
"""

from __future__ import annotations

import functools
import gc
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
    """A memory pool for the graphs of one stepper, engine or CLI
    (``None`` on the CPU)."""
    return torch.cuda.graph_pool_handle() \
        if torch.device(device).type == "cuda" else None


def as_tensors(inputs, device):
    """``inputs`` with every Python float as a 0-d fp32 tensor."""
    return tree_map(lambda x: torch.full((), x, dtype=torch.float32,
                                         device=device)
                    if isinstance(x, float) else x, inputs)


def _on_card(inputs):
    """Refuse a host tensor among a graph's inputs: its ``copy_`` into a
    static input would be a host sync."""
    for x in tree_leaves(inputs):
        if isinstance(x, torch.Tensor) and x.device.type != "cuda":
            raise ValueError(
                f"a {x.device} tensor as a CUDA graph's input: upload it "
                f"first (device.to_device); copying it in would be a host "
                f"sync")


def _signature(inputs):
    """What a graph's inputs fix: each tensor's shape and dtype, the place
    of each float."""
    return tuple((tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
                 else type(x).__name__ for x in tree_leaves(inputs))


class CapturedCall:
    """``fn(held, *inputs)`` as one CUDA graph on ``device``, captured at
    the first call (see the module's docstring).  Calls return ``fn``'s
    result: on CUDA the graph's output buffers.  ``capture_s`` is the first
    call's seconds, its eager run included; ``launches`` the kernel
    launches a replay adds."""

    def __init__(self, fn: Callable, device, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.graph = None
        self._out = None
        self.launches: Dict[str, int] = {}
        self.capture_s = None

    def __call__(self, held, *inputs):
        if self.device.type != "cuda":
            out = self.fn(held, *as_tensors(inputs, self.device))
            if self._out is None or out is None:
                self._out = out
            else:
                with torch.no_grad():
                    tree_map(lambda buf, x: buf.copy_(x), self._out, out)
            return self._out
        _on_card(inputs)
        if self.graph is None:
            return self._capture(held, inputs)
        if _bound(held) != self._held:
            raise RuntimeError(
                "stale CUDA graph: the parameters or the state's tensors or "
                "generators are not those it captured (update them with "
                "copy_, do not replace them)")
        given = tree_leaves(inputs)
        if len(given) != len(self._inputs):
            raise ValueError(f"{len(given)} inputs, the graph captured "
                             f"{len(self._inputs)}")
        for buf, x in zip(self._inputs, given):
            if isinstance(x, float):
                buf.fill_(x)
            elif x is not buf:
                buf.copy_(x)
        self.graph.replay()
        for key, n in self.launches.items():
            kernels.launches[key] += n
        return self._out

    def _capture(self, held, inputs):
        t0 = time.perf_counter()
        self._held = _bound(held)
        # the static inputs: copies made outside the pool
        static = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                          else x, as_tensors(inputs, self.device))
        self._inputs = tree_leaves(static)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            # the eager run: this call's result, and the warm-up
            first = self.fn(held, *static)
        main.wait_stream(side)
        # the output buffers, outside the pool
        self._out = tree_map(torch.clone, first) if first is not None \
            else None
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        for gen in tree_leaves(held):
            if isinstance(gen, torch.Generator) \
                    and gen.device.type == "cuda":
                graph.register_generator_state(gen)
        counts = dict(kernels.launches)
        # no cyclic garbage collection inside the capture: a dead graph it
        # freed would release its memory pool there (a ``cudaFree``), which
        # invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                out = self.fn(held, *static)
                if out is not None:
                    with torch.no_grad():
                        tree_map(lambda buf, x: buf.copy_(x), self._out,
                                 out)
        finally:
            if collecting:
                gc.enable()
            # capture launches nothing: its counts are the graph's
            self.launches = {k: v - counts[k]
                             for k, v in kernels.launches.items()}
            kernels.launches.update(counts)
        main.wait_stream(side)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        return self._out


class CallGraphs:
    """Captured calls sharing one pool, keyed as JAX's jit cache: by the
    static arguments a caller names in ``key`` and by the shapes and
    dtypes of the inputs; a new key captures a graph of its own.  ``fn``
    is read on a key's first call only, so ``key`` must determine it.  On
    the CPU every call runs eagerly."""

    def __init__(self, device, pool=None):
        self.device = torch.device(device)
        self.pool = graph_pool(self.device) if pool is None else pool
        self.graphs: Dict[tuple, CapturedCall] = {}

    def __call__(self, key: tuple, fn: Callable, held, *inputs):
        sig = (key, _signature(inputs))
        call = self.graphs.get(sig)
        if call is None:
            call = self.graphs[sig] = CapturedCall(fn, self.device,
                                                   self.pool)
        return call(held, *inputs)


class CapturedStep(CapturedCall):
    """``fn(params, state, *inputs)``, a step that writes every result a
    caller keeps into the tensors of ``state`` (so the graph returns
    nothing), as one CUDA graph.  ``fn`` runs on a copy of the state's
    dicts (the same tensors), so it never changes a host value of the
    state, such as a frame counter: a replay could not either, and the
    caller keeps that bookkeeping on both paths.  Calls return
    ``state``."""

    def __init__(self, fn: Callable, device, pool=None):
        def body(held, *inputs):
            fn(held[0], _host_copy(held[1]), *inputs)

        super().__init__(body, device, pool)

    def __call__(self, params, state, *inputs):
        super().__call__((params, state), *inputs)
        return state


class StepperGraphs:
    """A fixed-capacity stepper's ``first_step`` and ``step`` as the CLIs
    run them: JAX's ``jax.jit(stepper.first_step / stepper.step,
    donate_argnums=(1,))``, over the stepper's in-place forms
    (``first_step_`` / ``step_``).  Each kind of frame is a graph of its
    own, captured at its first call: the first step, a plain step and a
    train step (the REINFORCE branch is picked on the host from the frame
    counter), each step with or without injected ``draws`` (static inputs
    of their own).  On the CPU the in-place forms run eagerly.

    ``group`` (a ``parallel.distributed.Group``) makes them a clip-parallel
    rank's steps (JAX's sharded, donated step, ``parallel/clip_parallel.py:
    78``): a train step averages its REINFORCE gradients over the group.
    Where the group's collectives can be captured (NCCL, or a world of one)
    the train graph holds that ``all_reduce``; on gloo, which stages a CUDA
    tensor through the host, the train frame runs as a graph that writes
    the gradients into buffers of its own, the eager ``Group.mean_tree``,
    and a graph of the in-place RMSprop update from the averaged
    gradients."""

    def __init__(self, stepper, group=None):
        self.stepper = stepper
        self.group = group
        self.pool = graph_pool(stepper.device)
        self.graphs: Dict[tuple, CapturedStep] = {}
        self._grads = None      # the gloo split's gradients

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
        extra = () if draws is None else (tuple(draws),)
        if not (train and self.group is not None):
            self._graph(("train" if train else "plain", draws is not None),
                        self.stepper.step_)(model_params, state, frame,
                                            *extra)
        elif self.group.capturable:
            self._graph(("train", draws is not None), functools.partial(
                self.stepper.step_, group=self.group))(
                    model_params, state, frame, *extra)
        else:
            if self._grads is None:
                self._grads = tree_map(torch.zeros_like,
                                       state["policy"]["params"])
            self._graph(("grads", draws is not None), functools.partial(
                self.stepper.step_, grads_out=self._grads))(
                    model_params, state, frame, *extra)
            self._graph(("update",), self._update)(
                model_params, state, self.group.mean_tree(self._grads))
        state["frame_idx"] += 1
        return state

    def _update(self, model_params, state, grads):
        self.stepper.apply_policy_grads_(state, grads)
