"""Clip-level data parallelism (counterpart of
``blockcopy_tpu/parallel/clip_parallel.py``).

Temporal state is per clip, so D ranks step D independent clips; the one
shared component, the online policy, stays identical on every rank because
its REINFORCE gradients are averaged over the ranks before each update
(``FixedCapacityStepper.step(..., group=...)``, ``Group.mean_tree``).  The
JAX package stacks the state over a ``Mesh`` and runs one program under
``shard_map``, compiled and donated; here each rank is a process with its
own state on its own device, started by ``spawn`` (or by a launcher such as
``torchrun``, then ``distributed.global_group``), and runs its steps as
CUDA graphs (``build_parallel_steps``; on gloo the train frame's average
runs between two graphs, ``core/graphs.py`` ``StepperGraphs``).  Batch-norm statistics of the policy and its
running cost stay per rank, as per device in JAX; so do the sampling
generators, seeded apart.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import socket
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from blockcopy_tpu_torch.core.graphs import StepperGraphs
from blockcopy_tpu_torch.device import resolve_device
from blockcopy_tpu_torch.parallel.distributed import (Group,
                                                      default_backend,
                                                      detect_env,
                                                      global_group, join,
                                                      maybe_initialize)
from blockcopy_tpu_torch.policy.optim import tree_leaves


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """The ranks to start: rank r on ``devices[r]``, joined by
    ``backend``."""
    devices: Tuple[str, ...]
    backend: str

    @property
    def size(self) -> int:
        return len(self.devices)


def make_group(n_devices: int, devices: Optional[Sequence] = None,
               backend: Optional[str] = None) -> GroupSpec:
    """``n_devices`` ranks on the first ``n_devices`` of ``devices``
    (default: every CUDA device, one rank each).  A device may repeat (two
    ranks on one card) where the backend allows it: NCCL does not."""
    avail = [f"cuda:{i}" for i in range(torch.cuda.device_count())] \
        if devices is None else [str(torch.device(d)) for d in devices]
    if n_devices > len(avail):
        # silently running fewer ranks would drop clips without an error
        raise ValueError(f"requested {n_devices} devices but only "
                         f"{len(avail)} available")
    chosen = tuple(avail[:n_devices])
    backend = backend or default_backend(chosen[0])
    if backend == "nccl" and len(set(chosen)) < len(chosen):
        raise ValueError(f"NCCL takes one rank per GPU, got {chosen}: pass "
                         f"backend='gloo' to put several ranks on one card")
    return GroupSpec(chosen, backend)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, spec: GroupSpec, port: int, out_dir: str,
               fn: Callable, args: tuple) -> None:
    device = torch.device(spec.devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif "OMP_NUM_THREADS" not in os.environ:
        # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // spec.size))
    # a world of one joins too (``maybe_initialize`` would not): its
    # collectives then run on the backend asked for
    join(f"127.0.0.1:{port}", spec.size, rank, spec.backend, device)
    try:
        group = global_group(None, device)
        group.barrier()     # every rank is up before any work
        out = fn(group, *args)
        with open(Path(out_dir) / f"{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(spec: GroupSpec, fn: Callable, *args,
          timeout: Optional[float] = None) -> list:
    """Run ``fn(group, *args)`` in one process per rank (the ``spawn``
    start method, as CUDA needs) and return each rank's result, in rank
    order.  ``fn`` and ``args`` are pickled: ``fn`` must be importable.
    A rank that raises fails the call (the others are stopped); so does a
    run longer than ``timeout`` seconds."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(spec, port, out_dir, fn, args),
            nprocs=spec.size, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            # join raises as soon as one rank fails, stopping the others
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{spec.size} ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(30)
        results = []
        for rank in range(spec.size):
            with open(Path(out_dir) / f"{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results


def _spawned(group: Group, run: Callable, argv: list):
    return run(argv, group.device, group)


def launch(num_devices: int, device, run: Callable, argv: list):
    """Run a CLI's ``run(argv, device, group)`` as the launch asks, and
    return rank 0's result (None on the other ranks):

    - ``num_devices`` > 1 and no launcher: ``num_devices`` ranks spawned
      here, rank r on ``cuda:r`` (or all on the CPU, on gloo, for
      ``device`` "cpu"); the CUDA kernels are built once first, so the
      ranks load them; ``run`` must be importable;
    - a launcher's environment (``WORLD_SIZE`` > 1): this process is one
      rank, on ``cuda:LOCAL_RANK``;
    - else one process, with ``group`` None.

    Nothing falls back: a rank or a backend that fails raises."""
    device = resolve_device(device)
    if num_devices > 1 and detect_env() is None:
        spec = make_group(num_devices, [device.type] * (os.cpu_count() or 1)
                          if device.type == "cpu" else None)
        if device.type == "cuda":
            from blockcopy_tpu_torch.ops.kernels import build
            build.build(["halo", "bottleneck"])
        return spawn(spec, _spawned, run, argv)[0]
    if device.type == "cuda" and detect_env() is not None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    owned = not dist.is_initialized() and maybe_initialize(device=device)
    try:
        if not dist.is_initialized():
            return run(argv, device, None)
        return run(argv, device, global_group(
            num_devices if num_devices > 1 else None, device))
    finally:
        if owned:
            dist.destroy_process_group()


def rank_clips(count: int, rank: int, size: int, pad: bool = False):
    """The clips rank ``rank`` steps when ``count`` clips go out in groups
    of ``size`` consecutive clips, clip d of a group to rank d, and whether
    each is real.  A partial final group is dropped, or with ``pad`` filled
    by repeating the last clip (its results are then thrown away)."""
    groups = -(-count // size) if pad else count // size
    wanted = [g * size + rank for g in range(groups)]
    return [min(i, count - 1) for i in wanted], [i < count for i in wanted]


class ClipSubset:
    """``dataset`` seen through a list of indices (``rank_clips``)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def rank_seed(seed: int, rank: int) -> int:
    """The sampling generator's seed of ``rank``: distinct per rank."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def init_parallel_state(stepper, model_params, seed: int, rank: int) -> dict:
    """One rank's carried state: the policy parameters and optimizer state
    start identical on every rank (the same ``seed``; they stay equal
    because the gradients are averaged), while each rank's sampling
    generator is seeded apart, so each clip explores its own grids."""
    state = stepper.init_state(model_params, seed=seed)
    gen = torch.Generator(stepper.device).manual_seed(rank_seed(seed, rank))
    state["policy"] = {**state["policy"], "generator": gen}
    return state


def build_parallel_steps(stepper, group: Group):
    """``(first_step, step)`` of ``stepper`` with ``group`` bound, as CUDA
    graphs (``core/graphs.py`` ``StepperGraphs``; JAX's sharded, donated
    step): a train step averages its REINFORCE gradients over the group.
    They update the state in place and return it."""
    graphs = StepperGraphs(stepper, group)
    return graphs.first_step, graphs.step


def params_digest(params) -> str:
    """sha256 of a parameter tree's bytes (leaf order), to compare ranks."""
    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dryrun_rank(group: Group) -> Tuple[str, str]:
    from blockcopy_tpu_torch.core.stepper import (FixedCapacityStepper,
                                                  StepperConfig)
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    frame_shape = (1, 256, 256, 3)
    cfg = SwiftNetConfig(backbone="resnet18", num_classes=19)
    params = init_swiftnet(cfg, seed=0, device=group.device)
    stepper = FixedCapacityStepper(
        make_apply_fn(cfg), StepperConfig(block_size=128, train_interval=1),
        frame_shape, capacity=2, device=group.device)
    state = init_parallel_state(stepper, params, 1, group.rank)
    before = params_digest(state["policy"]["params"])
    first, step = build_parallel_steps(stepper, group)
    rs = np.random.RandomState(0)
    frames = [torch.from_numpy(rs.randn(group.size, *frame_shape).astype(
        np.float32)[group.rank]).to(group.device) for _ in range(2)]
    state = first(params, state, frames[0])
    state = step(params, state, frames[1])      # trains: averaged update
    out = stepper.fetch_outputs(state)
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError(f"rank {group.rank}: non-finite outputs")
    return before, params_digest(state["policy"]["params"])


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One first step and one training step on RN18 256x256 (block 128,
    capacity 2) in ``n_devices`` ranks on ``device`` (default CUDA, one
    rank per card; "cpu": gloo ranks on the CPU); the policy parameters
    must come out bitwise equal on every rank, and changed."""
    kind = resolve_device(device).type
    spec = make_group(n_devices, [kind] * n_devices if kind == "cpu"
                      else None)
    before, after = zip(*spawn(spec, _dryrun_rank, timeout=900))
    if len(set(after)) != 1:
        raise AssertionError(f"policy parameters differ across ranks: "
                             f"{after}")
    if after[0] == before[0]:
        raise AssertionError("the training step left the policy unchanged")
    print(f"dryrun_multichip({n_devices}, {kind}): ok, policy "
          f"{after[0][:16]} on every rank")
