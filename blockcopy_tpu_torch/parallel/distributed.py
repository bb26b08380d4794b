"""Multi-process startup and the collectives of clip-level data parallelism
(counterpart of ``blockcopy_tpu/parallel/distributed.py``).

The JAX package runs one controller over a device mesh; the port runs one
process per device and joins them with ``torch.distributed``:

- ``maybe_initialize()``: call once at CLI startup, before the first device
  use.  Resolves the coordinator, process count and process id from (in
  order) explicit arguments, the torch launcher's environment
  (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, the
  reference's ``Pedestron/mmdet/apis/env.py:22-29`` contract) or the JAX
  package's (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
  ``JAX_PROCESS_ID``).  A single process is a strict no-op.
- ``global_group(n)``: this process's ``Group`` of an ``n``-rank launch;
  each process drives one device, so ``n`` is the world size.
- ``Group``: one rank's view of the group and the few collectives the CLIs
  need; ``mean_tree`` averages the policy's REINFORCE gradients in one
  ``all_reduce`` of one flat fp32 buffer, so every rank gets the same bits.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from blockcopy_tpu_torch.policy.optim import tree_leaves, tree_map

logger = logging.getLogger(__name__)

# how long ranks wait for each other: at startup for the coordinator, then
# in every collective
TIMEOUT = datetime.timedelta(minutes=10)


def detect_env() -> Optional[dict]:
    """Multi-process launch parameters from the environment, or None when
    nothing names a second process (the single-process case).  The same
    dict as the JAX package's for the same environment."""
    if "WORLD_SIZE" in os.environ and int(os.environ["WORLD_SIZE"]) > 1:
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT", "8476")
        return {
            "coordinator_address": f"{addr}:{port}",
            "num_processes": int(os.environ["WORLD_SIZE"]),
            "process_id": int(os.environ.get("RANK", "0")),
        }
    if "JAX_NUM_PROCESSES" in os.environ \
            and int(os.environ["JAX_NUM_PROCESSES"]) > 1:
        return {
            "coordinator_address": os.environ.get(
                "JAX_COORDINATOR_ADDRESS", "127.0.0.1:8476"),
            "num_processes": int(os.environ["JAX_NUM_PROCESSES"]),
            "process_id": int(os.environ.get("JAX_PROCESS_ID", "0")),
        }
    return None


def default_backend(device) -> str:
    """``nccl`` for a rank on a CUDA device, ``gloo`` on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> bool:
    """Join the process group if this is a multi-process launch; otherwise
    do nothing.  Explicit arguments win over the environment; ``backend``
    defaults to ``default_backend(device)``.  Returns True iff the process
    group is up.  Idempotent."""
    if dist.is_initialized():
        return True
    if num_processes is None:
        env = detect_env()
        if env is None:
            if coordinator_address is None:
                return False  # single process: no-op
            raise ValueError(
                f"coordinator {coordinator_address} given without a process "
                f"count: torch.distributed needs num_processes")
        coordinator_address = env["coordinator_address"]
        num_processes = env["num_processes"]
        process_id = env["process_id"]
    if num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process launch needs the coordinator "
                         "address and this process's id")
    join(coordinator_address, num_processes, process_id, backend, device)
    return True


def join(coordinator_address: str, num_processes: int, process_id: int,
         backend: Optional[str] = None, device="cuda") -> None:
    """Join the process group as rank ``process_id`` of ``num_processes``
    (a world of one too) through ``tcp://coordinator_address``;
    ``backend`` defaults to ``default_backend(device)``.  The one way the
    port's processes join, whether a launcher or ``clip_parallel.spawn``
    started them."""
    backend = backend or default_backend(device)
    logger.info("torch.distributed.init_process_group(%s, tcp://%s, "
                "world_size=%d, rank=%d)", backend, coordinator_address,
                num_processes, process_id)
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_group(n_devices: Optional[int] = None,
                 device="cuda") -> "Group":
    """This process's ``Group`` over the whole launch, its rank on
    ``device``.  ``n_devices`` (default: the world size) must be divisible
    by the process count, as in the JAX package; since each process drives
    one device, it must also equal it."""
    procs = _world()
    n = procs if n_devices is None else n_devices
    if n % procs != 0:
        raise ValueError(
            f"n_devices={n} not divisible by process count {procs}: every "
            f"host must drive the same number of clips")
    if n != procs:
        raise ValueError(
            f"n_devices={n} with {procs} processes: each process drives one "
            f"device, so launch {n} processes")
    return Group(_rank(), procs, torch.device(device),
                 dist.group.WORLD if dist.is_initialized() else None)


def local_batch_slice(n_devices: int):
    """Index range [lo, hi) of the global clip-lane batch owned by this
    process."""
    per = n_devices // _world()
    pid = _rank()
    return pid * per, (pid + 1) * per


class Group:
    """One rank's view of a clip-parallel group: its ``rank`` of ``size``,
    its ``device`` and the process group the collectives run on (None: a
    world of one, whose collectives are the identity).  Collectives on
    tensors run on ``device``, as NCCL needs."""

    def __init__(self, rank: int, size: int, device, pg=None):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.pg = pg

    @property
    def capturable(self) -> bool:
        """Whether the collectives can run inside a CUDA graph: a world of
        one has none; NCCL's can, once the communicator has run one (a
        graph's eager first call does); gloo stages a CUDA tensor through
        the host, which syncs."""
        return self.pg is None or dist.get_backend(self.pg) == "nccl"

    def mean_tree(self, tree):
        """``tree`` averaged over the ranks: its leaves flattened into one
        fp32 buffer, one ``all_reduce(SUM)``, a division by the world size
        (gloo has no AVG), and the leaves cut back out.  Every rank gets
        the same bits.  No host sync on NCCL."""
        leaves = tree_leaves(tree)
        flat = torch.cat([t.reshape(-1).float() for t in leaves])
        if self.pg is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.pg)
        flat.div_(self.size)
        parts = iter(torch.split(flat, [t.numel() for t in leaves]))
        return tree_map(lambda t: next(parts).view(t.shape).to(t.dtype),
                        tree)

    def sum_array(self, a: np.ndarray) -> np.ndarray:
        """A host array summed over the ranks (float64), on every rank;
        ``a`` itself is left as it was."""
        t = torch.tensor(np.asarray(a, np.float64), device=self.device)
        if self.pg is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg)
        return t.cpu().numpy()

    def gather_objects(self, obj) -> List:
        """Every rank's ``obj`` (picklable), in rank order, on every rank."""
        if self.pg is None:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.pg)
        return out

    def barrier(self) -> None:
        """Wait for every rank (a collective on ``device``, so a fence of
        the work queued before it where the backend is NCCL)."""
        if self.pg is not None:
            self.sum_array(np.zeros(1))
