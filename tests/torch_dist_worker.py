"""One process of the real two-process gloo run of
``tests/test_torch_distributed.py`` (the port's counterpart of
``tests/dist_worker.py``).

Started with the torch launcher's environment (``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``), it joins the group through
``maybe_initialize``, checks ``global_group``, ``local_batch_slice`` and the
group's collectives, then steps one clip of RN18 128x256 (block 64,
capacity 4, REINFORCE on every frame) with the gradients averaged over the
two processes, and prints its rank's policy digests before and after:
``POLICY_DIGEST RANK<r> <before> <after>``.

Not collected by pytest (no ``test_`` prefix); run as
``python torch_dist_worker.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def main():
    from blockcopy_tpu_torch.core.stepper import (FixedCapacityStepper,
                                                  StepperConfig)
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    from blockcopy_tpu_torch.parallel import clip_parallel, distributed

    torch.set_num_threads(1)
    assert distributed.maybe_initialize(device="cpu") is True
    try:
        assert dist.get_backend() == "gloo"
        group = distributed.global_group(2, "cpu")
        rank = group.rank
        assert (group.size, dist.get_rank()) == (2, rank)
        assert distributed.local_batch_slice(2) == (rank, rank + 1)
        assert group.gather_objects(rank * 10) == [0, 10]
        assert float(group.sum_array(np.float64(rank + 1))) == 3.0

        cfg = SwiftNetConfig(backbone="resnet18", num_classes=19)
        params = init_swiftnet(cfg, seed=0, device="cpu")
        frame_shape = (1, 128, 256, 3)
        stepper = FixedCapacityStepper(
            make_apply_fn(cfg), StepperConfig(block_size=64,
                                              train_interval=1),
            frame_shape, capacity=4, device="cpu")
        state = clip_parallel.init_parallel_state(stepper, params, 4, rank)
        before = clip_parallel.params_digest(state["policy"]["params"])
        first, step = clip_parallel.build_parallel_steps(stepper, group)
        rs = np.random.RandomState(5)      # the same draws on both ranks
        lo, hi = distributed.local_batch_slice(2)
        frames = [torch.from_numpy(rs.randn(2, *frame_shape).astype(
            np.float32)[lo]) for _ in range(2)]
        state = first(params, state, frames[0])
        state = step(params, state, frames[1])     # trains, averaged
        after = clip_parallel.params_digest(state["policy"]["params"])
        print(f"POLICY_DIGEST RANK{rank} {before} {after}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
