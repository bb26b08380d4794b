"""Rank bodies that the ``test_torch_*`` files spawn through
``blockcopy_tpu_torch.parallel.clip_parallel.spawn`` (importable by the
spawned processes; this module imports neither JAX nor the JAX package)."""

import contextlib
import copy

import numpy as np
import torch

from blockcopy_tpu_torch.tools.measure import RecordingGroup
from blockcopy_tpu_torch.utils.convert import params_to_numpy


def clip_rank(group, backbone, shape, capacity, policy, params, frames,
              draws):
    """One rank of ``test_torch_clip_parallel.py``: the fast-arch stepper
    (fp32 policy convs, REINFORCE on every frame) from the given JAX policy
    state over its own clip, fed its JAX device's draws, the gradients
    averaged over the group; ``frames`` and ``draws`` hold every rank's,
    by rank.  Returns every frame's state and the gradient records, as
    numpy."""
    import blockcopy_tpu_torch.policy.net as TN
    from blockcopy_tpu_torch.core.stepper import (FixedCapacityStepper,
                                                  StepperConfig)
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     make_apply_fn)
    from blockcopy_tpu_torch.parallel import clip_parallel
    from blockcopy_tpu_torch.utils.convert import (params_from_jax,
                                                   policy_state_from_jax,
                                                   stepper_state_to_numpy)

    TN.COMPUTE_DTYPE = torch.float32
    cfg = SwiftNetConfig(backbone=backbone)
    stepper = FixedCapacityStepper(
        make_apply_fn(cfg), StepperConfig(policy_arch="fast",
                                          train_interval=1),
        shape, capacity, device="cpu")
    params = params_from_jax(params, device="cpu")
    state = clip_parallel.init_parallel_state(stepper, params, 1, group.rank)
    state["policy"] = {**policy_state_from_jax(policy, device="cpu"),
                       "generator": state["policy"]["generator"]}
    rec = RecordingGroup(group)
    first, step = clip_parallel.build_parallel_steps(stepper, rec)
    frames, draws = frames[group.rank], draws[group.rank]
    out = []
    for t, frame in enumerate(frames):
        frame = torch.from_numpy(frame)
        if t == 0:
            state = first(params, state, frame)
        else:
            u, u_rank = (torch.from_numpy(d) for d in draws[t - 1])
            state = step(params, state, frame, draws=(u, u_rank))
        # copies: the step updates the canvases in place
        out.append(copy.deepcopy(stepper_state_to_numpy(state)))
    return out, [tuple(params_to_numpy(x) for x in r) for r in rec.records]


def card_rank(group, frames=4):
    """One rank of the GPU test: RN18 256x512 fp32 fast-policy stepper,
    capacity 4, REINFORCE every 2nd frame, gradients averaged over the
    group; each rank steps its own clip.  Returns the rank's kernel
    launches and its policy digest after every frame."""
    from blockcopy_tpu_torch.ops import kernels
    from blockcopy_tpu_torch.parallel import clip_parallel
    from blockcopy_tpu_torch.tools.measure import (swiftnet_stepper,
                                                   synthetic_frames)
    params, stepper = swiftnet_stepper("resnet18", (1, 256, 512, 3), 4,
                                       torch.float32, group.device,
                                       train_interval=2)
    clip = synthetic_frames((1, 256, 512, 3), frames, torch.float32,
                            seed=group.rank, device=group.device)
    kernels.reset_launches()
    state = clip_parallel.init_parallel_state(stepper, params, 1,
                                              group.rank)
    first, step = clip_parallel.build_parallel_steps(stepper, group)
    digests = []
    for t, frame in enumerate(clip):
        state = (step if t else first)(params, state, frame)
        digests.append(clip_parallel.params_digest(
            state["policy"]["params"]))
    torch.cuda.synchronize()
    return dict(kernels.launches), digests


@contextlib.contextmanager
def kept_confusion_matrices():
    """While the block runs, every confusion matrix that the semseg
    metrics report from (``StreamSegMetrics.get_results``) is copied into
    the list it yields."""
    from blockcopy_tpu_torch.utils.metrics import StreamSegMetrics
    matrices = []
    results = StreamSegMetrics.get_results

    def keep(self):
        matrices.append(np.array(self.confusion_matrix, copy=True))
        return results(self)

    StreamSegMetrics.get_results = keep
    try:
        yield matrices
    finally:
        StreamSegMetrics.get_results = results


def semseg_cli_rank(group, argv):
    """One rank of the semseg CLI's clip-parallel run
    (``tasks/semseg/eval.py`` ``_run``, as ``clip_parallel.launch`` starts
    it), with the CLI's log kept.  Returns the rank's result (rank 0's
    dict, None elsewhere), its log messages and the confusion matrices it
    reported from."""
    import logging

    from blockcopy_tpu_torch.tasks.semseg import eval as tcli

    messages = []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    log = logging.getLogger("blockcopy_tpu_torch.semseg")
    log.setLevel(logging.INFO)
    log.addHandler(Keep())
    with kept_confusion_matrices() as matrices:
        out = tcli._run(argv, group.device, group)
    return out, messages, matrices
