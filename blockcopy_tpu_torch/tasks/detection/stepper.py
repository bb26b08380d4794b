"""Detection speed mode: the CSP frame step with decode, NMS, the output
representation and the IoU information gain all on the device
(counterpart of ``blockcopy_tpu/tasks/detection/stepper.py``).

Carried task state: ``dets (K, 5)``, ``labels (K,)``, ``valid (K,)`` and
their ``*_prev`` copies, K = ``CSPConfig.max_per_img``.  A steady step reads
nothing back to the host; the boxes leave the card only when the caller
fetches them.
"""

from __future__ import annotations

import torch

from blockcopy_tpu_torch.core.stepper import (FixedCapacityStepper,
                                              StepperConfig)
from blockcopy_tpu_torch.models.csp import CSPConfig, csp_decode, make_apply_fn
from blockcopy_tpu_torch.tasks.detection.information_gain import (
    SUBSAMPLE,
    instance_mask_fixed,
    iou_gain_fixed,
)
from blockcopy_tpu_torch.utils import profiler


class DetectionStepper(FixedCapacityStepper):
    task_keys = ("dets", "labels", "valid")

    def __init__(self, csp_cfg: CSPConfig, cfg: StepperConfig, frame_shape,
                 capacity: int, dtype=torch.float32, device=None):
        if frame_shape[0] != 1:
            raise ValueError("the detection stepper takes one clip (N = 1)")
        super().__init__(make_apply_fn(csp_cfg), cfg, frame_shape, capacity,
                         dtype=dtype, device=device)
        self.csp_cfg = csp_cfg
        self.img_shape = (frame_shape[1], frame_shape[2])

    # -- task hooks -----------------------------------------------------------

    def _model_fn(self, params, pack, ctx):
        cls_s, bbox_p, off_p = self.apply_fn(params, pack, ctx)
        profiler.mark("blocks", cls_s)
        if cls_s.is_meta:
            # the shape pass: the decode's output shapes, without running it
            k = self.csp_cfg.max_per_img
            empty = lambda *shape, dt: torch.empty(shape, dtype=dt,
                                                   device=cls_s.device)
            return {"dets": empty(k, 5, dt=torch.float32),
                    "labels": empty(k, dt=torch.int32),
                    "valid": empty(k, dt=torch.bool)}
        dets, labels, valid = csp_decode(cls_s, bbox_p, off_p,
                                         self.img_shape, self.csp_cfg)
        profiler.mark("outputs", dets)
        return {"dets": dets, "labels": labels, "valid": valid}

    def fetch_outputs(self, state):
        """The fixed-size (dets, labels, valid) of the last frame."""
        return state["dets"], state["labels"], state["valid"]

    def _output_repr(self, state):
        h, w = self.img_shape
        scale = 0.25 * 128 / self.cfg.block_size
        return instance_mask_fixed(state["dets"], state["labels"],
                                   state["valid"],
                                   (int(h * scale), int(w * scale)),
                                   self.csp_cfg.cls_out_channels, scale)

    def _information_gain(self, state):
        return iou_gain_fixed(state["dets"], state["labels"], state["valid"],
                              state["dets_prev"], state["labels_prev"],
                              state["valid_prev"], self.img_shape, SUBSAMPLE)
