"""Information-gain reward for the REINFORCE policy (counterpart of
``blockcopy_tpu/policy/information_gain.py``)."""

from __future__ import annotations

import torch

from blockcopy_tpu_torch.ops.layers import resize_bilinear


def semseg_output_repr(outputs: torch.Tensor) -> torch.Tensor:
    """Output representation fed to the policy net: the raw logits
    (``information_gain.py:20``)."""
    return outputs


def semseg_information_gain(outputs: torch.Tensor,
                            outputs_prev: torch.Tensor,
                            scale_factor: float = 0.25) -> torch.Tensor:
    """KL(prev || cur) per pixel at ``scale_factor``, mean over classes:
    (N, h, w, 1) fp32."""
    n, h, w, c = outputs.shape
    oh, ow = int(h * scale_factor), int(w * scale_factor)
    cur = resize_bilinear(outputs.float(), (oh, ow))
    prev = resize_bilinear(outputs_prev.float(), (oh, ow))
    log_p = torch.log_softmax(cur, dim=-1)
    log_q = torch.log_softmax(prev, dim=-1)
    kl = torch.exp(log_q) * (log_q - log_p)
    return kl.mean(dim=-1, keepdim=True)
