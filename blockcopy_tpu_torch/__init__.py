"""PyTorch/CUDA port of ``blockcopy_tpu``: block-sparse video inference with
an online REINFORCE execution policy, for NVIDIA Hopper GPUs.

The JAX package ``blockcopy_tpu`` is the reference; this package mirrors its
module paths and public shapes (NHWC blocks, block-layout canvases with a
zero sentinel row) and imports nothing of it.  The two Pallas kernels of the
reference are CUDA C++ kernels here (``csrc/``), built at first use.

Entry points (``init_swiftnet``, ``init_policy_net``,
``FixedCapacityStepper``) default to ``device="cuda"`` and raise when no GPU
is present unless the caller passes ``device="cpu"``.
"""

from blockcopy_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
