"""PyTorch/CUDA port of ``blockcopy_tpu``: block-sparse video inference with
an online REINFORCE execution policy, for NVIDIA Hopper GPUs.

The JAX package ``blockcopy_tpu`` is the reference; this package mirrors its
module paths and public shapes (NHWC blocks, block-layout canvases with a
zero sentinel row) and imports nothing of it.  The two Pallas kernels of the
reference are CUDA C++ kernels here (``csrc/``), built at first use.

Entry points (``init_swiftnet``, ``init_policy_net``,
``FixedCapacityStepper``, ``BlockCopyModel``, ``build_policy_from_settings``,
the checkpoint loaders, and ``tasks/semseg/eval.py`` through ``--device``)
default to CUDA and raise when no GPU is present unless the caller asks for
the CPU.
"""

from blockcopy_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
