"""PyTorch/CUDA port of ``blockcopy_tpu``: block-sparse video inference with
an online REINFORCE execution policy, for NVIDIA Hopper GPUs.

The JAX package ``blockcopy_tpu`` is the reference; this package mirrors its
module paths, public names and shapes (NHWC blocks, block-layout canvases
with a zero sentinel row) and imports nothing of it.  The two Pallas kernels
of the reference are CUDA C++ kernels here (``csrc/``), built at first use.

Entry points (``init_swiftnet``, ``init_csp``, ``init_policy_net``,
``FixedCapacityStepper``, ``DetectionStepper``, ``BlockCopyModel``,
``CSPBlockCopy``, ``build_policy_from_settings``, ``build_detector``, the
checkpoint loaders, and the CLIs ``tasks/semseg/eval.py`` and
``tasks/detection/eval.py`` through ``--device``) default to CUDA and raise
when no GPU is present unless the caller asks for the CPU.

The public names are imported on first use, so ``import blockcopy_tpu_torch``
loads no model code and builds no kernel.
"""

from importlib import import_module

from blockcopy_tpu_torch.device import resolve_device

__version__ = "0.1.0"

_LAZY = {
    "add_argparser_arguments": "core.argparser",
    "BlockCopyModel": "core.engine",
    "blockcopy_noblocks": "core.engine",
    "BlockPack": "core.blocked",
    "is_block": "core.blocked",
    "split_dense": "core.blocked",
    "combine": "core.blocked",
    "to_dense": "core.blocked",
    "build_policy_from_settings": "policy.policies",
}

__all__ = list(_LAZY) + ["resolve_device"]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(import_module(f"{__name__}.{_LAZY[name]}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
