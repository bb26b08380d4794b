"""Plain PyTorch references of the benchmark's configurations.

Float32 with TF32 off (``plain_fp32``), NCHW, no kernels, no caches and
no batching.  Nothing here imports the served program, JAX or the JAX
package: the references are the yardstick the program is held to.

A configuration names its reference's forward by a dotted path
(``"reference": "reference.nets.swiftnet"``); ``model`` finds it, and the
spec of its parameters beside it as ``spec_<name>``.  A new architecture
is a new module here that its configuration names.
"""

import contextlib
import importlib
from typing import Callable, Dict, Tuple

import torch


def model(cfg: Dict) -> Tuple[Callable, Callable]:
    """(forward, spec) of ``cfg["reference"]``: ``forward(fr, p, x, cfg)``
    and ``spec(cfg)``, the tree of ``nets.Leaf`` its parameters are drawn
    from."""
    where, name = cfg["reference"].rsplit(".", 1)
    mod = importlib.import_module(where)
    return getattr(mod, name), getattr(mod, f"spec_{name}")


@contextlib.contextmanager
def plain_fp32():
    """Float32 means float32 on the card: TF32 off for matmuls and cuDNN
    inside, the program's settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
