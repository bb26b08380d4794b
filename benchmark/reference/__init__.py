"""Plain PyTorch references of the benchmark's configurations.

Float32 with TF32 off (``plain_fp32``), NCHW, no kernels, no caches and
no batching.  Nothing here imports the served program, JAX or the JAX
package: the references are the yardstick the program is held to.
"""

import contextlib

import torch


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
