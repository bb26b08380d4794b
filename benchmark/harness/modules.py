"""The modules that no process of a run may hold once its window has
closed: JAX, jaxlib, flax and the JAX package, compared by top-level name
whole (``blockcopy_tpu_torch`` begins with ``blockcopy_tpu``)."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "blockcopy_tpu")


def forbidden_modules():
    """This process's loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
