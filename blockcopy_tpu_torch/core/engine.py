"""BlockCopy execution helpers (counterpart of
``blockcopy_tpu/core/engine.py``; ladder mode's ``BlockCopyModel`` is not
ported yet)."""

from __future__ import annotations

from typing import Callable

from blockcopy_tpu_torch.core.blocked import BlockPack, ExecCtx, split_dense


def noblocks(ctx: ExecCtx, name: str, x, fn: Callable):
    """Run ``fn(dense_ctx, dense_x)`` densely inside a blocked model: combine
    the blocks through a persistent canvas, apply ``fn``, gather the executed
    blocks of the result (``engine.py:44``)."""
    if not isinstance(x, BlockPack) or ctx.is_dense:
        return fn(ctx.as_dense(), x)
    dense = ctx.store_dense(name, x)
    y = fn(ctx.as_dense(), dense)
    return split_dense(y, ctx.idx, ctx.n, ctx.gh, ctx.gw)
