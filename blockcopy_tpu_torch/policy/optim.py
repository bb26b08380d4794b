"""RMSprop with ``torch.optim.RMSprop`` semantics over a parameter tree
(counterpart of ``blockcopy_tpu/policy/optim.py``):

    g   <- g + wd * p
    sq  <- alpha * sq + (1 - alpha) * g^2
    buf <- mu * buf + g / (sqrt(sq) + eps)      (if momentum mu > 0)
    p   <- p - lr * buf            (or p - lr * g / (sqrt(sq)+eps) if mu == 0)

Trees are nested dicts/lists of tensors; the state is
``{"square_avg": tree, "momentum_buf": tree}``.  ``update`` returns new
trees; ``update_`` writes the same values into the given ones (a CUDA graph
keeps the tensors it captured, ``core/graphs.py``).
"""

from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """Map ``fn`` over the tensor leaves of equally structured trees."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def init(params):
    return {"square_avg": tree_map(torch.zeros_like, params),
            "momentum_buf": tree_map(torch.zeros_like, params)}


def update(grads, state, params, lr: float = 1e-4,
           weight_decay: float = 1e-3, momentum: float = 0.0,
           alpha: float = 0.99, eps: float = 1e-8):
    """One step; returns ``(new_params, new_state)``."""
    def upd(g, sq, buf, p):
        g = g + weight_decay * p
        sq = alpha * sq + (1.0 - alpha) * g * g
        step = g / (torch.sqrt(sq) + eps)
        if momentum > 0:
            buf = momentum * buf + step
            step = buf
        return p - lr * step, sq, buf

    out = tree_map(upd, grads, state["square_avg"], state["momentum_buf"],
                   params)
    return _pick(out, 0), {"square_avg": _pick(out, 1),
                           "momentum_buf": _pick(out, 2)}


def update_(grads, state, params, lr: float = 1e-4,
            weight_decay: float = 1e-3, momentum: float = 0.0,
            alpha: float = 0.99, eps: float = 1e-8) -> None:
    """``update`` written into ``params`` and ``state``'s tensors: each
    new value is ``update``'s expression, copied, so bitwise equal."""
    def upd(g, sq, buf, p):
        g = g + weight_decay * p
        sq.copy_(alpha * sq + (1.0 - alpha) * g * g)
        step = g / (torch.sqrt(sq) + eps)
        if momentum > 0:
            buf.copy_(momentum * buf + step)
            step = buf
        p.copy_(p - lr * step)

    with torch.no_grad():
        tree_map(upd, grads, state["square_avg"], state["momentum_buf"],
                 params)


def tree_copy_(dst, src) -> None:
    """Copy every leaf of ``src`` into the leaf of ``dst`` at its place
    (the same structure and shapes; dtypes convert)."""
    def put(d, s):
        if tuple(d.shape) != tuple(s.shape):
            raise ValueError(f"shape {tuple(s.shape)} into "
                             f"{tuple(d.shape)}")
        d.copy_(s)

    with torch.no_grad():
        tree_map(put, dst, src)


def _pick(tree, i):
    """Element ``i`` of every ``(p, sq, buf)`` leaf tuple of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
