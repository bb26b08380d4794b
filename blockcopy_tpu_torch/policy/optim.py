"""RMSprop with ``torch.optim.RMSprop`` semantics over a parameter tree
(counterpart of ``blockcopy_tpu/policy/optim.py``):

    g   <- g + wd * p
    sq  <- alpha * sq + (1 - alpha) * g^2
    buf <- mu * buf + g / (sqrt(sq) + eps)      (if momentum mu > 0)
    p   <- p - lr * buf            (or p - lr * g / (sqrt(sq)+eps) if mu == 0)

Trees are nested dicts/lists of tensors; the state is
``{"square_avg": tree, "momentum_buf": tree}``.  ``update`` returns new
trees; ``update_`` writes the same values into the given ones (a CUDA graph
keeps the tensors it captured, ``core/graphs.py``).  Both are
``ops/kernels/policy.py`` ``rmsprop_multi`` over the trees' leaves: on
CUDA one launch for all of them.
"""

from __future__ import annotations

import torch

from blockcopy_tpu_torch.ops.kernels.policy import rmsprop_multi


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


def _leaves(grads, state, params):
    return ([g.contiguous() for g in tree_leaves(grads)],
            tree_leaves(params), tree_leaves(state["square_avg"]),
            tree_leaves(state["momentum_buf"]))


def _like(tree, leaves):
    """``tree``'s structure with ``leaves`` in its leaves' order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def update(grads, state, params, lr: float = 1e-4,
           weight_decay: float = 1e-3, momentum: float = 0.0,
           alpha: float = 0.99, eps: float = 1e-8):
    """One step; returns ``(new_params, new_state)`` (the momentum
    buffers as given where ``momentum`` is 0)."""
    with torch.no_grad():
        p, sq, buf = rmsprop_multi(
            *_leaves(grads, state, params), lr=lr,
            weight_decay=weight_decay, momentum=momentum, alpha=alpha,
            eps=eps)
    return _like(params, p), {"square_avg": _like(params, sq),
                              "momentum_buf": _like(params, buf)}


def update_(grads, state, params, lr: float = 1e-4,
            weight_decay: float = 1e-3, momentum: float = 0.0,
            alpha: float = 0.99, eps: float = 1e-8) -> None:
    """``update`` written into ``params`` and ``state``'s tensors, bitwise
    its values."""
    g, p, sq, buf = _leaves(grads, state, params)
    with torch.no_grad():
        rmsprop_multi(g, p, sq, buf, (p, sq, buf), lr=lr,
                      weight_decay=weight_decay, momentum=momentum,
                      alpha=alpha, eps=eps)


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
