"""BlockCopy's online policy in plain PyTorch: the reference PolicyNet
(arch ``ref``), its input, the grid rounded to a fixed capacity, the
REINFORCE gradient and RMSprop.

The net always runs in train mode: BatchNorm normalises with the batch's
statistics (its running statistics are never read, so they are not kept
here).  Parameters are a nested dict of fp32 tensors; conv weights OIHW.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from reference.nets import Leaf, rounder

BN_EPS = 1e-5
RMS_ALPHA = 0.99
RMS_EPS = 1e-8


def in_channels(num_classes: int) -> int:
    """Frame, frame state, output representation, previous grid."""
    return 3 + 3 + num_classes + 1


def spec_policy(cin: int, width: int = 2) -> Dict:
    """The reference PolicyNet: a 3x3 conv, three basic blocks (strides 1,
    2, 2), three strided 3x3 convs; conv weights N(0, 2 / (k k cout)),
    BN gamma 1 and beta 0, the last conv's bias 0."""
    conv = lambda cout, ci, k: {"w": Leaf(
        (cout, ci, k, k), std=math.sqrt(2.0 / (k * k * cout)), f32=True)}
    norm = lambda c: {"gamma": Leaf((c,), 1.0, f32=True),
                      "beta": Leaf((c,), f32=True)}
    c1, c2, c3 = 16 * width, 32 * width, 64 * width
    p: Dict = {"conv1": conv(c1, cin, 3), "bn1": norm(c1)}
    for i, (a, b, s) in enumerate([(c1, c1, 1), (c1, c2, 2), (c2, c3, 2)]):
        blk = {"conv1": conv(b, a, 3), "bn1": norm(b), "conv2": conv(b, b, 3),
               "bn2": norm(b)}
        if s != 1 or a != b:
            blk["down_conv"] = conv(b, a, 1)
            blk["down_bn"] = norm(b)
        p[f"layer{i + 1}"] = blk
    p["head0"], p["head0_bn"] = conv(128, c3, 3), norm(128)
    p["head1"], p["head1_bn"] = conv(128, 128, 3), norm(128)
    p["head2"] = conv(1, 128, 3)
    p["head2"]["b"] = Leaf((1,), f32=True)
    return p


def _bn_train(x, p):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + BN_EPS) * p["gamma"].view(
        1, -1, 1, 1) + p["beta"].view(1, -1, 1, 1)


def policy_logits(p, x, prec=rounder("fp32")):
    """(1, Cin, h, w) -> (1, 1, h/32, w/32) logits."""
    def conv(t, q, stride=1):
        w = q["w"]
        y = F.conv2d(prec(t), prec(w), None, stride, (w.shape[2] - 1) // 2)
        return y + q["b"].view(1, -1, 1, 1) if "b" in q else y

    x = F.relu(_bn_train(conv(x, p["conv1"]), p["bn1"]))
    for i, s in enumerate((1, 2, 2)):
        q = p[f"layer{i + 1}"]
        idt = _bn_train(conv(x, q["down_conv"], s), q["down_bn"]) \
            if "down_conv" in q else x
        h = F.relu(_bn_train(conv(x, q["conv1"], s), q["bn1"]))
        x = F.relu(_bn_train(conv(h, q["conv2"]), q["bn2"]) + idt)
    for i in range(2):
        x = F.relu(_bn_train(conv(x, p[f"head{i}"], 2), p[f"head{i}_bn"]))
    return conv(x, p["head2"], 2)


def nearest(x, hw):
    """Nearest resize, source row ``i * h // oh``."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = hw
    if (oh, ow) == (h, w):
        return x
    ry = torch.arange(oh, device=x.device) * h // oh
    rx = torch.arange(ow, device=x.device) * w // ow
    return x.index_select(2, ry).index_select(3, rx)


def policy_input(frame, frame_state, out_repr, prev_grid, block_size):
    """The four sources at 1/4 * 128 / block_size of the frame: frame,
    frame state, output representation - 0.5, previous grid - 0.5."""
    h, w = frame.shape[2], frame.shape[3]
    scale = 0.25 * 128 / block_size
    hw = (int(h * scale), int(w * scale))
    return torch.cat([nearest(frame, hw), nearest(frame_state, hw),
                      nearest(out_repr, hw) - 0.5,
                      nearest(prev_grid.float()[None, None], hw) - 0.5], 1)


def select(flags, u_rank, capacity):
    """Exactly ``capacity`` blocks: the sampled ones first, ranked by
    ``u_rank``, then the unsampled, by ``u_rank``.  Numpy, any leading
    dims over (total,) rows."""
    scores = u_rank + 2.0 * flags
    order = np.argsort(-scores, axis=-1, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(order.shape[-1]) + 0 * order,
                      axis=-1)
    return rank < capacity


def grid_gap(probs, u, u_rank, grid, capacity) -> float:
    """How far a served grid lies from the probabilities: the least
    margin ``tau`` such that some samples ``u < p`` that differ from the
    reference's only at blocks with ``|u - p| < tau`` select the served
    grid (0 where the reference's own samples select it; 1 where no
    samples do).  All arguments flat (total,) numpy; ``grid`` bool."""
    probs = probs.astype(np.float32)
    on = u < probs
    if np.array_equal(select(on.astype(np.float32), u_rank, capacity), grid):
        return 0.0
    margin = np.abs(u.astype(np.float64) - probs)
    for tau in np.unique(margin):
        free = margin <= tau
        if _selectable(grid, on & ~free, ~on & ~free, u_rank, capacity):
            return float(tau)
    return 1.0


def _selectable(grid, fixed_on, fixed_off, u_rank, capacity) -> bool:
    """Whether samples that keep ``fixed_on`` sampled and ``fixed_off``
    unsampled (the rest free) can select ``grid``.  With at least
    ``capacity`` sampled the grid is the sampled blocks of highest
    ``u_rank``: every grid block sampled, every other sampled block ranked
    below them.  With fewer, every sampled block is in the grid and the
    grid's unsampled blocks outrank every block outside it."""
    if grid.sum() != capacity:
        return False
    inside = u_rank[grid]
    outside_on = u_rank[fixed_on & ~grid]
    if not (fixed_off & grid).any() and (
            outside_on.size == 0 or outside_on.max() < inside.min()):
        return True
    if (fixed_on & ~grid).any():
        return False
    best_out = u_rank[~grid].max(initial=-1.0)
    # grid blocks ranked under the best outside one must be sampled
    must_on = grid & (u_rank <= best_out)
    return not (must_on & fixed_off).any() and \
        (must_on | (fixed_on & grid)).sum() < capacity


def reinforce_grads(p, x, grid, signed, prec=rounder("fp32")):
    """d mean(-log p(grid) * signed) / d params, BN on batch statistics."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten(p).items()}
    with torch.enable_grad():
        l = policy_logits(unflatten(leaves), x, prec)[0, 0]
        g = grid.float()
        logp = g * F.logsigmoid(l) + (1 - g) * F.logsigmoid(-l)
        loss = torch.mean(-logp * signed)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads))


def flatten(tree, prefix=""):
    """{path: tensor} of a nested dict/list tree, paths joined by '/'."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat):
    """The nested dict of ``flatten``'s paths (list levels as dicts keyed
    by their index)."""
    out: Dict = {}
    for path, v in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out
