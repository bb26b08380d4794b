"""Parameters drawn from the seed on the device: one standard-normal draw
for the whole tree on a generator of the device, then every leaf's mean
and scale in two more calls, in the served dtype."""

from __future__ import annotations

import numpy as np
import torch



def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one use of ``seed`` (any non-negative int)."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(
        2, np.uint64)[0] >> np.uint64(1))


def _leaves(spec, path=""):
    if isinstance(spec, dict):
        for k, v in spec.items():
            yield from _leaves(v, f"{path}{k}/")
    elif isinstance(spec, list):
        for i, v in enumerate(spec):
            yield from _leaves(v, f"{path}{i}/")
    else:
        yield path[:-1], spec


def _rebuild(spec, flat, path=""):
    if isinstance(spec, dict):
        return {k: _rebuild(v, flat, f"{path}{k}/") for k, v in spec.items()}
    if isinstance(spec, list):
        return [_rebuild(v, flat, f"{path}{i}/") for i, v in enumerate(spec)]
    return flat[path[:-1]]


def realize(spec, seed: int, dtype: torch.dtype, device) -> dict:
    """The tree of ``spec`` (``reference.nets.Leaf`` leaves) drawn from
    ``seed``: leaves in ``dtype``, ``f32`` leaves in float32."""
    leaves = list(_leaves(spec))
    sizes = [int(np.prod(l.shape)) for _, l in leaves]
    total = sum(sizes)
    gen = torch.Generator(device).manual_seed(seed)
    z = torch.randn((total,), generator=gen, device=device)
    counts = torch.tensor(sizes, device=device)
    mean = torch.repeat_interleave(torch.tensor(
        [l.mean for _, l in leaves], device=device), counts)
    std = torch.repeat_interleave(torch.tensor(
        [l.std for _, l in leaves], device=device), counts)
    vals = torch.addcmul(mean, std, z)
    served = vals.to(dtype)
    flat = {path: (part32 if leaf.f32 else part).view(leaf.shape)
            for (path, leaf), part, part32 in zip(
                leaves, served.split(sizes), vals.split(sizes))}
    return _rebuild(spec, flat)


def as_fp32(tree):
    """The same values in float32 (the reference's copy)."""
    if isinstance(tree, dict):
        return {k: as_fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_fp32(v) for v in tree]
    return tree.float()
