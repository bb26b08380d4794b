"""Street clips and the policy's uniforms, from the seed.

A clip is 20 frames of a street-like scene: a blocky background with fine
noise, fixed for the clip, and an inverted square sliding along the
diagonal (the generator of the program's ``tools/measure.py``
``street_frame``, on the device).  Every seed makes the same sizes and the
same motion; only the values and the square's start differ.  Frames are
normalized with ImageNet's mean and std, cast to the served dtype and kept
in pinned host memory, where a decoder would hand them over.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from harness.weights import sub_seed

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def street_clip(tr: Dict, h: int, w: int, length: int, seed: int,
                device) -> torch.Tensor:
    """(length, h, w, 3) uint8 frames of one clip."""
    gen = torch.Generator(device).manual_seed(seed)
    c = tr["coarse"]
    coarse = torch.randint(0, 240, (-(-h // c), -(-w // c), 3),
                           generator=gen, device=device, dtype=torch.int16)
    base = coarse.repeat_interleave(c, 0).repeat_interleave(c, 1)[:h, :w]
    base = base + torch.randint(0, tr["noise"], (h, w, 3), generator=gen,
                                device=device, dtype=torch.int16)
    side = min(tr["square"], h // 2)
    start = int(torch.randint(0, h - side, (1,), generator=gen,
                              device=device))
    frames = base[None].repeat(length, 1, 1, 1)
    for t in range(length):
        s = (start + tr["step"] * t) % (h - side)
        frames[t, s:s + side, s:s + side] = 255 - frames[t, s:s + side,
                                                          s:s + side]
    return frames.to(torch.uint8)


def normalize(frames: torch.Tensor, dtype) -> torch.Tensor:
    mean = torch.tensor(MEAN, device=frames.device) * 255
    std = torch.tensor(STD, device=frames.device) * 255
    return ((frames.float() - mean) / std).to(dtype)


def host_clips(tr: Dict, cfg: Dict, seed: int, rank: int, dtype,
               device) -> List[List[torch.Tensor]]:
    """``tr["clips"]`` clips of (1, H, W, 3) frames in host memory, pinned
    where ``device`` is a card."""
    out = []
    for c in range(tr["clips"]):
        frames = normalize(street_clip(tr, cfg["height"], cfg["width"],
                                       cfg["clip_length"],
                                       sub_seed(seed, 2, rank, c), device),
                           dtype)
        host = torch.empty(frames.shape, dtype=dtype,
                           pin_memory=frames.is_cuda)
        host.copy_(frames)
        out.append([f[None] for f in host])
    return out


def draws(tr: Dict, cfg: Dict, seed: int, rank: int,
          device) -> List[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Per clip, per frame after the first: the grid's uniforms ``(u (1,
    gh, gw), u_rank (gh gw,))`` on the device."""
    gh = cfg["height"] // tr["block_size"]
    gw = cfg["width"] // tr["block_size"]
    out = []
    for c in range(tr["clips"]):
        gen = torch.Generator(device).manual_seed(sub_seed(seed, 3, rank, c))
        u = torch.rand((cfg["clip_length"] - 1, 2, gh * gw), generator=gen,
                       device=device)
        out.append([(u[t, 0].view(1, gh, gw), u[t, 1])
                    for t in range(cfg["clip_length"] - 1)])
    return out
