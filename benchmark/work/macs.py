"""Multiply-accumulates of a frame, counted from the reference models'
layer shapes on the meta device: layers over blocks count the executed
blocks' output pixels (a halo adds no output), dense layers count in
full, the policy's forward every frame after a clip's first and its
backward (twice the forward) on train frames."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

import reference
from reference import nets
from reference.policy import in_channels, policy_logits, spec_policy


def _meta(spec):
    if isinstance(spec, dict):
        return {k: _meta(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_meta(v) for v in spec]
    return torch.empty(spec.shape, device="meta")


def model_tally(cfg: Dict, block_size: int) -> Dict[str, tuple]:
    """{layer: (MACs over the whole frame, whether it runs over blocks)}."""
    h, w = cfg["height"], cfg["width"]
    forward, spec = reference.model(cfg)
    tally: Dict[str, tuple] = {}
    grid = torch.ones((h // block_size, w // block_size), dtype=torch.bool,
                      device="meta")
    fr = nets.Frame(grid, {}, macs=tally)
    x = torch.empty((1, 3, h, w), device="meta")
    forward(fr, _meta(spec(cfg)), x, cfg)
    return tally


def policy_macs(cfg: Dict, block_size: int) -> float:
    """The policy net's forward."""
    scale = 0.25 * 128 / block_size
    cin = in_channels(cfg["num_classes"] if cfg["task"] == "semseg"
                      else cfg["num_classes"] - 1)
    x = torch.empty((1, cin, int(cfg["height"] * scale),
                     int(cfg["width"] * scale)), device="meta")
    with FlopCounterMode(display=False) as fc:
        policy_logits(_meta(spec_policy(cin)), x)
    return fc.get_total_flops() / 2


def frame_macs(cfg: Dict, block_size: int, capacity: int) -> Dict[str, float]:
    """MACs of each kind of frame: a clip's ``first`` (every block, no
    policy), a ``plain`` step and a ``train`` step."""
    tally = model_tally(cfg, block_size)
    total = (cfg["height"] // block_size) * (cfg["width"] // block_size)
    blocked = sum(m for m, b in tally.values() if b)
    dense = sum(m for m, b in tally.values() if not b)
    step = blocked * capacity / total + dense
    pol = policy_macs(cfg, block_size)
    return {"first": blocked + dense, "plain": step + pol,
            "train": step + 3 * pol}
