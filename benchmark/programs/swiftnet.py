"""SwiftNet on the ResNet its configuration's ``backbone`` names: the
program's ``FixedCapacityStepper`` over ``models/swiftnet.py``, its logits
at stride 4 carried dense."""

from typing import Dict


def stepper(cfg: Dict, scfg, shape, capacity: int, dtype, device):
    from blockcopy_tpu_torch.core.stepper import FixedCapacityStepper
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     make_apply_fn)
    mcfg = SwiftNetConfig(backbone=cfg["backbone"],
                          num_classes=cfg["num_classes"],
                          num_features=cfg["num_features"],
                          spp_grids=tuple(cfg["spp_grids"]),
                          spp_levels=cfg["spp_levels"])
    return FixedCapacityStepper(make_apply_fn(mcfg), scfg, shape, capacity,
                                dtype=dtype, device=device)


def served(state):
    """``outputs`` (N, H/4, W/4, C) and ``prev_grid``."""
    return {"grid": state["prev_grid"], "outputs": state["outputs"]}


def reference_layout(rec, geom):
    """The logits (1, C, H/4, W/4)."""
    return rec["outputs"].permute(0, 3, 1, 2), rec["grid"][0]


def k1_head(cfg: Dict, block_size: int):
    """The decoder's three 3x3 blends, at strides 16, 8 and 4, over
    ``num_features``."""
    return [(block_size // s, cfg["num_features"], 1) for s in (16, 8, 4)]
