"""CSP-R50: the program's ``DetectionStepper`` over ``models/csp.py``, its
three maps at ``head_stride`` carried in block layout, decoded and
NMS'd every frame."""

from typing import Dict

MAPS = ("csp_cls", "csp_reg", "csp_offset")
BOXES = ("dets", "labels", "valid")
MODEL_KEYS = ("strides", "dilations", "neck_out", "head_feat",
              "stacked_convs", "num_classes", "head_stride", "wh_ratio",
              "l2norm_scale", "gn_groups", "nms_pre", "score_thr", "nms_iou",
              "max_per_img")


def stepper(cfg: Dict, scfg, shape, capacity: int, dtype, device):
    from blockcopy_tpu_torch.models.csp import CSPConfig
    from blockcopy_tpu_torch.tasks.detection.stepper import DetectionStepper
    mcfg = CSPConfig(**{k: tuple(cfg[k]) if isinstance(cfg[k], list)
                        else cfg[k] for k in MODEL_KEYS})
    return DetectionStepper(mcfg, scfg, shape, capacity, dtype=dtype,
                            device=device)


def served(state):
    """The three maps' canvases (block layout), ``dets``, ``labels``,
    ``valid`` and ``prev_grid``."""
    out = {"grid": state["prev_grid"]}
    for k in MAPS:
        out[k] = state["canvases"][f"head.{k}.out"]
    for k in BOXES:
        out[k] = state[k]
    return out


def reference_layout(rec, geom):
    """``{"maps": (cls, reg, offset) each (1, c, h, w), "boxes": (dets,
    labels, valid)}``."""
    n, gh, gw = geom
    total, b = n * gh * gw, rec[MAPS[0]].shape[1]

    def dense(blocks):
        c = blocks.shape[-1]
        x = blocks[:total].reshape(n, gh, gw, b, b, c).permute(
            0, 5, 1, 3, 2, 4)
        return x.reshape(n, c, gh * b, gw * b)
    return {"maps": tuple(dense(rec[k]) for k in MAPS),
            "boxes": tuple(rec[k] for k in BOXES)}, rec["grid"][0]


def k1_head(cfg: Dict, block_size: int):
    """The head at ``head_stride``: its fused 3x3 over the three neck maps,
    then its three final 3x3s over ``head_feat``."""
    bs = block_size // cfg["head_stride"]
    return [(bs, 3 * cfg["neck_out"], 1)] + [(bs, cfg["head_feat"], 1)] * 3
