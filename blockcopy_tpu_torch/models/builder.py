"""Config-driven model construction (counterpart of
``blockcopy_tpu/models/builder.py``; reference ``mmdet/models/builder.py``:
``build_detector(cfg.model, test_cfg=cfg.test_cfg)``).

The shipped configs in ``configs/csp/`` are plain python dicts in the
reference's mmcv layout; ``build_detector`` maps them onto the port's CSP.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

from blockcopy_tpu_torch.core.argparser import default_settings
from blockcopy_tpu_torch.device import resolve_device
from blockcopy_tpu_torch.models.csp import CSPBlockCopy, CSPConfig, init_csp
from blockcopy_tpu_torch.utils.registry import BACKBONES, DATASETS, DETECTORS

logger = logging.getLogger(__name__)

# the component names the reference configs use
DETECTORS.register_module(CSPBlockCopy, name="CSPBlockCopy")
BACKBONES.register_module(CSPConfig, name="ResNet")


def _register_datasets():
    from blockcopy_tpu_torch.data.cityscapes_vid import CityscapesVid
    from blockcopy_tpu_torch.data.demo import DemoImageDataset
    from blockcopy_tpu_torch.tasks.detection.dataset import \
        CityPersonsClipDataset

    for cls, name in [
        (CityPersonsClipDataset, "CityPersonsClipDataset"),
        (CityPersonsClipDataset, "CocoCSPORIClipDataset"),  # reference name
        (CityscapesVid, "CityscapesVid"),
        (DemoImageDataset, "DemoImageDataset"),
    ]:
        if DATASETS.get(name) is None:
            DATASETS.register_module(cls, name=name)


_register_datasets()

_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def csp_config_from_dict(cfg: Dict) -> CSPConfig:
    """An mmdet-style config dict (``model`` and ``test_cfg``) as a
    ``CSPConfig``."""
    model = cfg["model"]
    bb = model.get("backbone", {})
    head = model.get("bbox_head", {})
    test = cfg.get("test_cfg", {})
    kwargs = {}
    if "depth" in bb:
        if bb["depth"] not in _STAGE_BLOCKS:
            raise ValueError(f"unsupported backbone depth {bb['depth']}")
        kwargs["depth"] = bb["depth"]
        kwargs["stage_blocks"] = _STAGE_BLOCKS[bb["depth"]]
    for key in ("stage_blocks", "strides", "dilations", "out_indices"):
        if key in bb:  # stage_blocks: an explicit override (tests, ablations)
            kwargs[key] = tuple(bb[key])
    for src, dst in (("num_classes", "num_classes"),
                     ("stacked_convs", "stacked_convs"),
                     ("feat_channels", "head_feat")):
        if src in head:
            kwargs[dst] = head[src]
    if model.get("neck", {}).get("out_channels"):
        kwargs["neck_out"] = model["neck"]["out_channels"]
    for key in ("nms_pre", "score_thr", "max_per_img"):
        if key in test:
            kwargs[key] = test[key]
    if isinstance(test.get("nms"), dict) and "iou_thr" in test["nms"]:
        kwargs["nms_iou"] = test["nms"]["iou_thr"]
        if "type" in test["nms"]:
            kwargs["nms_type"] = test["nms"]["type"]
    return CSPConfig(**kwargs)


def load_csp_params(checkpoint: str, csp_cfg: CSPConfig, dtype, device):
    """CSP parameters from a reference ``.pth``/``.pt``/``.stu`` or from
    the JAX package's flat ``.npz`` (any other name)."""
    if checkpoint.endswith((".pth", ".pt", ".stu")):
        from blockcopy_tpu_torch.tasks.detection.checkpoint import \
            load_csp_torch_checkpoint
        return load_csp_torch_checkpoint(checkpoint, csp_cfg, dtype, device)
    from blockcopy_tpu_torch.utils.checkpoint import load_npz
    like = init_csp(csp_cfg, device="meta")
    return load_npz(checkpoint, like, dtype, device)


def build_detector(cfg: Dict, checkpoint: Optional[str] = None,
                   dtype=torch.float32, seed: int = 0,
                   settings_override: Optional[Dict] = None,
                   device=None) -> CSPBlockCopy:
    """A ``CSPBlockCopy`` from a loaded python config dict
    (``utils/registry.py`` ``load_config``) on ``device`` (default CUDA).
    Settings: the defaults for ``rl_objectdetection``, then the config's
    ``blockcopy_settings``, then ``settings_override``."""
    model_cfg = cfg["model"]
    if model_cfg.get("type") != "CSPBlockCopy":
        raise ValueError(f"model type {model_cfg.get('type')!r} is not "
                         f"CSPBlockCopy")
    device = resolve_device(device)
    csp_cfg = csp_config_from_dict(cfg)
    if checkpoint:
        params = load_csp_params(checkpoint, csp_cfg, dtype, device)
    else:
        params = init_csp(csp_cfg, seed=seed, dtype=dtype, device=device)
    settings = default_settings(block_policy="rl_objectdetection",
                                block_num_classes=1)
    settings.update(model_cfg.get("blockcopy_settings", {}))
    settings.update(settings_override or {})
    return CSPBlockCopy(params, csp_cfg, settings, device=device)
