"""Config-driven component construction (counterpart of
``blockcopy_tpu/utils/registry.py``).

The reference's mmcv/mmdet registry system
(``Pedestron/mmdet/utils/registry.py`` + ``mmdet/models/builder.py``):
``Registry`` maps type names to constructors, ``build_from_cfg`` instantiates
from a ``dict(type=..., **kwargs)``, and ``load_config`` executes an
mmdet-style python config file (the format of
``Pedestron/configs/elephant/cityperson/*.py``) into a plain dict, so the
reference's BlockCopy detection configs translate line-for-line.
"""

from __future__ import annotations

import importlib.util
import inspect
import os
from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key: str):
        return self._module_dict.get(key)

    def register_module(self, cls=None, *, name: Optional[str] = None):
        def _register(c):
            key = name or c.__name__
            if key in self._module_dict:
                raise KeyError(f"{key} already registered in {self._name}")
            self._module_dict[key] = c
            return c

        if cls is None:
            return _register
        return _register(cls)

    def __repr__(self):
        return f"Registry(name={self._name}, items={list(self._module_dict)})"


def build_from_cfg(cfg: Dict, registry: Registry, default_args: Dict = None):
    """Instantiate ``registry[cfg['type']](**cfg_without_type,
    **default_args)`` (reference ``mmdet/utils/registry.py``)."""
    assert isinstance(cfg, dict) and "type" in cfg, cfg
    args = cfg.copy()
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {type(obj_type)}")
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)


# Framework registries (mirroring mmdet's: DETECTORS/BACKBONES/NECKS/HEADS/
# DATASETS/POLICIES)
BACKBONES = Registry("backbone")
NECKS = Registry("neck")
HEADS = Registry("head")
DETECTORS = Registry("detector")
DATASETS = Registry("dataset")
POLICIES = Registry("policy")
MODELS = Registry("model")


def load_config(path: str) -> Dict:
    """Execute an mmdet-style python config file into a dict of its
    module-level variables (the reference uses ``mmcv.Config.fromfile``,
    ``tools/test_city_person.py:240``)."""
    path = os.path.abspath(path)
    spec = importlib.util.spec_from_file_location("_blockcopy_cfg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {k: v for k, v in vars(mod).items() if not k.startswith("_")}
