"""Paired image and label transforms of the eval pipeline (counterpart of
``blockcopy_tpu/data/transforms.py``): Resize -> ToArray -> Normalize, as the
reference's ``test_swiftnet.py:62-66``; numpy HWC output.

PIL is imported inside the transform that needs it, never at module import,
so the CLI runs on ``--synthetic`` clips where PIL is not installed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class ExtCompose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, lbl=None):
        for t in self.transforms:
            img, lbl = t(img, lbl)
        return img, lbl


class ExtResize:
    """Resize to (h, w); bilinear for images, nearest for labels."""

    def __init__(self, size: Tuple[int, int]):
        self.size = size  # (h, w)

    def __call__(self, img, lbl: Optional[object]):
        from PIL import Image

        h, w = self.size
        img = img.resize((w, h), Image.BILINEAR)
        if lbl is not None:
            lbl = lbl.resize((w, h), Image.NEAREST)
        return img, lbl


class ExtToArray:
    """PIL -> float32 numpy HWC in [0, 1]; labels -> int array."""

    def __call__(self, img, lbl):
        img = np.asarray(img, np.float32) / 255.0
        if lbl is not None:
            lbl = np.asarray(lbl, np.int64)
        return img, lbl


class ExtNormalize:
    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, lbl):
        return (img - self.mean) / self.std, lbl


def denormalize(img: np.ndarray, mean, std) -> np.ndarray:
    """Inverse of ``ExtNormalize``, for visualization (reference
    ``lib/utils/misc.py:6-12``)."""
    return img * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
