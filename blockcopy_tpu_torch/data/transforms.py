"""Paired image and label transforms (counterpart of
``blockcopy_tpu/data/transforms.py``): the eval pipeline (Resize -> ToArray
-> Normalize, as the reference's ``test_swiftnet.py:62-66``; numpy HWC
output) and the train-side augmentations of the reference's
``lib/ext_transforms.py`` (crops, flips, rotation, blur, pad, scale and
scale-list, color jitter) on PIL images.

PIL is imported inside the transform that needs it, never at module import,
so the CLI runs on ``--synthetic`` clips where PIL is not installed.

Each random transform draws from the ``rng`` it is given, a
``random.Random``; by default the module ``random``, as the JAX package's
transforms draw.  Both are MT19937, so ``random.Random(s)`` reproduces the
JAX transforms' draws after ``random.seed(s)``.
"""

from __future__ import annotations

import random
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


class ExtRandomHorizontalFlip:
    def __init__(self, p: float = 0.5, rng=random):
        self.p = p
        self.rng = rng

    def __call__(self, img, lbl):
        from PIL import Image

        if self.rng.random() < self.p:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if lbl is not None:
                lbl = lbl.transpose(Image.FLIP_LEFT_RIGHT)
        return img, lbl


class ExtCenterCrop:
    def __init__(self, size):
        self.size = size  # (h, w)

    def __call__(self, img, lbl):
        w, h = img.size
        th, tw = self.size
        x = max((w - tw) // 2, 0)
        y = max((h - th) // 2, 0)
        box = (x, y, x + tw, y + th)
        img = img.crop(box)
        if lbl is not None:
            lbl = lbl.crop(box)
        return img, lbl


class ExtRandomCrop:
    def __init__(self, size, pad_if_needed: bool = True, rng=random):
        self.size = size  # (h, w)
        self.pad_if_needed = pad_if_needed
        self.rng = rng

    def __call__(self, img, lbl):
        th, tw = self.size
        if self.pad_if_needed and (img.size[0] < tw or img.size[1] < th):
            pw = max(tw - img.size[0], 0)
            ph = max(th - img.size[1], 0)
            img = _pad_pil(img, pw, ph, 0)
            if lbl is not None:
                lbl = _pad_pil(lbl, pw, ph, 255)
        w, h = img.size
        x = self.rng.randint(0, max(w - tw, 0))
        y = self.rng.randint(0, max(h - th, 0))
        box = (x, y, x + tw, y + th)
        img = img.crop(box)
        if lbl is not None:
            lbl = lbl.crop(box)
        return img, lbl


def _pad_pil(img, pw, ph, fill):
    from PIL import Image

    out = Image.new(img.mode, (img.size[0] + pw, img.size[1] + ph),
                    fill if img.mode != "RGB" else (fill,) * 3)
    out.paste(img, (0, 0))
    return out


class ExtRandomScale:
    """Random isotropic rescale by a factor in ``scale_range``."""

    def __init__(self, scale_range=(0.5, 2.0), rng=random):
        self.scale_range = scale_range
        self.rng = rng

    def __call__(self, img, lbl):
        from PIL import Image

        s = self.rng.uniform(*self.scale_range)
        size = (int(img.size[0] * s), int(img.size[1] * s))
        img = img.resize(size, Image.BILINEAR)
        if lbl is not None:
            lbl = lbl.resize(size, Image.NEAREST)
        return img, lbl


class ExtColorJitter:
    """Brightness, contrast and saturation jitter (image only)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 rng=random):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.rng = rng

    def _factor(self, amount):
        return self.rng.uniform(max(0.0, 1 - amount), 1 + amount)

    def __call__(self, img, lbl):
        from PIL import ImageEnhance

        if self.brightness > 0:
            img = ImageEnhance.Brightness(img).enhance(
                self._factor(self.brightness))
        if self.contrast > 0:
            img = ImageEnhance.Contrast(img).enhance(
                self._factor(self.contrast))
        if self.saturation > 0:
            img = ImageEnhance.Color(img).enhance(
                self._factor(self.saturation))
        return img, lbl


class ExtRandomVerticalFlip:
    def __init__(self, p: float = 0.5, rng=random):
        self.p = p
        self.rng = rng

    def __call__(self, img, lbl):
        from PIL import Image

        if self.rng.random() < self.p:
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
            if lbl is not None:
                lbl = lbl.transpose(Image.FLIP_TOP_BOTTOM)
        return img, lbl


class ExtRandomRotation:
    """Rotate the image (bilinear) and the label (nearest) by a random angle
    in ``degrees``; the label's fill is the ignore index."""

    def __init__(self, degrees, expand: bool = False, ignore_index: int = 255,
                 rng=random):
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.expand = expand
        self.ignore_index = ignore_index
        self.rng = rng

    def __call__(self, img, lbl):
        from PIL import Image

        angle = self.rng.uniform(*self.degrees)
        img = img.rotate(angle, Image.BILINEAR, expand=self.expand)
        if lbl is not None:
            lbl = lbl.rotate(angle, Image.NEAREST, expand=self.expand,
                             fillcolor=self.ignore_index)
        return img, lbl


class ExtGaussianBlur:
    """Gaussian blur of the image only (labels untouched)."""

    def __init__(self, radius=(0.1, 2.0), p: float = 0.5, rng=random):
        if isinstance(radius, (int, float)):
            radius = (radius, radius)
        self.radius = radius
        self.p = p
        self.rng = rng

    def __call__(self, img, lbl):
        if self.rng.random() < self.p:
            from PIL import ImageFilter

            img = img.filter(ImageFilter.GaussianBlur(
                self.rng.uniform(*self.radius)))
        return img, lbl


class ExtPad:
    """Pad right and bottom so both sides are multiples of ``divisor``
    (images 0-filled, labels ignore-filled)."""

    def __init__(self, divisor: int = 32, ignore_index: int = 255):
        self.divisor = divisor
        self.ignore_index = ignore_index

    def __call__(self, img, lbl):
        w, h = img.size
        pw = (-w) % self.divisor
        ph = (-h) % self.divisor
        if pw or ph:
            img = _pad_pil(img, pw, ph, 0)
            if lbl is not None:
                lbl = _pad_pil(lbl, pw, ph, self.ignore_index)
        return img, lbl


class ExtRandomScaleChoice:
    """Random rescale by a factor drawn from a discrete list (the
    reference's scale-list training mode)."""

    def __init__(self, scales: Sequence[float] = (0.5, 0.75, 1.0, 1.5, 2.0),
                 rng=random):
        self.scales = tuple(scales)
        self.rng = rng

    def __call__(self, img, lbl):
        from PIL import Image

        s = self.rng.choice(self.scales)
        size = (int(img.size[0] * s), int(img.size[1] * s))
        img = img.resize(size, Image.BILINEAR)
        if lbl is not None:
            lbl = lbl.resize(size, Image.NEAREST)
        return img, lbl


def denormalize(img: np.ndarray, mean, std) -> np.ndarray:
    """Inverse of ``ExtNormalize``, for visualization (reference
    ``lib/utils/misc.py:6-12``)."""
    return img * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
