"""Train-side detection data (counterpart of
``blockcopy_tpu/tasks/detection/train_dataset.py``, reference
``Pedestron/mmdet/datasets/coco_csp_ori_clip.py:414+`` and ``custom.py
prepare_train_img``): per-sample augmentation (random horizontal flip, a
random fixed-size crop biased toward boxes), then the CSP center, scale and
offset ground-truth maps (``train.calc_gt_center``).

Two sources:

* ``CityPersonsTrainDataset``: COCO-format annotations, single annotated
  frames (the reference trains the detector offline on single images);
* ``SyntheticDetTrainDataset``: generated pedestrian-like scenes with exact
  ground truth, for training without data.

PIL is imported when a CityPersons image is read, never at module import:
the synthetic path runs where PIL is not installed.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from blockcopy_tpu_torch.tasks.detection.dataset import IMG_MEAN, IMG_STD
from blockcopy_tpu_torch.tasks.detection.train import calc_gt_center


def _flip_boxes(boxes: np.ndarray, width: int) -> np.ndarray:
    if len(boxes) == 0:
        return boxes
    out = boxes.copy()
    out[:, 0] = width - boxes[:, 2]
    out[:, 2] = width - boxes[:, 0]
    return out


def _crop_boxes(boxes: np.ndarray, x0: int, y0: int, w: int, h: int,
                min_size: float = 8.0) -> np.ndarray:
    # min_size stays above the head stride (4): a box clipped to exactly the
    # stride's height has log-scale target 0, which reg_pos_loss masks out
    if len(boxes) == 0:
        return boxes.reshape(0, 4)
    out = boxes.copy()
    out[:, [0, 2]] -= x0
    out[:, [1, 3]] -= y0
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, w)
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, h)
    keep = ((out[:, 2] - out[:, 0]) >= min_size) & \
           ((out[:, 3] - out[:, 1]) >= min_size)
    return out[keep]


class CSPTrainTransform:
    """Flip, box-biased crop, normalize, GT maps.  One
    ``np.random.RandomState(seed)`` draws for every sample: loader threads
    that share the transform draw from it in the order they run."""

    def __init__(self, crop_size: Tuple[int, int] = (640, 1280),
                 flip_prob: float = 0.5, stride: int = 4,
                 radius: int = 8, seed: int = 0):
        self.crop_size = crop_size
        self.flip_prob = flip_prob
        self.stride = stride
        self.radius = radius
        self.rs = np.random.RandomState(seed)

    def __call__(self, img: np.ndarray, gts: np.ndarray,
                 igs: Optional[np.ndarray] = None):
        h, w = img.shape[:2]
        igs = igs if igs is not None else np.zeros((0, 4), np.float32)
        if self.rs.rand() < self.flip_prob:
            img = img[:, ::-1]
            gts = _flip_boxes(gts, w)
            igs = _flip_boxes(igs, w)
        ch, cw = self.crop_size
        ch, cw = min(ch, h), min(cw, w)
        if len(gts) > 0 and self.rs.rand() < 0.8:
            # center the window on a random GT box (the reference samples
            # crops that keep pedestrians in view)
            b = gts[self.rs.randint(len(gts))]
            cx = int((b[0] + b[2]) / 2)
            cy = int((b[1] + b[3]) / 2)
            x0 = np.clip(cx - cw // 2, 0, w - cw)
            y0 = np.clip(cy - ch // 2, 0, h - ch)
        else:
            x0 = self.rs.randint(0, w - cw + 1)
            y0 = self.rs.randint(0, h - ch + 1)
        img = img[y0:y0 + ch, x0:x0 + cw]
        gts = _crop_boxes(gts, x0, y0, cw, ch)
        igs = _crop_boxes(igs, x0, y0, cw, ch)

        img = (img.astype(np.float32) - IMG_MEAN) / IMG_STD
        pos, scale, offset = calc_gt_center(
            gts.astype(np.float32), igs.astype(np.float32), (ch, cw),
            radius=self.radius, stride=self.stride)
        return img, pos, scale, offset


class CityPersonsTrainDataset:
    """Single annotated frames and their boxes from COCO-format
    CityPersons."""

    def __init__(self, ann_file: str, img_prefix: str,
                 transform: Optional[CSPTrainTransform] = None):
        with open(ann_file) as f:
            coco = json.load(f)
        self.img_prefix = img_prefix
        self.images = coco["images"]
        by_img = {}
        for a in coco["annotations"]:
            by_img.setdefault(a["image_id"], []).append(a)
        self.anns = by_img
        self.transform = transform or CSPTrainTransform()

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        from PIL import Image

        info = self.images[index]
        path = os.path.join(self.img_prefix, info["file_name"])
        img = np.asarray(Image.open(path).convert("RGB"), np.float32)
        gts, igs = [], []
        for a in self.anns.get(info["id"], []):
            x, y, w, h = a["bbox"]
            box = [x, y, x + w, y + h]
            (igs if a.get("ignore") or a.get("iscrowd") else gts).append(box)
        return self.transform(img,
                              np.asarray(gts, np.float32).reshape(-1, 4),
                              np.asarray(igs, np.float32).reshape(-1, 4))


class SyntheticDetTrainDataset:
    """Bright rectangles on noise with exact GT: CSP learns them from
    scratch (the loss drops within a few dozen steps)."""

    def __init__(self, num_samples: int, height: int = 256, width: int = 512,
                 seed: int = 0, transform: Optional[CSPTrainTransform] = None):
        self.n = num_samples
        self.h, self.w = height, width
        self.seed = seed
        self.transform = transform or CSPTrainTransform(
            crop_size=(height, width), seed=seed)

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        rs = np.random.RandomState(self.seed + index)
        img = rs.randn(self.h, self.w, 3).astype(np.float32) * 20 + 110
        gts = []
        for _ in range(rs.randint(1, 4)):
            bh = rs.randint(60, min(140, self.h - 2))
            bw = int(bh * 0.41)
            x = rs.randint(0, self.w - bw)
            y = rs.randint(0, self.h - bh)
            img[y:y + bh, x:x + bw] += 90
            gts.append([x, y, x + bw, y + bh])
        img = img.clip(0, 255)
        return self.transform(img, np.asarray(gts, np.float32),
                              np.zeros((0, 4), np.float32))
