"""CityPersons video-clip dataset (COCO-format annotations; counterpart of
``blockcopy_tpu/tasks/detection/dataset.py``).

Port of the reference ``CocoCSPORIClipDataset.prepare_test_img``
(``Pedestron/mmdet/datasets/coco_csp_ori_clip.py:332-412``): each annotated
CityPersons image anchors a clip built by filename arithmetic on
``*_leftImg8bit.png`` names against ``leftImg8bit_sequence``, reversed so the
annotated frame comes last.  Parses COCO json directly — no pycocotools.
PIL is imported when a frame is read.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

# img_norm_cfg from csp_r50_clip_blockcopy_030.py:79-80 (0..255 scale)
IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)


class CityPersonsClipDataset:
    def __init__(self, ann_file: str, img_prefix: str,
                 img_scale=(2048, 1024), clip_length: int = 20,
                 size_divisor: int = 128):
        with open(ann_file) as f:
            self.coco = json.load(f)
        self.img_prefix = img_prefix
        self.img_scale = img_scale  # (w, h)
        self.clip_length = clip_length
        self.size_divisor = size_divisor
        self.images = sorted(self.coco["images"], key=lambda x: x["id"])
        self.anns_by_img = defaultdict(list)
        for a in self.coco.get("annotations", []):
            self.anns_by_img[a["image_id"]].append(a)

    def __len__(self):
        return len(self.images)

    def _load_frame(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB")
        w, h = self.img_scale
        if img.size != (w, h):
            img = img.resize((w, h), Image.BILINEAR)
        arr = np.asarray(img, np.float32)
        return (arr - IMG_MEAN) / IMG_STD

    def __getitem__(self, index):
        info = self.images[index]
        file_name = info["file_name"]
        # e.g. city/city_000123_000019_leftImg8bit.png
        rel = file_name.replace("_leftImg8bit.png", "")
        parts = rel.split("_")
        prefix = "_".join(parts[:-1])
        frame_id = int(parts[-1])

        paths = []
        for i in range(self.clip_length - 1, -1, -1):
            fid = frame_id - i
            paths.append(os.path.join(
                self.img_prefix, f"{prefix}_{str(fid).zfill(6)}"
                "_leftImg8bit.png"))
        clip = [self._load_frame(p) for p in paths]
        meta = {
            "image_id": info["id"],
            "file_name": file_name,
            "img_shape": (self.img_scale[1], self.img_scale[0]),
            "scale_factor": 1.0,
            "is_clip": True,
        }
        return clip, self.anns_by_img.get(info["id"], []), meta
