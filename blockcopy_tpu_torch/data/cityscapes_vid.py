"""Cityscapes video-clip dataset (counterpart of
``blockcopy_tpu/data/cityscapes_vid.py``, reference
``semantic_segmentation/lib/datasets/cityscapes_vid.py:16-221``).

Each annotated frame anchors a clip built by walking back
``clip_length - 1`` frames in ``leftImg8bit_sequence`` by file-name
arithmetic, reversed so the annotated frame comes last.  Labels are encoded
to train ids.  PIL is imported when an image is read.
"""

from __future__ import annotations

import os
import random
from collections import namedtuple

import numpy as np

CityscapesClass = namedtuple(
    "CityscapesClass",
    ["name", "id", "train_id", "category", "category_id", "has_instances",
     "ignore_in_eval", "color"],
)

# The standard Cityscapes label table (public dataset metadata, as the
# reference's ``cityscapes_vid.py:37-72``).
CLASSES = [
    CityscapesClass("unlabeled", 0, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("ego vehicle", 1, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("rectification border", 2, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("out of roi", 3, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("static", 4, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("dynamic", 5, 255, "void", 0, False, True, (111, 74, 0)),
    CityscapesClass("ground", 6, 255, "void", 0, False, True, (81, 0, 81)),
    CityscapesClass("road", 7, 0, "flat", 1, False, False, (128, 64, 128)),
    CityscapesClass("sidewalk", 8, 1, "flat", 1, False, False, (244, 35, 232)),
    CityscapesClass("parking", 9, 255, "flat", 1, False, True, (250, 170, 160)),
    CityscapesClass("rail track", 10, 255, "flat", 1, False, True, (230, 150, 140)),
    CityscapesClass("building", 11, 2, "construction", 2, False, False, (70, 70, 70)),
    CityscapesClass("wall", 12, 3, "construction", 2, False, False, (102, 102, 156)),
    CityscapesClass("fence", 13, 4, "construction", 2, False, False, (190, 153, 153)),
    CityscapesClass("guard rail", 14, 255, "construction", 2, False, True, (180, 165, 180)),
    CityscapesClass("bridge", 15, 255, "construction", 2, False, True, (150, 100, 100)),
    CityscapesClass("tunnel", 16, 255, "construction", 2, False, True, (150, 120, 90)),
    CityscapesClass("pole", 17, 5, "object", 3, False, False, (153, 153, 153)),
    CityscapesClass("polegroup", 18, 255, "object", 3, False, True, (153, 153, 153)),
    CityscapesClass("traffic light", 19, 6, "object", 3, False, False, (250, 170, 30)),
    CityscapesClass("traffic sign", 20, 7, "object", 3, False, False, (220, 220, 0)),
    CityscapesClass("vegetation", 21, 8, "nature", 4, False, False, (107, 142, 35)),
    CityscapesClass("terrain", 22, 9, "nature", 4, False, False, (152, 251, 152)),
    CityscapesClass("sky", 23, 10, "sky", 5, False, False, (70, 130, 180)),
    CityscapesClass("person", 24, 11, "human", 6, True, False, (220, 20, 60)),
    CityscapesClass("rider", 25, 12, "human", 6, True, False, (255, 0, 0)),
    CityscapesClass("car", 26, 13, "vehicle", 7, True, False, (0, 0, 142)),
    CityscapesClass("truck", 27, 14, "vehicle", 7, True, False, (0, 0, 70)),
    CityscapesClass("bus", 28, 15, "vehicle", 7, True, False, (0, 60, 100)),
    CityscapesClass("caravan", 29, 255, "vehicle", 7, True, True, (0, 0, 90)),
    CityscapesClass("trailer", 30, 255, "vehicle", 7, True, True, (0, 0, 110)),
    CityscapesClass("train", 31, 16, "vehicle", 7, True, False, (0, 80, 100)),
    CityscapesClass("motorcycle", 32, 17, "vehicle", 7, True, False, (0, 0, 230)),
    CityscapesClass("bicycle", 33, 18, "vehicle", 7, True, False, (119, 11, 32)),
    CityscapesClass("license plate", -1, 255, "vehicle", 7, False, True, (0, 0, 142)),
]


class CityscapesVid:
    mean = (73.1584 / 255, 82.9090 / 255, 72.3924 / 255)
    std = (44.9149 / 255, 46.1529 / 255, 45.3192 / 255)

    classes = CLASSES
    fine_classes = [6, 7, 11, 12, 13, 14, 15, 16, 17, 18]

    train_id_to_color = np.array(
        [c.color for c in CLASSES if c.train_id not in (-1, 255)] + [[0, 0, 0]]
    )
    id_to_train_id = np.array([c.train_id for c in CLASSES])

    train_id_to_name = None  # filled below

    def __init__(self, root: str, split: str = "train",
                 target_type: str = "semantic", transform=None,
                 clip_length: int = 20, has_labels: bool = True,
                 native: bool = False, native_size=None):
        if native:
            raise NotImplementedError(
                "native clip decoding needs the C++ IO library "
                "(blockcopy_tpu/native), not ported yet (ROADMAP Queue 1 item 15)")
        self.root = os.path.expanduser(root)
        self.mode = "gtFine"
        self.images_dir = os.path.join(self.root, "leftImg8bit", split)
        self.vid_dir = os.path.join(self.root, "leftImg8bit_sequence", split)
        self.targets_dir = os.path.join(self.root, self.mode, split)
        self.transform = transform
        if not 0 < clip_length <= 20:
            raise ValueError("Clip length must be between 1 and 20")
        self.clip_length = clip_length
        self.interval = 1
        self.has_labels = has_labels
        self.split = split

        if split not in ("train", "test", "val"):
            raise ValueError("split must be train/test/val")
        for d in (self.images_dir, self.vid_dir):
            if not os.path.isdir(d):
                raise RuntimeError(f"Dataset directory missing: {d}")

        self.images, self.targets, self.relative_dirs = [], [], []
        for city in sorted(os.listdir(self.images_dir)):
            img_dir = os.path.join(self.images_dir, city)
            tgt_dir = os.path.join(self.targets_dir, city)
            for file_name in sorted(os.listdir(img_dir)):
                self.relative_dirs.append(os.path.join(city, file_name))
                self.images.append(os.path.join(img_dir, file_name))
                tname = "{}_{}_labelIds.png".format(
                    file_name.split("_leftImg8bit")[0], self.mode)
                self.targets.append(os.path.join(tgt_dir, tname))

    @classmethod
    def encode_target(cls, target: np.ndarray) -> np.ndarray:
        return cls.id_to_train_id[np.asarray(target)]

    @classmethod
    def decode_target(cls, target: np.ndarray) -> np.ndarray:
        target = np.asarray(target).copy()
        target[target == 255] = 19
        return cls.train_id_to_color[target]

    def __len__(self):
        return len(self.images)

    def _load(self, path, rng_state=None):
        from PIL import Image

        img = Image.open(path).convert("RGB")
        if self.transform is not None:
            if rng_state is not None:
                # replay the annotated frame's random draws: every frame of
                # a clip shares one augmentation
                random.setstate(rng_state)
            img, _ = self.transform(img, None)
        return img

    def __getitem__(self, index):
        from PIL import Image

        rng_state = random.getstate()
        img = Image.open(self.images[index]).convert("RGB")
        target = Image.open(self.targets[index]) if self.has_labels else None
        if self.transform is not None:
            img, target = self.transform(img, target)
        if target is not None:
            target = self.encode_target(target)

        fn = self.relative_dirs[index].replace("_leftImg8bit.png", "")
        parts = fn.split("_")
        prefix = "_".join(parts[:-1])
        frame_id = int(parts[-1])
        clip = [img]
        for i in range(1, self.clip_length):
            this_fn = (f"{prefix}_{str(frame_id - i * self.interval).zfill(6)}"
                       "_leftImg8bit.png")
            clip.append(self._load(os.path.join(self.vid_dir, this_fn),
                                   rng_state=rng_state))
        clip = clip[::-1]
        meta = {"relpath": self.relative_dirs[index]}
        if target is None:
            target = 0
        return clip, target, meta


CityscapesVid.train_id_to_name = [
    ", ".join(c.name for c in CLASSES
              if (c.train_id if c.train_id != 255 else 19) == t)
    for t in range(20)
]
