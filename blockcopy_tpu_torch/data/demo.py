"""Demo folder dataset (counterpart of ``blockcopy_tpu/data/demo.py``).

Every image under a directory, each a single-frame clip, so the temporal
state resets every frame; frames are ordered by a natural sort of the
numeric runs in their paths (``img2 < img10``).  PIL is imported when an
image is read.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

IMAGE_SUFFIXES = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def _natural_key(path: Path):
    """Split every path component into (text, number) runs so frame_10
    sorts after frame_2 whatever the zero padding."""
    key = []
    for part in path.parts:
        run = ""
        for ch in part.lower():
            if ch.isdigit():
                if run and not run.isdigit():
                    key.append((run, -1))
                    run = ""
                run += ch
            else:
                if run.isdigit():
                    key.append(("", int(run)))
                    run = ""
                run += ch
        if run:
            key.append(("", int(run)) if run.isdigit() else (run, -1))
    return key


class DemoImageDataset:
    """Every image under ``root`` (recursively), one frame per clip."""

    def __init__(self, root: str, transform=None,
                 suffixes: Optional[set] = None):
        self.root = root
        self.transform = transform
        ok = suffixes or IMAGE_SUFFIXES
        paths = [p for p in Path(root).rglob("*")
                 if p.is_file() and p.suffix.lower() in ok]
        self.image_paths = [str(p) for p in sorted(paths, key=_natural_key)]
        if not self.image_paths:
            logger.warning("demo dataset: no images under %s", root)
        else:
            logger.info("demo dataset: %d images under %s",
                        len(self.image_paths), root)

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, index: int):
        from PIL import Image

        path = self.image_paths[index]
        meta = {"path": path, "relpath": os.path.relpath(path, self.root)}
        image = Image.open(path).convert("RGB")
        if self.transform is not None:
            image, _ = self.transform(image, None)
        return [image], 0, meta  # single-frame clip, no label
