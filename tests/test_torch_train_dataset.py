"""The port's detection training data (``tasks/detection/train_dataset.py``)
against the JAX package's, bit for bit for the same seed, and the train
modules' independence from PIL."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from blockcopy_tpu.tasks.detection import train_dataset as JD
from blockcopy_tpu_torch.tasks.detection import train_dataset as TD
from torch_port_util import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _same(ref, got, msg=""):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape, msg
        np.testing.assert_array_equal(g, r, err_msg=msg)


@pytest.mark.parametrize("crop", [(64, 128), (128, 256), (256, 512)])
def test_transform_bitwise(crop):
    """Eight samples through one transform each (the flip and crop draws
    chain through one RandomState): image and the three maps equal."""
    rs = np.random.RandomState(2)
    jt = JD.CSPTrainTransform(crop_size=crop, seed=4)
    tt_ = TD.CSPTrainTransform(crop_size=crop, seed=4)
    for i in range(8):
        img = rs.rand(200, 400, 3).astype(np.float32) * 255
        n = i % 4                                   # 0..3 boxes
        x1 = rs.uniform(0, 360, n)
        y1 = rs.uniform(0, 100, n)
        gts = np.stack([x1, y1, x1 + rs.uniform(6, 40, n),
                        y1 + rs.uniform(6, 99, n)], 1).astype(np.float32) \
            .reshape(-1, 4)
        igs = None if i % 3 == 0 else np.array([[10, 20, 60, 90]],
                                               np.float32)
        _same(jt(img, gts, igs), tt_(img, gts, igs), f"sample {i}")
    assert jt.rs.randint(1 << 30) == tt_.rs.randint(1 << 30)


def test_flip_and_crop_boxes():
    rs = np.random.RandomState(0)
    boxes = np.stack([rs.uniform(0, 90, 6), rs.uniform(0, 40, 6),
                      rs.uniform(95, 130, 6), rs.uniform(45, 64, 6)],
                     1).astype(np.float32)
    np.testing.assert_array_equal(TD._flip_boxes(boxes, 128),
                                  JD._flip_boxes(boxes, 128))
    for x0, y0, w, h in ((0, 0, 128, 64), (40, 10, 60, 30), (100, 50, 30, 9)):
        np.testing.assert_array_equal(TD._crop_boxes(boxes, x0, y0, w, h),
                                      JD._crop_boxes(boxes, x0, y0, w, h))
    assert TD._crop_boxes(np.zeros((0, 4), np.float32), 0, 0, 8, 8).shape \
        == (0, 4)


def test_synthetic_dataset_bitwise():
    jd = JD.SyntheticDetTrainDataset(6, 128, 256, seed=3)
    td = TD.SyntheticDetTrainDataset(6, 128, 256, seed=3)
    assert len(jd) == len(td) == 6
    for i in (0, 3, 5, 1):
        _same(jd[i], td[i], f"item {i}")


def test_citypersons_dataset(tmp_path):
    """A tiny COCO json over PNGs: the same image, maps and ignore
    handling as the JAX dataset."""
    rs = np.random.RandomState(1)
    images, anns = [], []
    for i in range(3):
        name = f"city_{i}_leftImg8bit.png"
        Image.fromarray(rs.randint(0, 256, (96, 192, 3), np.uint8)).save(
            tmp_path / name)
        images.append({"id": i + 1, "file_name": name, "width": 192,
                       "height": 96})
        for j in range(i + 1):
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "bbox": [20.0 + 50 * j, 10.0, 20.0, 60.0],
                         "ignore": int(j == 1), "iscrowd": int(j == 2)})
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns}))
    jd = JD.CityPersonsTrainDataset(
        str(ann), str(tmp_path), JD.CSPTrainTransform((64, 128), seed=2))
    td = TD.CityPersonsTrainDataset(
        str(ann), str(tmp_path), TD.CSPTrainTransform((64, 128), seed=2))
    assert len(jd) == len(td) == 3
    for i in range(3):
        _same(jd[i], td[i], f"image {i}")


def test_train_modules_import_without_pil():
    """The train modules, the transforms and the validation tool import
    with PIL blocked, and the synthetic data and the train CLI's parser
    run (the card's machine has no PIL)."""
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "from blockcopy_tpu_torch.tasks.detection import train, "
        "train_dataset, train_cli\n"
        "from blockcopy_tpu_torch.data import transforms\n"
        "from blockcopy_tpu_torch.ops import extras\n"
        "from blockcopy_tpu_torch.tools import validate_detection\n"
        "ds = train_dataset.SyntheticDetTrainDataset(2, 64, 128)\n"
        "img, pos, scale, offset = ds[1]\n"
        "assert img.shape == (64, 128, 3) and pos.shape == (16, 32, 3)\n"
        "train_cli.build_argparser().parse_args(['--synthetic'])\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'blockcopy_tpu') or (k.startswith('PIL') and "
        "sys.modules[k] is not None))\n"
        "assert not bad, bad\n")
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
