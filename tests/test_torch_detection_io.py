"""The detection CLI's pieces held against their JAX counterparts on the
CPU: the CityPersons miss rates (bitwise, over perfect, missed, ignored and
false-positive cases), the registry and ``load_config``, the config builder
on the three shipped ``configs/csp/*.py``, the mmdet checkpoint converter
(``.pth`` and ``.pth.stu`` names; bitwise after the layout conversion) and
the CityPersons clip dataset (bitwise, on small PNGs written here)."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from blockcopy_tpu.tasks.detection import eval_mr as JM
from blockcopy_tpu_torch.tasks.detection import eval_mr as TM
from torch_port_util import assert_same, assert_tree, jtree
from torch_port_util import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "csp", "*.py")))


# -- miss rates ---------------------------------------------------------------


def _gt(boxes, image_id=1, **kw):
    return [{"image_id": image_id, "bbox": list(b), "height": b[3],
             "vis_ratio": kw.get("vis", 1.0), "ignore": kw.get("ignore", 0),
             "category_id": 1} for b in boxes]


def _dt(boxes, scores, image_id=1):
    return [{"image_id": image_id, "bbox": list(b), "score": s,
             "category_id": 1} for b, s in zip(boxes, scores)]


def _random_case(seed):
    """Three images: GT of every height and visibility (some ignored),
    detections jittered around them, missing some, plus false positives."""
    rs = np.random.RandomState(seed)
    gts, dts = [], []
    for img in (1, 2, 3):
        boxes = [(rs.uniform(0, 1500), rs.uniform(0, 700), h * 0.41, h)
                 for h in rs.uniform(20, 200, 8)]
        for b in boxes:
            gts += _gt([b], img, vis=float(rs.uniform(0.1, 1.0)),
                       ignore=int(rs.rand() < 0.15))
            if rs.rand() < 0.7:
                j = b + rs.normal(0, 4, 4)
                dts += _dt([j], [float(rs.uniform(0.3, 1.0))], img)
        fp = [(rs.uniform(0, 1500), rs.uniform(0, 700), 30, 75)
              for _ in range(3)]
        dts += _dt(fp, rs.uniform(0.1, 0.9, 3).tolist(), img)
    return gts, dts


PERSON = (100, 100, 41, 100)
CASES = {
    "perfect": (_gt([PERSON]), _dt([PERSON], [0.9])),
    "missed": (_gt([PERSON, (600, 100, 41, 100)]), _dt([PERSON], [0.9])),
    "ignored": (_gt([PERSON]) + _gt([(300, 100, 41, 100)], ignore=1),
                _dt([PERSON, (302, 101, 41, 100)], [0.9, 0.95])),
    "false_positive": (_gt([PERSON]),
                       _dt([PERSON, (900, 300, 41, 100)], [0.6, 0.8])),
    "small_and_occluded": (_gt([(100, 100, 25, 60)], vis=0.4),
                           _dt([(101, 100, 25, 60)], [0.7])),
    "random_0": _random_case(0),
    "random_1": _random_case(1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_miss_rates_match_jax(case):
    gts, dts = CASES[case]
    coco = {"images": [{"id": i} for i in (1, 2, 3)], "annotations": gts}
    ref = JM.CityPersonsMREvaluator(coco).evaluate(dts)
    got = TM.CityPersonsMREvaluator(coco).evaluate(dts)
    assert got == ref
    assert list(got) == TM.SETUP_LABELS == JM.SETUP_LABELS
    if case == "perfect":
        assert got["Reasonable"] == 0.0
    for setup in range(4):
        by_img = {}
        for g in gts:
            by_img.setdefault(g["image_id"], []).append(g)
        dt_by = {}
        for d in dts:
            dt_by.setdefault(d["image_id"], []).append(
                {**d, "height": d["bbox"][3]})
        assert TM.evaluate_setup(by_img, dt_by, [1, 2, 3], setup) == \
            JM.evaluate_setup(by_img, dt_by, [1, 2, 3], setup)


def test_coco_dump_matches_jax():
    rs = np.random.RandomState(2)
    results = [rs.uniform(0, 500, (5, 5)).astype(np.float32),
               rs.uniform(0, 500, (2, 5)).astype(np.float32)]
    assert TM.bbox_results_to_coco(results, 7) == \
        JM.bbox_results_to_coco(results, 7)


# -- registry and config ------------------------------------------------------


def test_registry():
    from blockcopy_tpu_torch.utils.registry import Registry, build_from_cfg
    reg = Registry("thing")

    @reg.register_module
    class Box:
        def __init__(self, w, h=1):
            self.w, self.h = w, h

    reg.register_module(Box, name="Alias")
    assert reg.get("Box") is Box and reg.get("Alias") is Box
    assert reg.name == "thing" and set(reg.module_dict) == {"Box", "Alias"}
    with pytest.raises(KeyError):
        reg.register_module(Box)
    obj = build_from_cfg({"type": "Box", "w": 3}, reg, {"h": 5, "w": 9})
    assert (obj.w, obj.h) == (3, 5)
    assert build_from_cfg({"type": Box, "w": 2}, reg).w == 2
    with pytest.raises(KeyError):
        build_from_cfg({"type": "Missing"}, reg)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_builder_matches_jax(path):
    """``load_config`` and ``csp_config_from_dict`` on a shipped config,
    against JAX's; the datasets it names are registered."""
    from blockcopy_tpu.models.builder import csp_config_from_dict as jbuild
    from blockcopy_tpu.utils.registry import load_config as jload
    from blockcopy_tpu_torch.models.builder import csp_config_from_dict
    from blockcopy_tpu_torch.utils.registry import DATASETS, load_config
    cfg = load_config(path)
    assert cfg == jload(path)
    assert dataclasses.asdict(csp_config_from_dict(cfg)) == \
        dataclasses.asdict(jbuild(cfg))
    for split in ("test", "train"):
        assert DATASETS.get(cfg["data"][split]["type"]) is not None
    assert DATASETS.get("CocoCSPORIClipDataset") is \
        DATASETS.get("CityPersonsClipDataset")


def test_build_detector_settings(tmp_path):
    """Defaults, then the config's ``blockcopy_settings``, then the
    override; an npz checkpoint (the JAX layout) loads as it was saved."""
    from blockcopy_tpu_torch.models.builder import build_detector
    from blockcopy_tpu_torch.models.csp import CSPConfig, init_csp
    from blockcopy_tpu_torch.utils.checkpoint import save_params
    cfg = {"model": {"type": "CSPBlockCopy",
                     "backbone": {"stage_blocks": (1, 1, 1, 1)},
                     "blockcopy_settings": {"block_target": 0.4,
                                            "block_size": 64}}}
    params = init_csp(CSPConfig(stage_blocks=(1, 1, 1, 1)), seed=3,
                      device="cpu")
    save_params(str(tmp_path / "csp.npz"), params)
    model = build_detector(cfg, checkpoint=str(tmp_path / "csp.npz"),
                           settings_override={"block_size": 128},
                           device="cpu")
    assert_tree(params, model.params, assert_same)
    assert model.settings["block_policy"] == "rl_objectdetection"
    assert model.settings["block_num_classes"] == 1
    assert (model.settings["block_target"], model.block_size) == (0.4, 128)
    assert model.cfg.stage_blocks == (1, 1, 1, 1)
    with pytest.raises(ValueError, match="CSPBlockCopy"):
        build_detector({"model": {"type": "Other"}}, device="cpu")


# -- checkpoints --------------------------------------------------------------


def fake_csp_sd(rs, stage_blocks=(1, 2, 1, 1), width=8):
    """An mmdet-style CSP ``state_dict`` of random arrays with the
    reference's keys (channel widths cut: the converter keys on names)."""
    sd = {}

    def conv(key, cout, cin, k, bias=False):
        sd[key + ".weight"] = rs.randn(cout, cin, k, k).astype(np.float32)
        if bias:
            sd[key + ".bias"] = rs.randn(cout).astype(np.float32)

    def bn(key, c):
        sd[key + ".weight"] = rs.rand(c).astype(np.float32) + 0.5
        sd[key + ".bias"] = rs.randn(c).astype(np.float32) * 0.1
        sd[key + ".running_mean"] = rs.randn(c).astype(np.float32) * 0.1
        sd[key + ".running_var"] = rs.rand(c).astype(np.float32) + 0.5

    conv("backbone.conv1", width, 3, 7)
    bn("backbone.bn1", width)
    cin = width
    for stage, blocks in enumerate(stage_blocks):
        planes = width * 2 ** stage
        for b in range(blocks):
            pre = f"backbone.layer{stage + 1}.{b}"
            for i, (co, ci, k) in enumerate(((planes, cin, 1),
                                             (planes, planes, 3),
                                             (planes * 4, planes, 1)), 1):
                conv(f"{pre}.conv{i}", co, ci, k)
                bn(f"{pre}.bn{i}", co)
            if b == 0:
                conv(f"{pre}.downsample.0", planes * 4, cin, 1)
                bn(f"{pre}.downsample.1", planes * 4)
            cin = planes * 4
    for i, p in enumerate(("p3", "p4", "p5")):
        sd[f"neck.{p}.weight"] = rs.randn(width * 2 ** (i + 3), 16, 4,
                                          4).astype(np.float32)
        sd[f"neck.{p}.bias"] = rs.randn(16).astype(np.float32)
        sd[f"neck.{p}_l2.weight"] = rs.rand(16).astype(np.float32) * 10
    for branch in ("cls", "reg", "offset"):
        pre = f"bbox_head.{branch}_convs.0"
        conv(f"{pre}.conv", 32, 48, 3)
        sd[f"{pre}.gn.weight"] = rs.rand(32).astype(np.float32)
        sd[f"{pre}.gn.bias"] = rs.randn(32).astype(np.float32)
    for key, co in (("csp_cls", 1), ("csp_reg", 1), ("csp_offset", 2)):
        conv(f"bbox_head.{key}", co, 32, 3, bias=True)
    sd["bbox_head.reg_scales.0.scale"] = np.float32(1.25)
    sd["bbox_head.offset_scales.0.scale"] = np.float32(0.75)
    return sd


@pytest.mark.parametrize("suffix, dtype", [(".pth", "float32"),
                                           (".pth.stu", "float32"),
                                           (".pth", "bfloat16")])
def test_checkpoint_converter_matches_jax(tmp_path, suffix, dtype):
    """A seeded mmdet-style file (the mean-teacher ``.stu`` one with
    ``module.`` names and no ``state_dict`` wrapper) through both loaders:
    the port's tree equals ``params_from_jax`` of JAX's, bit for bit."""
    import jax.numpy as jnp

    from blockcopy_tpu.models.csp import CSPConfig as JConfig
    from blockcopy_tpu.tasks.detection.checkpoint import \
        load_csp_torch_checkpoint as jload
    from blockcopy_tpu_torch.models.builder import load_csp_params
    from blockcopy_tpu_torch.models.csp import CSPConfig
    from blockcopy_tpu_torch.tasks.detection.checkpoint import \
        convert_csp_state_dict
    from blockcopy_tpu_torch.utils.convert import params_from_jax
    sd = fake_csp_sd(np.random.RandomState(0))
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    path = str(tmp_path / f"csp{suffix}")
    if suffix.endswith(".stu"):
        torch.save({f"module.{k}": v for k, v in tensors.items()}, path)
    else:
        torch.save({"state_dict": tensors, "meta": {"epoch": 3}}, path)
    tdt = getattr(torch, dtype)
    got = load_csp_params(path, CSPConfig(), tdt, "cpu")
    ref = params_from_jax(jtree(jload(path, JConfig(), getattr(jnp, dtype))),
                          device="cpu")

    def same(a, b, m):
        assert a.dtype == b.dtype == tdt, m
        assert_same(a, b, m)

    assert_tree(ref, got, same)
    if dtype == "float32":
        assert_tree(got, convert_csp_state_dict(sd, CSPConfig()),
                    assert_same)
    assert len(got["backbone"]["layer2"]) == 2
    assert tuple(got["neck"]["p4"]["w"].shape) == (128, 16, 4, 4)


# -- dataset ------------------------------------------------------------------


def test_clip_dataset_matches_jax(tmp_path):
    """Two annotated frames, each the end of a 3-frame clip of PNGs whose
    size differs from ``img_scale`` (so the bilinear resize runs)."""
    from PIL import Image

    from blockcopy_tpu.tasks.detection.dataset import \
        CityPersonsClipDataset as JD
    from blockcopy_tpu_torch.tasks.detection.dataset import (
        IMG_MEAN, IMG_STD, CityPersonsClipDataset)
    rs = np.random.RandomState(0)
    root = tmp_path / "seq"
    (root / "city").mkdir(parents=True)
    images, anns = [], []
    for i, fid in enumerate((19, 42)):
        for t in range(3):
            arr = rs.randint(0, 256, (20, 36, 3), dtype=np.uint8)
            Image.fromarray(arr).save(
                root / "city" / f"city_000123_{fid - t:06d}_leftImg8bit.png")
        images.append({"id": i + 1, "file_name":
                       f"city/city_000123_{fid:06d}_leftImg8bit.png"})
        anns.append({"id": i + 1, "image_id": i + 1,
                     "bbox": [1, 2, 3, 4]})
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns}))
    kw = dict(img_scale=(32, 16), clip_length=3)
    ref = JD(str(ann), str(root), **kw)
    got = CityPersonsClipDataset(str(ann), str(root), **kw)
    assert len(got) == len(ref) == 2
    np.testing.assert_array_equal(IMG_MEAN, np.array([123.675, 116.28,
                                                      103.53], np.float32))
    assert IMG_STD.dtype == np.float32
    for i in range(2):
        (rc, ra, rm), (gc, ga, gm) = ref[i], got[i]
        assert len(gc) == 3 and gc[0].shape == (16, 32, 3)
        for a, b in zip(rc, gc):
            assert b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        assert (ga, gm) == (ra, rm)
