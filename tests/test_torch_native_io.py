"""The port's clip IO library (``blockcopy_tpu_torch/native``, built by g++
from its own ``io.cpp``) held against the JAX package's
(``blockcopy_tpu.native``) on the same PNG files: decode, resize, clip
decode and labels bitwise, NMS and soft-NMS exactly; against PIL within
1/255; against the port's ``ops/nms.py``; and ``CityscapesVid(native=True)``
against the JAX dataset's native path (and its PIL path against JAX's) on
a tiny Cityscapes-layout directory."""

import sys

import numpy as np
import pytest
import torch
from PIL import Image

import blockcopy_tpu.native as jnative
from blockcopy_tpu.data.cityscapes_vid import CityscapesVid as JVid
from blockcopy_tpu_torch import native
from blockcopy_tpu_torch.data import transforms as et
from blockcopy_tpu_torch.data.cityscapes_vid import CityscapesVid as TVid
from blockcopy_tpu_torch.ops.kernels import build
from blockcopy_tpu_torch.tools.measure import cityscapes_layout, write_png
from torch_port_util import two_torch_threads  # noqa: F401

MEAN = np.array([0.3, 0.4, 0.5], np.float32)
STD = np.array([0.2, 0.3, 0.4], np.float32)
ZERO, ONE = np.zeros(3, np.float32), np.ones(3, np.float32)
# (w, h) resize targets of tests/test_native.py: down, up, odd
SIZES = [(48, 32), (192, 128), (47, 29)]


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """PNGs written by PIL (RGB, gray label, gray and colour palettes) and
    by the port's own writer (RGB and palette, every row filter)."""
    if not jnative.available():
        pytest.fail("the JAX package's native library does not build")
    d = tmp_path_factory.mktemp("png")
    rs = np.random.RandomState(0)
    img = (rs.rand(64, 96, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(d / "rgb.png")
    lab = (rs.rand(32, 40) * 30).astype(np.uint8)
    Image.fromarray(lab, mode="L").save(d / "label.png")
    pal = Image.fromarray(lab, mode="P")
    pal.putpalette([i for i in range(256) for _ in range(3)])
    pal.save(d / "palette.png")
    pal.putpalette([v for i in range(256)
                    for v in ((220 - i) % 256, 20, 60)])
    pal.save(d / "palette_color.png")
    write_png(d / "rgb_filters.png", img)
    write_png(d / "palette_filters.png", lab,
              palette=rs.randint(0, 256, (256, 3)))
    return d, img, lab


@pytest.mark.parametrize("name", ["rgb.png", "rgb_filters.png"])
def test_same_size_bitwise(png_dir, name):
    d, img, _ = png_dir
    path = str(d / name)
    got = native.decode_image(path, 96, 64, MEAN, STD)
    np.testing.assert_array_equal(
        got, jnative.decode_image(path, 96, 64, MEAN, STD))
    np.testing.assert_array_equal(
        got, (img.astype(np.float32) / 255.0 - MEAN) / STD)


@pytest.mark.parametrize("size", SIZES)
def test_resize_bitwise_and_pil(png_dir, size):
    d, img, _ = png_dir
    path = str(d / "rgb.png")
    got = native.decode_image(path, size[0], size[1], MEAN, STD)
    np.testing.assert_array_equal(
        got, jnative.decode_image(path, size[0], size[1], MEAN, STD))
    out = native.decode_image(path, size[0], size[1], ZERO, ONE) * 255
    pil = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR),
                     np.float32)
    # <= 1/255: PIL quantizes to uint8, the library stays float
    assert np.abs(out - pil).max() <= 1.0 + 1e-5


def test_clip_decode_bitwise(png_dir):
    d, _, _ = png_dir
    paths = [str(d / "rgb.png"), str(d / "rgb_filters.png")] * 2
    for w, h in [(96, 64)] + SIZES[:1]:
        got = native.decode_clip(paths, w, h, MEAN, STD, num_threads=3)
        assert got.shape == (4, h, w, 3)
        np.testing.assert_array_equal(
            got, jnative.decode_clip(paths, w, h, MEAN, STD, num_threads=3))
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(got[0], got[2])


@pytest.mark.parametrize("name", ["label.png", "palette.png",
                                  "palette_color.png", "palette_filters.png"])
def test_label_decode(png_dir, name):
    """Gray values, and a palette file's indices, never its colours."""
    d, _, lab = png_dir
    got = native.decode_label(str(d / name))
    np.testing.assert_array_equal(got, lab)
    np.testing.assert_array_equal(got, jnative.decode_label(str(d / name)))


def test_missing_file_raises(tmp_path):
    missing = str(tmp_path / "missing.png")
    with pytest.raises(IOError):
        native.decode_image(missing, 8, 8, ZERO, ONE)
    with pytest.raises(IOError):
        native.decode_clip([missing], 8, 8, ZERO, ONE)
    with pytest.raises(IOError):
        native.decode_label(missing)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s output wherever
    the library is asked for; nothing falls back."""
    bad = tmp_path / "io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setitem(build.HOST_SOURCES, "io", bad)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for io.cpp"):
        native.decode_clip(["x.png"], 8, 8, ZERO, ONE)
    assert not native.available()
    assert not build._target("io").exists()


def _dets(seed, n=50):
    rs = np.random.RandomState(seed)
    xy = rs.rand(n, 2) * 100
    wh = rs.rand(n, 2) * 30 + 5
    return np.concatenate([xy, xy + wh, rs.rand(n, 1)], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_nms_exact(seed):
    from blockcopy_tpu_torch.ops.nms import nms_mask

    dets = _dets(seed)
    for thr in (0.3, 0.5, 0.7):
        keep = native.nms(dets, thr)
        np.testing.assert_array_equal(keep, jnative.nms(dets, thr))
        order = np.argsort(-dets[:, 4], kind="mergesort")
        mask = nms_mask(torch.from_numpy(dets[order, :4]),
                        torch.from_numpy(dets[order, 4]), thr).numpy()
        assert set(keep.tolist()) == set(order[mask].tolist())


@pytest.mark.parametrize("method", ["linear", "gaussian", "naive"])
def test_soft_nms_exact(method):
    from blockcopy_tpu_torch.ops.nms import soft_nms_numpy

    for seed in (4, 5):
        dets = _dets(seed, 40)
        kw = dict(iou_thr=0.3, method=method, sigma=0.5, min_score=0.05)
        rows, keep = native.soft_nms(dets, **kw)
        jrows, jkeep = jnative.soft_nms(dets, **kw)
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(keep, jkeep)
        # the port's host soft-NMS runs in float64: the same boxes in the
        # same order, scores to float32 rounding
        nrows, nkeep = soft_nms_numpy(dets, **kw)
        np.testing.assert_array_equal(keep, nkeep)
        np.testing.assert_allclose(rows, nrows, rtol=1e-5, atol=1e-6)
        for row, orig in zip(rows, keep):
            np.testing.assert_array_equal(row[:4], dets[orig, :4])


@pytest.fixture(scope="module")
def city_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cityscapes")
    cityscapes_layout(root, 64, 128, clips=2, frames=3)
    return str(root)


def _transform(res):
    return et.ExtCompose([et.ExtResize((res, res * 2)), et.ExtToArray(),
                          et.ExtNormalize(mean=TVid.mean, std=TVid.std)])


def _jax_transform(res):
    from blockcopy_tpu.data import transforms as jet
    return jet.ExtCompose([jet.ExtResize((res, res * 2)), jet.ExtToArray(),
                           jet.ExtNormalize(mean=JVid.mean, std=JVid.std)])


@pytest.mark.parametrize("res,has_labels", [(64, False), (32, False),
                                            (32, True)])
def test_dataset_native_matches_jax(city_dir, res, has_labels, monkeypatch):
    """Same clips (oldest first, bitwise) and labels as the JAX dataset's
    native path; without labels nothing imports PIL."""
    kw = dict(split="val", clip_length=3, has_labels=has_labels, native=True,
              native_size=(res, res * 2))
    ref = JVid(city_dir, transform=_jax_transform(res), **kw)
    got = TVid(city_dir, transform=_transform(res), **kw)
    assert len(got) == len(ref) == 2
    for i in range(len(ref)):
        rclip, rtarget, rmeta = ref[i]
        if not has_labels:
            monkeypatch.setitem(sys.modules, "PIL", None)
            monkeypatch.setitem(sys.modules, "PIL.Image", None)
        clip, target, meta = got[i]
        monkeypatch.undo()
        assert meta == rmeta
        assert len(clip) == 3 and clip[0].shape == (res, res * 2, 3)
        for a, b in zip(clip, rclip):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(target),
                                      np.asarray(rtarget))
        # oldest first: the last frame is the annotated one
        np.testing.assert_array_equal(
            clip[-1], native.decode_image(got.images[i], res * 2, res,
                                          TVid.mean, TVid.std))
        assert not np.array_equal(clip[0], clip[-1])


@pytest.mark.parametrize("has_labels", [False, True])
def test_dataset_pil_matches_jax(city_dir, has_labels):
    """The PIL path beside it (``native=False``): the same clips, labels and
    order as the JAX dataset's."""
    kw = dict(split="train", clip_length=3, has_labels=has_labels)
    ref = JVid(city_dir, transform=_jax_transform(32), **kw)
    got = TVid(city_dir, transform=_transform(32), **kw)
    for i in range(len(ref)):
        (clip, target, meta), (rclip, rtarget, rmeta) = got[i], ref[i]
        assert meta == rmeta and len(clip) == len(rclip) == 3
        for a, b in zip(clip, rclip):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(target),
                                      np.asarray(rtarget))


def test_dataset_native_needs_size(city_dir):
    with pytest.raises(ValueError, match="native_size"):
        TVid(city_dir, split="val", clip_length=3, native=True)


def test_build_lands_in_build_dir():
    """The library is built from the port's own source into ``_build/``."""
    native.available()
    lib = build._target("io")
    assert lib.parent == build.BUILD_DIR and lib.exists()
    assert build.source("io") == build.PKG / "native" / "io.cpp"
