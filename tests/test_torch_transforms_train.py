"""The port's training transforms (``blockcopy_tpu_torch/data/transforms.py``)
against the JAX package's, bit for bit: the port's draw from the
``random.Random(seed)`` they are given, JAX's from the module ``random``
after ``random.seed(seed)`` (the same MT19937 stream)."""

import random

import numpy as np
import pytest
from PIL import Image

from blockcopy_tpu.data import transforms as JT
from blockcopy_tpu_torch.data import transforms as TT
from torch_port_util import two_torch_threads  # noqa: F401

CASES = {
    "hflip": lambda m, **r: m.ExtRandomHorizontalFlip(0.5, **r),
    "vflip": lambda m, **r: m.ExtRandomVerticalFlip(0.5, **r),
    "center_crop": lambda m, **r: m.ExtCenterCrop((40, 50)),
    "random_crop": lambda m, **r: m.ExtRandomCrop((48, 64), **r),
    "random_crop_pad": lambda m, **r: m.ExtRandomCrop((96, 120), **r),
    "scale": lambda m, **r: m.ExtRandomScale((0.5, 1.5), **r),
    "color_jitter": lambda m, **r: m.ExtColorJitter(0.4, 0.3, 0.2, **r),
    "rotation": lambda m, **r: m.ExtRandomRotation(15, **r),
    "rotation_expand": lambda m, **r: m.ExtRandomRotation((-30, 10),
                                                          expand=True, **r),
    "blur": lambda m, **r: m.ExtGaussianBlur((0.1, 2.0), 0.7, **r),
    "pad": lambda m, **r: m.ExtPad(32),
    "scale_choice": lambda m, **r: m.ExtRandomScaleChoice((0.5, 0.75, 1.25),
                                                          **r),
}


def _pair(seed):
    rs = np.random.RandomState(seed)
    img = Image.fromarray(rs.randint(0, 256, (70, 90, 3), np.uint8))
    lbl = Image.fromarray(rs.randint(0, 19, (70, 90), np.uint8))
    return img, lbl


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("with_label", [True, False])
def test_training_transform_bitwise(name, with_label):
    """Six calls in a row (both sides of every coin), each output equal."""
    seed = 11
    random.seed(seed)
    ref_t = CASES[name](JT)
    got_t = CASES[name](TT, rng=random.Random(seed))
    for i in range(6):
        img, lbl = _pair(i)
        lbl = lbl if with_label else None
        ref = ref_t(img, lbl)
        got = got_t(img, lbl)
        for r, g in zip(ref, got):
            if r is None:
                assert g is None
                continue
            assert (r.mode, r.size) == (g.mode, g.size), (name, i)
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                          err_msg=f"{name} call {i}")


def test_default_rng_is_the_module_random():
    """Without ``rng`` the port draws from the module ``random``, as JAX."""
    img, lbl = _pair(0)
    outs = []
    for m in (JT, TT):
        random.seed(5)
        t = m.ExtRandomCrop((32, 32))
        outs.append([np.asarray(t(img, lbl)[0]) for _ in range(4)])
    for r, g in zip(*outs):
        np.testing.assert_array_equal(g, r)


def test_compose_and_eval_chain():
    """A train chain into the eval tail (ToArray, Normalize) through
    ``ExtCompose``, against JAX's."""
    def chain(m, **r):
        return m.ExtCompose([m.ExtRandomScale((0.75, 1.25), **r),
                             m.ExtRandomCrop((48, 64), **r),
                             m.ExtRandomHorizontalFlip(**r), m.ExtToArray(),
                             m.ExtNormalize((0.5, 0.4, 0.3),
                                            (0.2, 0.25, 0.3))])
    random.seed(3)
    ref_t, got_t = chain(JT), chain(TT, rng=random.Random(3))
    for i in range(3):
        img, lbl = _pair(i)
        for r, g in zip(ref_t(img, lbl), got_t(img, lbl)):
            np.testing.assert_array_equal(g, r)
