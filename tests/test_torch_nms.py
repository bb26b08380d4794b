"""The detection decode, NMS and information gain of the port held against
the JAX package on the same inputs.

Both NMS lowerings of the port are held against both of JAX's, on random
sets, a deep suppression chain, score ties and a planted cluster of
overlapping boxes: the keep masks must be equal exactly.  The decode is fed
JAX's own maps, with JAX's top-k in its 'sort' lowering (``TOPK_IMPL``):
top-k indices, ``valid`` and ``labels`` equal exactly, boxes and scores
within 1e-6 relative.  The fixed-size gain functions and the host ones
must be equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockcopy_tpu.models.csp as JC
import blockcopy_tpu.ops.nms as JN
import blockcopy_tpu.tasks.detection.information_gain as JI
import blockcopy_tpu_torch.models.csp as TC
import blockcopy_tpu_torch.ops.nms as TN
import blockcopy_tpu_torch.tasks.detection.information_gain as TI
from torch_port_util import assert_same, npf, tt
from torch_port_util import two_torch_threads  # noqa: F401

IMPLS = ("loop", "fixpoint")


def _random_set(rs, n=150):
    xy = rs.rand(n, 2) * 80
    wh = rs.rand(n, 2) * 40 + 4
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return boxes, rs.rand(n).astype(np.float32), rs.rand(n) > 0.2


def _nms_cases():
    rs = np.random.RandomState(11)
    cases = {"random0": _random_set(rs), "random1": _random_set(rs)}
    # each box overlaps only its neighbours and scores descend: greedy keeps
    # every other box, a suppression chain n/2 deep
    n = 64
    x = (np.arange(n) * 6.0).astype(np.float32)
    boxes = np.stack([x, np.zeros(n, np.float32), x + 12,
                      np.full(n, 10, np.float32)], 1)
    cases["chain"] = (boxes, np.linspace(1.0, 0.5, n).astype(np.float32),
                      np.ones(n, bool))
    # ties: the pivot order breaks them to the lower index
    b, s, v = cases["random0"]
    cases["ties"] = (b, np.round(s, 1), v)
    # a cluster of jittered boxes around two centres over a random field
    b, s, v = _random_set(rs, 120)
    c = np.array([[30, 30, 60, 70], [50, 40, 80, 80]], np.float32)
    jit = rs.randn(40, 4).astype(np.float32) * 3
    b[:40] = c[np.arange(40) % 2] + jit
    s[:40] = np.sort(rs.rand(40))[::-1] * 0.5 + 0.5
    v[:40] = True
    cases["cluster"] = (b, s.astype(np.float32), v)
    return cases


CASES = _nms_cases()


def test_box_iou_matrix():
    boxes = CASES["cluster"][0]
    assert_same(JN.box_iou_matrix(jnp.asarray(boxes)),
                TN.box_iou_matrix(tt(boxes)))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("max_keep", [None, 7])
def test_nms_mask_matches_jax(case, max_keep):
    boxes, scores, valid = CASES[case]
    ref = {impl: np.asarray(JN.nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), 0.35, jnp.asarray(valid),
        max_keep=max_keep, impl=impl)) for impl in IMPLS}
    np.testing.assert_array_equal(ref["loop"], ref["fixpoint"])
    if case in ("chain", "cluster"):
        # chains: kept boxes whose suppressor was itself suppressed
        assert 2 < ref["loop"].sum() < len(boxes) - 2
    for impl in IMPLS:
        got = TN.nms_mask(tt(boxes), tt(scores), 0.35, tt(valid),
                          max_keep=max_keep, impl=impl)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(npf(got), ref["loop"], err_msg=impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,max_per_img", [(120, 20), (5, 8)])
def test_multiclass_nms_fixed(impl, n, max_per_img):
    """Two classes over shared boxes; with fewer rows than the output the
    output is padded."""
    boxes, _, _ = CASES["cluster"]
    rs = np.random.RandomState(3)
    scores = rs.rand(120, 2).astype(np.float32)
    ref = JN.multiclass_nms_fixed(jnp.asarray(boxes[:n]),
                                  jnp.asarray(scores[:n]), 0.3, 0.5,
                                  max_per_img, impl=impl)
    got = TN.multiclass_nms_fixed(tt(boxes[:n]), tt(scores[:n]), 0.3, 0.5,
                                  max_per_img, impl=impl)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    for r, g in zip(ref, got):
        assert_same(r, g)


def _maps(seed, h=32, w=64):
    """Decode inputs: logits on a coarse lattice (many exact ties), a planted
    cluster of high scores whose tall boxes overlap their neighbours, and
    random heights and offsets."""
    rs = np.random.RandomState(seed)
    cls = np.round(rs.randn(1, h, w, 1) * 4) / 4 - 4.5
    cls[0, 10:16, 20:28, 0] = np.round(rs.rand(6, 8) * 8) / 4 + 1.0
    reg = rs.randn(1, h, w, 1) * 0.2 + np.log(5.0)
    reg[0, 10:16, 20:28, 0] += np.log(4.0)
    off = rs.randn(1, h, w, 2) * 0.3
    return [a.astype(np.float32) for a in (cls, reg, off)]


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_matches_jax(monkeypatch, seed):
    monkeypatch.setattr(JC, "TOPK_IMPL", "sort")
    cls, reg, off = _maps(seed)
    img_shape = (128, 256)
    jcfg = JC.CSPConfig(nms_pre=300, max_per_img=100)
    tcfg = TC.CSPConfig(nms_pre=300, max_per_img=100)
    jmaps = [jnp.asarray(a) for a in (cls, reg, off)]
    tmaps = [tt(a) for a in (cls, reg, off)]

    scores = jax.nn.sigmoid(jmaps[0][0].reshape(-1, 1))
    _, ref_top = jax.lax.top_k(scores.max(axis=1), 300)
    top, _, _ = TC.decode_candidates(*tmaps, img_shape, tcfg)
    assert_same(ref_top, top)
    # ties sit inside the top 300, so their order is exercised
    top_scores = np.asarray(scores[ref_top, 0])
    assert len(np.unique(top_scores)) < len(top_scores)

    for jimpl in IMPLS:
        ref = JC.csp_decode(*jmaps, img_shape, jcfg, nms_impl=jimpl)
        assert 8 <= int(np.asarray(ref[2]).sum()) < 100
        for timpl in IMPLS:
            dets, labels, valid = TC.csp_decode(*tmaps, img_shape, tcfg,
                                                nms_impl=timpl)
            assert_same(ref[2], valid, f"{jimpl} {timpl}")
            assert_same(ref[1], labels, f"{jimpl} {timpl}")
            np.testing.assert_allclose(npf(dets), np.asarray(ref[0]),
                                       rtol=1e-6, atol=1e-6)


def test_height2bbox_and_host_helpers():
    rs = np.random.RandomState(2)
    pts = rs.rand(50, 2).astype(np.float32) * 100
    hgt = rs.rand(50, 1).astype(np.float32) * 40
    off = rs.randn(50, 2).astype(np.float32)
    ref = JC.csp_height2bbox(jnp.asarray(pts), jnp.asarray(hgt),
                             jnp.asarray(off), 4, 0.41, (64, 96))
    got = TC.csp_height2bbox(tt(pts), tt(hgt), tt(off), 4, 0.41, (64, 96))
    np.testing.assert_allclose(npf(got), np.asarray(ref), rtol=1e-6)

    dets = np.concatenate([CASES["cluster"][0][:30],
                           rs.rand(30, 1).astype(np.float32)], 1)
    labels = rs.randint(0, 2, 30).astype(np.int32)
    valid = rs.rand(30) > 0.3
    for r, g in zip(JN.soft_nms_numpy(dets, 0.3), TN.soft_nms_numpy(dets,
                                                                   0.3)):
        np.testing.assert_array_equal(g, r)
    cfg = JC.CSPConfig(nms_iou=0.3)
    for r, g in zip(JC.soft_nms_rescore(dets, labels, valid, cfg),
                    TC.soft_nms_rescore(tt(dets), tt(labels), tt(valid),
                                        TC.CSPConfig(nms_iou=0.3))):
        np.testing.assert_array_equal(g, r)
    ref = JC.dets_to_bbox_results(dets, labels, valid, 3)
    got = TC.dets_to_bbox_results(tt(dets), tt(labels), tt(valid), 3)
    assert len(got) == 1 and len(got[0]) == 2
    for r, g in zip(ref[0], got[0]):
        np.testing.assert_array_equal(g, r)


def _random_dets(k_valid, k_total, seed, h=128, w=256, dup=0):
    """Fixed-size dets with ``k_valid`` valid rows; the last ``dup`` valid
    rows repeat earlier ones (ties in the best match)."""
    rs = np.random.RandomState(seed)
    dets = np.zeros((k_total, 5), np.float32)
    x1 = rs.uniform(0, w - 20, k_valid)
    y1 = rs.uniform(0, h - 20, k_valid)
    dets[:k_valid, 0] = x1
    dets[:k_valid, 1] = y1
    dets[:k_valid, 2] = np.minimum(x1 + rs.uniform(4, 60, k_valid), w - 1)
    dets[:k_valid, 3] = np.minimum(y1 + rs.uniform(4, 60, k_valid), h - 1)
    dets[:k_valid, 4] = rs.uniform(0.1, 1.0, k_valid)
    if dup:
        dets[k_valid - dup:k_valid, :4] = dets[:dup, :4]
    labels = rs.randint(0, 2, k_total).astype(np.int32)
    valid = np.zeros((k_total,), bool)
    valid[:k_valid] = True
    return dets, labels, valid


def _bbox_results(dets, labels, valid, num_fg=2):
    return [[dets[valid & (labels == c)] for c in range(num_fg)]]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kcur,kprev", [(9, 12), (0, 4), (6, 0)])
def test_iou_gain_fixed(seed, kcur, kprev):
    h, w, k = 128, 256, 16
    cur = _random_dets(kcur, k, seed, h, w)
    prev = _random_dets(kprev, k, seed + 100, h, w, dup=min(kprev, 3))
    ref = JI.iou_gain_fixed(*(jnp.asarray(a) for a in cur + prev), (h, w), 2)
    got = TI.iou_gain_fixed(*(tt(a) for a in cur + prev), (h, w), 2)
    assert tuple(got.shape) == (1, 64, 128, 1)
    assert_same(ref, got)
    # and the host versions, equal to each other's
    size = (1, h, w, 2)
    assert_same(JI.build_instance_mask_iou_gain(_bbox_results(*cur),
                                                _bbox_results(*prev), size),
                TI.build_instance_mask_iou_gain(_bbox_results(*cur),
                                                _bbox_results(*prev), size))
    assert_same(JI.build_instance_mask(_bbox_results(*cur), size),
                TI.build_instance_mask(_bbox_results(*cur), size))


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_instance_mask_fixed(scale):
    dets, labels, valid = _random_dets(11, 16, 4)
    ref = JI.instance_mask_fixed(jnp.asarray(dets), jnp.asarray(labels),
                                 jnp.asarray(valid), (40, 70), 2, scale)
    got = TI.instance_mask_fixed(tt(dets), tt(labels), tt(valid), (40, 70),
                                 2, scale)
    assert_same(ref, got)


def test_paint_boxes_max_and_gain_object():
    h, w = 64, 96
    rs = np.random.RandomState(0)
    boxes = np.stack([rs.randint(0, w // 2, 17), rs.randint(0, h // 2, 17),
                      rs.randint(w // 2, w, 17), rs.randint(h // 2, h, 17)],
                     -1).astype(np.int32)
    weights = rs.uniform(0, 1, 17).astype(np.float32)
    assert_same(JI.paint_boxes_max(jnp.asarray(boxes), jnp.asarray(weights),
                                   h, w),
                TI.paint_boxes_max(tt(boxes), tt(weights), h, w))
    assert TI.get_iou(boxes[0], boxes[1]) == JI.get_iou(boxes[0], boxes[1])

    cur, prev = _random_dets(7, 16, 5), _random_dets(5, 16, 6)
    meta = {"inputs": np.zeros((1, 128, 256, 3), np.float32),
            "outputs": _bbox_results(*cur),
            "outputs_prev": _bbox_results(*prev)}
    jg, tg = JI.DetectionInformationGain(2), TI.DetectionInformationGain(2)
    assert_same(jg.compute(meta), tg.compute(meta))
    assert_same(jg.get_output_repr(meta), tg.get_output_repr(meta))
