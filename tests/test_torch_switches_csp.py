"""The CSP decode's off-by-default lowerings in the port, held against the
JAX package with the switch on in both.

* ``TOPK_IMPL='approx'`` (``torch.topk``; JAX's ``approx_max_k`` at recall
  1.0): on tie-free scores the top-k indices equal JAX's exactly, and the
  decode's ``valid``/``labels`` too, boxes within 1e-6; on scores with a tie
  at rank ``nms_pre`` the kept values are the same multiset as JAX's and as
  the port's stable 'sort', whichever tied indices each picks.
* ``DECODE_LEAN_POINTS=0`` (the points gathered from the full array): bit
  for bit the lean form in the port, and JAX's non-lean decode's outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import blockcopy_tpu.models.csp as JC
import blockcopy_tpu_torch.models.csp as TC
from torch_port_util import assert_same, npf, tt
from torch_port_util import two_torch_threads  # noqa: F401

H, W, NMS_PRE = 32, 64, 300
IMG = (128, 256)


def _maps(seed, ties):
    """Score, height and offset maps with a cluster of high scores whose
    tall boxes overlap; ``ties`` rounds the scores to quarters."""
    rs = np.random.RandomState(seed)
    cls = rs.randn(1, H, W, 1) - 5.0
    cls[0, 10:16, 20:28, 0] = rs.rand(6, 8) * 2 + 1.0
    if ties:
        cls = np.round(cls * 4) / 4
    reg = rs.randn(1, H, W, 1) * 0.2 + np.log(5.0)
    reg[0, 10:16, 20:28, 0] += np.log(4.0)
    off = rs.randn(1, H, W, 2) * 0.3
    return [a.astype(np.float32) for a in (cls, reg, off)]


def _cfgs():
    return (JC.CSPConfig(nms_pre=NMS_PRE, max_per_img=100),
            TC.CSPConfig(nms_pre=NMS_PRE, max_per_img=100))


def _jax_top(cls):
    scores = jax.nn.sigmoid(jnp.asarray(cls)[0].reshape(-1, 1)).max(axis=1)
    vals, idx = jax.lax.approx_max_k(scores, NMS_PRE, recall_target=1.0)
    return np.asarray(scores), np.asarray(vals), np.asarray(idx)


def _decodes_agree(ref, got):
    assert_same(ref[2], got[2])
    assert_same(ref[1], got[1])
    np.testing.assert_allclose(npf(got[0]), np.asarray(ref[0]), rtol=1e-6,
                               atol=1e-6)


def test_approx_topk_tie_free(monkeypatch):
    monkeypatch.setattr(JC, "TOPK_IMPL", "approx")
    monkeypatch.setattr(TC, "TOPK_IMPL", "approx")
    maps = _maps(0, ties=False)
    scores, _, ref_idx = _jax_top(maps[0])
    assert len(np.unique(scores)) == scores.size
    jcfg, tcfg = _cfgs()
    tmaps = [tt(a) for a in maps]
    top, _, _ = TC.decode_candidates(*tmaps, IMG, tcfg)
    assert_same(ref_idx, top)
    ref = JC.csp_decode(*map(jnp.asarray, maps), IMG, jcfg, nms_impl="loop")
    assert 8 <= int(np.asarray(ref[2]).sum()) < 100
    _decodes_agree(ref, TC.csp_decode(*tmaps, IMG, tcfg, nms_impl="loop"))


def test_approx_topk_tie_at_nms_pre(monkeypatch):
    monkeypatch.setattr(TC, "TOPK_IMPL", "approx")
    maps = _maps(1, ties=True)
    scores, ref_vals, _ = _jax_top(maps[0])
    ranked = np.sort(scores)[::-1]
    # the value at rank nms_pre is shared across the cut, and the cut
    # leaves some of its indices out
    assert ranked[NMS_PRE - 1] == ranked[NMS_PRE]
    _, tcfg = _cfgs()
    tmaps = [tt(a) for a in maps]
    top, _, _ = TC.decode_candidates(*tmaps, IMG, tcfg)
    vals = scores[npf(top)]
    assert_same(np.sort(ref_vals), np.sort(vals))
    monkeypatch.setattr(TC, "TOPK_IMPL", "sort")
    top_sort, _, _ = TC.decode_candidates(*tmaps, IMG, tcfg)
    assert_same(np.sort(scores[npf(top_sort)]), np.sort(vals))


@pytest.mark.parametrize("topk", ["sort", "approx"])
def test_decode_full_points(topk, monkeypatch):
    monkeypatch.setattr(JC, "TOPK_IMPL", topk)
    monkeypatch.setattr(TC, "TOPK_IMPL", topk)
    maps = _maps(2, ties=topk == "sort")
    jcfg, tcfg = _cfgs()
    tmaps = [tt(a) for a in maps]
    lean = TC.decode_candidates(*tmaps, IMG, tcfg)
    lean_dec = TC.csp_decode(*tmaps, IMG, tcfg, nms_impl="loop")
    monkeypatch.setattr(JC, "DECODE_LEAN_POINTS", False)
    monkeypatch.setattr(TC, "DECODE_LEAN_POINTS", False)
    full = TC.decode_candidates(*tmaps, IMG, tcfg)
    for a, b in zip(lean, full):
        assert_same(a, b)
    got = TC.csp_decode(*tmaps, IMG, tcfg, nms_impl="loop")
    for a, b in zip(lean_dec, got):
        assert_same(a, b)
    ref = JC.csp_decode(*map(jnp.asarray, maps), IMG, jcfg, nms_impl="loop")
    _decodes_agree(ref, got)
