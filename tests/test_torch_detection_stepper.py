"""The slice as a whole: the port's ``DetectionStepper`` held against JAX's
over a 4-frame clip at 256x256 (``CSPConfig(stage_blocks=(1, 2, 2, 1))`` at
full widths, block 128, capacity 2 of 4, the fast policy,
``train_interval=2`` so frames 2 and 4 run a REINFORCE update).

The port is fed the uniforms JAX draws (its key chain replayed, as in
``tests/test_torch_stepper.py``).  Grids and executed indices must be equal
exactly, ``valid`` and ``labels`` too; every carried canvas, the dets and the
policy state are held at 1e-3 of each tensor's largest magnitude (the
stepper test's tolerance: four frames through a random-init RN50 with
RMSprop steps).  The ``csp_cls`` bias is set to 0 and ``score_thr`` to
0.6, so 12-26 of the 100 dets are valid on each frame and the decode, the
NMS and the IoU gain run on real boxes (at the init bias, sigmoid(-4.6) <
0.1 leaves every det invalid).  The two frameworks' maps differ by rounding,
so two dets whose scores nearly tie may swap places: the dets are matched by
box before their scores are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockcopy_tpu.models.csp as JC
import blockcopy_tpu.policy.net as JN
import blockcopy_tpu_torch.models.csp as TC
import blockcopy_tpu_torch.policy.net as TN
from blockcopy_tpu.core import grid as JG
from blockcopy_tpu.core import stepper as JST
from blockcopy_tpu.tasks.detection.stepper import DetectionStepper as JDS
from blockcopy_tpu_torch.core import grid as TG
from blockcopy_tpu_torch.core import stepper as TST
from blockcopy_tpu_torch.tasks.detection.stepper import (
    DetectionStepper as TDS)
from blockcopy_tpu_torch.utils.convert import (params_from_jax,
                                               params_to_numpy,
                                               policy_state_from_jax,
                                               stepper_state_to_numpy)
from torch_port_util import (assert_same, assert_tree, close_rel, jtree,
                             moving_square_frames, npf, stepper_draws, tt)
from torch_port_util import two_torch_threads  # noqa: F401

SHAPE = (1, 256, 256, 3)
CAPACITY = 2
TOL = 1e-3
CFG = dict(stage_blocks=(1, 2, 2, 1))
SCORE_THR = 0.6


def _match_dets(ref, got, frame):
    """``valid`` and ``labels`` equal; each valid port det matches the JAX
    det with the nearest box, within ``TOL`` (box and score)."""
    (rd, rl, rv), (gd, gl, gv) = ([npf(a) for a in t] for t in (ref, got))
    assert_same(rv, gv, f"valid, frame {frame}")
    assert_same(rl, gl, f"labels, frame {frame}")
    rd, gd = rd[rv], gd[gv]
    dist = np.abs(gd[:, None, :4] - rd[None, :, :4]).max(-1)
    j = dist.argmin(1)
    assert len(set(j.tolist())) == len(j), f"frame {frame}: dets unmatched"
    np.testing.assert_allclose(gd, rd[j], rtol=TOL, atol=TOL * max(
        1.0, float(np.abs(rd).max())), err_msg=f"dets, frame {frame}")


def _compare(js, ts, frame):
    ref = jtree({k: v for k, v in js.items()})
    ref["policy"] = {k: v for k, v in ref["policy"].items() if k != "key"}
    got = stepper_state_to_numpy(ts)
    assert int(ref["frame_idx"]) == got["frame_idx"] == frame
    assert_same(ref["prev_grid"], got["prev_grid"], f"grid, frame {frame}")
    assert sorted(ref["canvases"]) == sorted(got["canvases"])
    assert_tree(ref["canvases"], got["canvases"],
                lambda a, b, m: close_rel(a, b, TOL, f"frame {frame}{m}"))
    for suffix in ("", "_prev"):
        _match_dets([ref[f"{k}{suffix}"] for k in TDS.task_keys],
                    [got[f"{k}{suffix}"] for k in TDS.task_keys], frame)
    pol_ref, pol_got = dict(ref["policy"]), dict(got["policy"])
    assert_tree(pol_ref.pop("params"), pol_got.pop("params"),
                lambda a, b, m: np.testing.assert_allclose(
                    b, a, rtol=TOL, atol=1e-5, err_msg=f"frame {frame}{m}"))
    assert_tree(pol_ref, pol_got,
                lambda a, b, m: close_rel(a, b, TOL, f"frame {frame}{m}"))


def test_detection_clip_matches_jax(monkeypatch):
    monkeypatch.setattr(JC, "TOPK_IMPL", "sort")
    monkeypatch.setattr(JN, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TN, "COMPUTE_DTYPE", torch.float32)
    tparams = TC.init_csp(TC.CSPConfig(**CFG), seed=0, device="cpu")
    tparams["head"]["csp_cls"]["b"].zero_()
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(tparams))
    tparams = params_from_jax(jtree(jparams), device="cpu")
    kw = dict(block_size=128, train_interval=2, num_classes=1,
              policy_arch="fast")
    jst = JDS(JC.CSPConfig(score_thr=SCORE_THR, **CFG),
              JST.StepperConfig(**kw), SHAPE, CAPACITY)
    tst = TDS(TC.CSPConfig(score_thr=SCORE_THR, **CFG),
              TST.StepperConfig(**kw), SHAPE, CAPACITY, device="cpu")

    js = jst.init_state(jparams, jax.random.PRNGKey(1))
    opt = js["policy"]["opt"]
    js["policy"]["opt"] = opt._replace(square_avg=jax.tree.map(
        lambda a: jnp.full_like(a, 1e-4), opt.square_avg))
    ts = tst.init_state(tparams, seed=1)
    # the meta-device shape pass builds JAX's canvases and task outputs
    zeros = stepper_state_to_numpy(ts)
    assert_tree(jtree(js["canvases"]), zeros["canvases"], assert_same)
    for k in TDS.task_keys:
        assert_same(js[k], zeros[k])
        assert ts[k].dtype == {"dets": torch.float32, "labels": torch.int32,
                               "valid": torch.bool}[k]
    ts["policy"] = {**policy_state_from_jax(jtree(js["policy"]),
                                          device="cpu"),
                    "generator": ts["policy"]["generator"]}

    frames = moving_square_frames(SHAPE, 4)
    # jitted: JAX compiles two programs instead of every op of both shapes
    jfirst, jstep = jax.jit(jst.first_step), jax.jit(jst.step)
    js = jfirst(jparams, js, jnp.asarray(frames[0]))
    ts = tst.first_step(tparams, ts, tt(frames[0]))
    _compare(js, ts, 1)
    assert 8 <= int(ts["valid"].sum()) < 100
    heads = [npf(ts["policy"]["params"]["head1"]["w"]).copy()]
    n, gh, gw = jst.geom
    for t, frame in enumerate(frames[1:], start=2):
        u, u_rank = stepper_draws(js["policy"], (n, gh, gw), n * gh * gw)
        js = jstep(jparams, js, jnp.asarray(frame))
        ts = tst.step(tparams, ts, tt(frame), draws=(tt(u), tt(u_rank)))
        _compare(js, ts, t)
        assert float(ts["prev_grid"].sum()) == CAPACITY
        assert_same(JG.exec_indices(js["prev_grid"] > 0, CAPACITY),
                    TG.exec_indices(ts["prev_grid"] > 0, CAPACITY))
        heads.append(npf(ts["policy"]["params"]["head1"]["w"]).copy())
        dets, labels, valid = tst.fetch_outputs(ts)
        assert 8 <= int(valid.sum()) < 100
        assert bool(torch.isfinite(dets).all())
    # REINFORCE ran on frames 2 and 4 only
    changed = [not np.array_equal(a, b) for a, b in zip(heads, heads[1:])]
    assert changed == [True, False, True]


@pytest.mark.parametrize("block", [128, 64])
def test_macs_and_task_shapes(block):
    """The shape pass gives the decode's fixed shapes (100 dets) without
    running it, and the MAC tally's modules."""
    st = TDS(TC.CSPConfig(**CFG), TST.StepperConfig(
        block_size=block, num_classes=1, policy_arch="fast"), SHAPE, 2,
        device="cpu")
    params = TC.init_csp(TC.CSPConfig(**CFG), seed=0, device="meta")
    _, task = st._shape_pass(params, st.total)
    assert {k: tuple(v.shape) for k, v in task.items()} == {
        "dets": (100, 5), "labels": (100,), "valid": (100,)}
    macs = st.macs_breakdown_per_step(params)
    assert set(macs) == {"backbone", "neck", "head", "policy"}
    assert all(v > 0 for v in macs.values())


def test_detection_clip_tool_on_cpu():
    """``tools/measure.py:detection_clip``, which holds the card against
    the CPU (``chip_smoke.py`` phase 9b, the GPU tests), on the CPU: the
    injected draws give 4-block grids, some dets are valid, and the carried
    canvases include the head's three output maps."""
    from blockcopy_tpu_torch.tools.measure import compare_clips, detection_clip
    clip = detection_clip("cpu", frames=2)
    assert [int(f["grid"].sum()) for f in clip] == [8, 4]
    for f in clip:
        dets, labels, valid = f["dets"]
        assert tuple(dets.shape) == (100, 5) and 0 < int(valid.sum()) < 100
        assert {"head.csp_cls.out", "head.csp_reg.out",
                "head.csp_offset.out"} <= set(f["canvases"])
    # each frame's canvases are a snapshot, not the live buffers
    fs = TST.FRAME_STATE
    assert not torch.equal(clip[0]["canvases"][fs], clip[1]["canvases"][fs])
    assert compare_clips(clip, clip) == (True, 0.0, [0.0, 0.0])
    # the comparison sees a moved box, a changed label, a changed canvas
    moved = [{**f, "dets": (f["dets"][0] + 0.5, *f["dets"][1:])}
             for f in clip]
    assert compare_clips(moved, clip)[2][0] > 1e-3
    relabeled = [{**f, "dets": (f["dets"][0], 1 - f["dets"][1],
                                f["dets"][2])} for f in clip]
    assert compare_clips(relabeled, clip)[2] == [None, None]
    name = "head.csp_cls.out"
    bumped = [{**f, "canvases": {**f["canvases"],
                                 name: f["canvases"][name] + 1.0}}
              for f in clip]
    assert compare_clips(bumped, clip)[1] > 1e-3
