"""Detection in ladder mode held against the JAX package: the port's
``CSPBlockCopy`` and the JAX one on the same parameters over a 4-frame
256x512 clip with ``rl_objectdetection`` (CSP ``stage_blocks=(1, 1, 1, 1)``
at full widths, block 128, quantum 0.5, REINFORCE on frames 2 and 4), the
port fed JAX's draws, for both policy architectures (``ref`` in
``test_torch_detection_engine_ref.py``: one file would take a minute).

Held per frame: grids and counts equal; the box lists' sizes per class
equal (so ``valid`` and the labels), each port box matched to the JAX box
nearest it and equal to 1e-4; ``frame_state`` and every canvas at 1e-4 of
the largest |JAX value|; on the train frames the gain map and the policy
input's box mask painted from JAX's box lists bit for bit, and the policy
update as ``test_torch_engine_rl.py`` holds it (norm-wise per leaf, on
JAX's inputs and on each package's own), after which JAX's policy is
carried across.  ``ref`` is held at 3e-2 and ``fast`` at 2e-2 on its own
inputs, as there; ``fast`` on JAX's inputs at 1e-2, not 1e-3: on frame 4
of this clip JAX's own fp32 update of ``block1.bn1.beta`` is 6.5e-3 from
the same update evaluated in fp64, where the port's is 2e-6 (measured; the
early layers' gradients are sums over the sparse box masks that nearly
cancel).  The ``csp_cls`` bias is 0 and ``score_thr`` 0.6, so a few dozen
boxes are valid a frame and the masks and the IoU gain are not all zero.

Then the port alone: the first frame of the ladder engine equals
``DetectionStepper.first_step`` (``tests/test_detection_stepper.py``
``test_first_step_matches_ladder_engine``), the gain's tensors land on the
policy's device in fp32, and the engine's host box lists, count-0 frames,
soft-NMS, policy files and frame-shape guard.
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
from blockcopy_tpu.core.argparser import default_settings as jset
from blockcopy_tpu_torch.core.argparser import default_settings as tset
from blockcopy_tpu_torch.utils.convert import (ladder_policy_state_from_jax,
                                               params_from_jax,
                                               params_to_numpy)
from torch_port_util import (assert_same, assert_tree, close_rel,
                             engine_clip, jax_draws, jtree, tt)
from torch_port_util import two_torch_threads  # noqa: F401

CFG = dict(stage_blocks=(1, 1, 1, 1), score_thr=0.6)
TOL = 1e-4
# arch: (tolerance on JAX's inputs, on each package's own)
TOLS = {"fast": (1e-2, 2e-2), "ref": (3e-2, 3e-2)}
_PARAMS = []


def settings(**kw):
    return dict(block_policy="rl_objectdetection", block_num_classes=1,
                block_size=128, block_quantize_number_exec=0.5,
                block_train_interval=2, **kw)


def csp_params():
    """Port-drawn CSP parameters (the ``csp_cls`` bias 0), as JAX's and
    through the converter as the port's."""
    if not _PARAMS:
        tp = TC.init_csp(TC.CSPConfig(**CFG), seed=0, device="cpu")
        tp["head"]["csp_cls"]["b"].zero_()
        jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
        _PARAMS.extend([jp, params_from_jax(jtree(jp), device="cpu")])
    return _PARAMS


def det_pair(**kw):
    jp, tp = csp_params()
    jm = JC.CSPBlockCopy(jp, JC.CSPConfig(**CFG), jset(**settings(**kw)))
    tm = TC.CSPBlockCopy(tp, TC.CSPConfig(**CFG), tset(**settings(**kw)),
                         device="cpu")
    return jm, tm


def match_boxes(ref, got, msg):
    """Per class: as many boxes, each port box within ``TOL`` of the JAX
    box nearest it (two boxes whose scores nearly tie may swap places)."""
    assert len(ref) == len(got), msg
    for c, (r, g) in enumerate(zip(ref, got)):
        assert r.shape == g.shape, f"{msg} class {c}: {r.shape} {g.shape}"
        if not len(r):
            continue
        near = np.abs(g[:, None, :4] - r[None, :, :4]).max(-1).argmin(1)
        assert len(set(near.tolist())) == len(near), f"{msg}: unmatched"
        np.testing.assert_allclose(g, r[near], rtol=TOL, atol=TOL,
                                   err_msg=f"{msg} class {c}")


def _update_err(before, after_ref, after_got):
    """Largest norm-wise relative error over the leaves of the update
    ``after - before`` (``before``: JAX's and the port's)."""
    errs = []
    for jo, jn, to, tn in zip(*(jax.tree.leaves(t) for t in
                                (before[0], after_ref, before[1],
                                 after_got))):
        da, db = jn - jo, tn - to
        if not np.any(da):
            assert not np.any(db)
            continue
        errs.append(np.linalg.norm(db - da) / max(np.linalg.norm(da),
                                                  1e-30))
    return max(errs)


def rl_clip_matches_jax(monkeypatch, arch):
    """The clip through both engines with ``arch``'s policy (the module
    docstring); ``test_torch_detection_engine_ref.py`` runs it for
    ``ref``."""
    monkeypatch.setattr(JC, "TOPK_IMPL", "sort")
    monkeypatch.setattr(JN, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TN, "COMPUTE_DTYPE", torch.float32)
    tol_same, tol_own = TOLS[arch]
    jm, tm = det_pair(block_policy_arch=arch)
    opt = jm.policy.opt_state
    jm.policy.opt_state = opt._replace(square_avg=jax.tree.map(
        lambda a: jnp.full_like(a, 1e-4), opt.square_avg))

    def carry():
        tm.policy.load_state(ladder_policy_state_from_jax(
            jtree(jm.policy.state()), device="cpu"))

    carry()
    n_boxes = []
    for t, f in enumerate(engine_clip(4)):
        pre = jtree(jm.policy.state())
        # a copy: the engine updates the policy's tensors in place
        before = (pre["net_params"], jax.tree.map(
            np.copy, params_to_numpy(tm.policy.net_params)))
        draws = jax_draws(jm, 1)
        ref = jm(jnp.asarray(f))
        got = tm(tt(f), draws=draws)
        jmeta, tmeta = jm.policy_meta, tm.policy_meta
        assert_same(jmeta["grid"], tmeta["grid"], f"grid, frame {t + 1}")
        assert (tmeta["num_exec"], tmeta["perc_exec"]) == \
            (jmeta["num_exec"], jmeta["perc_exec"])
        match_boxes(ref, got, f"frame {t + 1}")
        assert tmeta["outputs"][0] is got
        n_boxes.append(len(got[0]))
        close_rel(jmeta["frame_state"], tmeta["frame_state"], TOL,
                  f"frame_state, frame {t + 1}")
        jc, tc = jtree(jm.temporal["canvases"]), tm.temporal["canvases"]
        assert sorted(jc) == sorted(tc)
        assert_tree(jc, tc, lambda a, b, m: close_rel(
            a, b, TOL, f"frame {t + 1} canvas{m}"))
        ref_state, got_state = jtree(jm.policy.state()), tm.policy.state()
        assert got_state["running_cost"] == pytest.approx(
            ref_state["running_cost"], rel=1e-12)
        if t not in (1, 3):            # no update off the train frames
            assert_tree(before[1], params_to_numpy(got_state["net_params"]),
                        assert_same)
            continue
        assert _update_err(before, ref_state["net_params"], params_to_numpy(
            got_state["net_params"])) < tol_own
        # the port's optim on JAX's inputs (its box lists) and state
        tm.policy.load_state(ladder_policy_state_from_jax(
            {**pre, "bn_state": ref_state["bn_state"]}, device="cpu"))
        meta = tm.policy.optim({"inputs": tt(f),
                                "outputs": jmeta["outputs"],
                                "outputs_prev": jmeta["outputs_prev"],
                                "perc_exec": jmeta["perc_exec"],
                                "_rl_cache": tt(jmeta["_rl_cache"]),
                                "grid": tt(jmeta["grid"])}, train=True)
        assert_same(jmeta["information_gain"], meta["information_gain"])
        assert_same(jmeta["output_repr"], meta["output_repr"])
        pair = (pre["net_params"], pre["net_params"])
        assert _update_err(pair, ref_state["net_params"], params_to_numpy(
            tm.policy.net_params)) < tol_same
        carry()
    assert min(n_boxes) >= 8
    assert tm.flops.frames == jm.flops.frames
    assert tm.flops.macs_per_capacity == jm.flops.macs_per_capacity
    assert tm.flops.average_macs_by_module() == pytest.approx(
        jm.flops.average_macs_by_module(), rel=1e-12)


def test_rl_objectdetection_matches_jax(monkeypatch):
    rl_clip_matches_jax(monkeypatch, "fast")


def test_first_frame_matches_detection_stepper():
    """All-exec frame 1: the ladder engine's boxes equal the detection
    stepper's (same model code, same decode)."""
    from blockcopy_tpu_torch.core.stepper import StepperConfig
    from blockcopy_tpu_torch.tasks.detection.stepper import DetectionStepper
    _, tp = csp_params()
    cfg = TC.CSPConfig(**CFG)
    frame = tt(engine_clip(1)[0])
    st = DetectionStepper(cfg, StepperConfig(block_size=128, num_classes=1,
                                             policy_arch="fast"),
                          tuple(frame.shape), 4, device="cpu")
    state = st.first_step(tp, st.init_state(tp, seed=1), frame)
    ours = TC.dets_to_bbox_results(*st.fetch_outputs(state),
                                   cfg.num_classes)[0]
    engine = TC.CSPBlockCopy(tp, cfg, tset(block_policy="all",
                                           block_size=128,
                                           block_num_classes=1),
                             device="cpu")
    ref = engine.simple_test(frame)
    assert len(ref[0]) >= 8
    for a, b in zip(ours, ref):
        a, b = a[np.argsort(-a[:, 4])], b[np.argsort(-b[:, 4])]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_gain_on_the_policy_device():
    """The detection gain paints on the host and returns fp32 tensors on
    the device it was given (the policy's), with the host values."""
    from blockcopy_tpu_torch.policy.policies import \
        build_policy_from_settings
    from blockcopy_tpu_torch.tasks.detection import information_gain as TI
    pol = build_policy_from_settings(tset(**settings()), device="cpu")
    assert isinstance(pol.information_gain, TI.DetectionInformationGain)
    assert pol.information_gain.device == pol.device == torch.device("cpu")
    boxes = np.array([[10, 20, 60, 90, 0.9], [100, 40, 130, 120, 0.7]],
                     np.float32)
    meta = {"inputs": torch.zeros((1, 128, 256, 3)), "outputs": [[boxes]],
            "outputs_prev": [[boxes[:1] + 4]]}
    for device in ("cpu", "meta"):
        gain = TI.DetectionInformationGain(1, device)
        for fn, host in ((gain.get_output_repr, TI.build_instance_mask(
                meta["outputs"], (1, 128, 256, 1))),
                         (gain.compute, TI.build_instance_mask_iou_gain(
                             meta["outputs"], meta["outputs_prev"],
                             (1, 128, 256, 1)))):
            out = fn(meta)
            assert out.device == torch.device(device)
            assert out.dtype == torch.float32 and tuple(out.shape) == \
                host.shape
            if device == "cpu":
                assert_same(host, out)
                assert out.abs().sum() > 0


def test_engine_surface(tmp_path):
    """Box lists on the host in ``policy_meta``; a count-0 frame returns
    the previous outputs; soft-NMS rescoring; policy files round trip; a
    new frame shape is refused."""
    _, tp = csp_params()
    frames = [tt(f[:, :128, :256]) for f in engine_clip(3)]    # 2 blocks
    model = TC.CSPBlockCopy(tp, TC.CSPConfig(**CFG),
                            tset(block_policy="none", block_size=128,
                                 block_num_classes=1), device="cpu")
    outs = [model(f) for f in frames]
    assert model.flops.frames == [2, 2, 0]
    assert all(isinstance(a, np.ndarray) for a in outs[0])
    assert model.policy_meta["num_exec"] == 0          # frame 3: none run
    assert outs[2] is outs[1]
    with pytest.raises(ValueError, match="frame shape changed"):
        model(frames[0][:, :, :128])

    soft = TC.CSPBlockCopy(tp, TC.CSPConfig(nms_type="soft_nms", **CFG),
                           tset(block_policy="all", block_size=128,
                                block_num_classes=1), device="cpu")
    hard = TC.CSPBlockCopy(tp, TC.CSPConfig(**CFG),
                           tset(block_policy="all", block_size=128,
                                block_num_classes=1), device="cpu")
    # the rescoring keeps every box NMS kept, with a score no higher
    rescored, kept = soft(frames[0])[0], hard(frames[0])[0]
    assert len(rescored) >= len(kept) >= 1
    assert rescored[:, 4].max() <= kept[:, 4].max()

    path = str(tmp_path / "policy.npz")
    a = TC.CSPBlockCopy(tp, TC.CSPConfig(**CFG), tset(**settings()),
                        device="cpu")
    for f in frames:
        a(f)
    a.save_policy(path)
    b = TC.CSPBlockCopy(tp, TC.CSPConfig(**CFG),
                        tset(**settings(block_seed=5)), device="cpu")
    b.load_policy(path)
    sa, sb = a.policy.state(), b.policy.state()
    assert sb["running_cost"] == np.float32(sa["running_cost"])
    assert_tree(params_to_numpy(sa["net_params"]),
                params_to_numpy(sb["net_params"]), assert_same)
