"""The serving programs that the JAX package compiles, as the port's CUDA
graphs (``core/graphs.py`` ``CallGraphs``), on the CPU, where their bodies
run eagerly and keep their results in buffers across calls as on the card.

* The ladder engine's policy forward and REINFORCE update
  (``PolicyTrainRL._forward_graph`` / ``_optim_graph``, JAX's
  ``_forward_jit`` / ``_optim_jit``): a 4-frame RN18 256x512 clip at
  capacity 4 or 8 of 8 (quantum 0.5), the fast policy with fp32 convs,
  REINFORCE on frames 2 and 4, the RMSprop state mid-training (a positive
  ``square_avg``), draws injected from JAX keys.  The engine with graphs
  must equal the op-by-op engine bitwise and keep its policy's storage
  (what keeps a captured graph from going stale); each frame's forward
  and update are held against JAX's jitted ones on the same inputs, every
  tensor within 1e-4 of its largest magnitude and each update within 1e-4
  norm-wise (measured 2.1e-6 and 1.0e-5); no result the engine keeps
  shares storage with a graph's buffer, and each keeps its value through
  the frames after it.
* The in-place RMSprop, bitwise ``update``; ``load_state`` keeps storage.
* The CSP decode as a graph, bitwise ``csp_decode``; under the fixpoint
  NMS no graph is made.
* The semseg CLI's dense forward and upsample against JAX's jitted ones.
* Two gloo ranks on the CPU through the captured parallel steps (the gloo
  split: gradients, the eager average, the update), bitwise the eager
  parallel step, the policy bitwise across the ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockcopy_tpu.policy.net as JN
import blockcopy_tpu_torch.models.csp as TC
import blockcopy_tpu_torch.ops.nms as TNMS
import blockcopy_tpu_torch.policy.net as TN
from blockcopy_tpu.core.blocked import ExecCtx as JExecCtx
from blockcopy_tpu.models import swiftnet as JS
from blockcopy_tpu.ops.layers import resize_bilinear as jresize
from blockcopy_tpu.policy.information_gain import \
    semseg_information_gain as jgain
from blockcopy_tpu_torch.core.argparser import default_settings as tset
from blockcopy_tpu_torch.core.graphs import CallGraphs
from blockcopy_tpu_torch.models import swiftnet as TS
from blockcopy_tpu_torch.parallel import clip_parallel
from blockcopy_tpu_torch.policy import optim as rmsprop
from blockcopy_tpu_torch.policy.optim import tree_leaves
from blockcopy_tpu_torch.policy.policies import build_policy_from_settings
from blockcopy_tpu_torch.tasks.semseg.eval import DenseGraphs
from blockcopy_tpu_torch.tools.measure import parallel_graphs_rank
from blockcopy_tpu_torch.utils.convert import (ladder_policy_state_from_jax,
                                               params_from_jax,
                                               params_to_numpy)
from torch_port_util import (ENGINE_H, ENGINE_W, assert_same, assert_tree,
                             close_rel, engine_clip, engine_pair, jtree, npf,
                             tt)
from torch_port_util import two_torch_threads  # noqa: F401

TOL = 1e-4
GEOM = (1, ENGINE_H // 128, ENGINE_W // 128)
TOTAL = int(np.prod(GEOM))


@jax.jit
def _key_draws(key):
    """The uniforms JAX's ``_forward_impl`` draws from ``key``
    (``policies.py:266-274``), as the port's ``draws``."""
    k1, k2 = jax.random.split(key)
    return jax.random.uniform(k1, GEOM), jax.random.uniform(k2, (TOTAL,))


def _np(tree):
    """A port tree as JAX-layout numpy copies (``params_to_numpy`` shares
    a CPU tensor's memory, which an in-place update overwrites)."""
    return jax.tree.map(np.copy, params_to_numpy(tree))


def _policy_np(pol):
    return {"params": _np(pol.net_params), "bn": _np(pol.bn_state),
            "opt": [_np(pol.opt_state["square_avg"]),
                    _np(pol.opt_state["momentum_buf"])],
            "running_cost": pol.running_cost}


def _ptrs(pol):
    return [t.data_ptr() for t in tree_leaves(pol._held()[:3])]


def _kept(meta):
    """What the engine keeps of a policy frame's graphs' results."""
    return [meta["grid"], meta["_rl_cache"], *meta["_rl_probs"]] + (
        [meta["information_gain"]] if "information_gain" in meta else [])


def _buffers(calls):
    """The storages of every output buffer of ``calls``' graphs."""
    return {t.untyped_storage().data_ptr() for g in calls.graphs.values()
            for t in tree_leaves(g._out) if isinstance(t, torch.Tensor)}


def _update_err(before, ref, got):
    """Norm-wise relative error of the update ``got - before`` against
    ``ref - before``, all leaves as one vector (a leaf near 1 that moves by
    1e-5, such as a BN scale, keeps 1e-3 of its update in fp32)."""
    flat = [np.concatenate([x.ravel() for x in jax.tree.leaves(t)])
            for t in (before, ref, got)]
    return np.linalg.norm(flat[2] - flat[1]) / np.linalg.norm(
        flat[1] - flat[0])


@pytest.fixture(scope="module")
def ladder():
    """The clip through the engine with graphs and the op-by-op engine (the
    same JAX policy state loaded into both), and on the graphed engine's
    inputs JAX's jitted forward and update.  Per frame: both engines'
    outputs, kept results and policy states (numpy copies), JAX's."""
    mp = pytest.MonkeyPatch()
    # fp32 policy convs in both packages: a bf16 probability rounded
    # differently could land on the other side of a shared draw
    mp.setattr(JN, "COMPUTE_DTYPE", jnp.float32)
    mp.setattr(TN, "COMPUTE_DTYPE", torch.float32)
    # two threads, as ``two_torch_threads`` gives each test: a module
    # fixture is set up before it
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        kw = dict(block_train_interval=2, block_policy_arch="fast")
        jm, graphed = engine_pair("rl_semseg", **kw)
        _, eager = engine_pair("rl_semseg", **kw)
        eager.graphs = False
        jpol = jm.policy
        jpol.opt_state = jpol.opt_state._replace(square_avg=jax.tree.map(
            lambda a: jnp.full_like(a, 1e-4), jpol.opt_state.square_avg))
        ptrs = _ptrs(graphed.policy)
        for m in (graphed, eager):
            m.policy.load_state(ladder_policy_state_from_jax(
                jtree(jpol.state()), device="cpu"))
        out = {"load_kept_storage": _ptrs(graphed.policy) == ptrs,
               "loaded": _policy_np(graphed.policy), "frames": []}
        kept = []
        for t, f in enumerate(engine_clip(4)):
            key = jax.random.PRNGKey(100 + t)
            draws = tuple(tt(d) for d in _key_draws(key))
            pol, meta = graphed.policy, graphed.policy_meta
            pre = _policy_np(pol)
            inputs = t and (f, npf(meta["frame_state"]),
                            npf(meta["output_repr"]),
                            npf(meta["grid"]).astype(np.float32))
            got = graphed(tt(f), draws).clone()
            ref = eager(tt(f), draws)
            metas = graphed.policy_meta, eager.policy_meta
            rec = {"out": (got, ref),
                   "kept": [[k.clone() for k in _kept(m)] if t else []
                            for m in metas],
                   "policy": (_policy_np(pol), _policy_np(eager.policy)),
                   "ptrs_kept": _ptrs(pol) == ptrs}
            if t:
                now = _kept(metas[0])
                buffers = _buffers(graphed._calls)
                rec["aliased"] = [k.untyped_storage().data_ptr() in buffers
                                  for k in now]
                kept.append((now, [k.clone() for k in now]))
                grid, x, bn, ep, sp = jpol._forward_jit(
                    pre["params"], pre["bn"], key, *inputs)
                rec["jax_forward"] = jtree((grid, x, bn, ep, sp))
            if t in (1, 3):
                m = metas[0]
                ig = jax.jit(jgain)(npf(m["outputs"]), npf(m["outputs_prev"]))
                rc = -(pol.running_cost - pol.block_target)
                rcw = rc * abs(rc) * pol.complexity_weight_gamma
                opt = jpol.opt_state._replace(square_avg=pre["opt"][0],
                                              momentum_buf=pre["opt"][1])
                # the port's BN statistics, policy input and grid
                grid, x = (npf(k) for k in rec["kept"][0][:2])
                params, new_opt, _ = jpol._optim_jit(
                    pre["params"], rec["policy"][0]["bn"], opt, x,
                    grid.astype(bool), ig, jnp.float32(rcw))
                rec["jax_optim"] = {"ig": jtree(ig), "params": jtree(params),
                                    "opt": [jtree(new_opt.square_avg),
                                            jtree(new_opt.momentum_buf)],
                                    "before": pre["params"]}
            out["frames"].append(rec)
        out["kept_later"] = [all(torch.equal(a, b) for a, b in zip(*k))
                             for k in kept]
        out["graphs"] = sorted(key for key, _ in graphed._calls.graphs)
        return out
    finally:
        torch.set_num_threads(threads)
        mp.undo()


def test_ladder_graphs_equal_eager(ladder):
    """(a) the engine with graphs, bitwise the op-by-op engine on every
    frame: outputs, the kept results (grid, policy input, probabilities,
    gain) and the policy's state; REINFORCE moved the policy on frames 2
    and 4 only; one forward graph (with draws) and one update graph."""
    moved = []
    for t, rec in enumerate(ladder["frames"]):
        assert_same(rec["out"][1], rec["out"][0], f"outputs, frame {t + 1}")
        for a, b in zip(*rec["kept"]):
            assert_same(b, a, f"kept, frame {t + 1}")
        ref, got = rec["policy"][1], rec["policy"][0]
        assert got["running_cost"] == ref["running_cost"]
        assert_tree(ref, got, lambda a, b, m: assert_same(
            a, b, f"policy, frame {t + 1}{m}"))
        before = ladder["frames"][t - 1]["policy"][0] if t \
            else ladder["loaded"]
        moved.append(not np.array_equal(before["params"]["head1"]["w"],
                                        got["params"]["head1"]["w"]))
    assert moved == [False, True, False, True]
    # grid, policy input, two probabilities, and the gain of frame 2 on
    assert [len(rec["kept"][0]) for rec in ladder["frames"]] == [0, 5, 5, 5]
    assert ladder["graphs"] == [("policy_forward", False),
                                ("policy_optim",)]


def test_ladder_graphs_keep_storage(ladder):
    """(b) ``load_state`` and every frame keep the policy's tensors (the
    graphs hold their addresses: rebinding them would leave a stale
    graph)."""
    assert ladder["load_kept_storage"]
    assert all(rec["ptrs_kept"] for rec in ladder["frames"])


def test_ladder_results_unaliased(ladder):
    """(c) no kept result shares storage with a graph's buffer, and each
    keeps its value through the later frames' calls."""
    assert not any(any(rec.get("aliased", [])) for rec in ladder["frames"])
    assert ladder["kept_later"] == [True, True, True]


def test_ladder_graphs_match_jax(ladder):
    """(d) each frame's forward graph against JAX's ``_forward_jit`` on the
    same inputs and draws: grid equal; policy input, BN statistics and
    probabilities within 1e-4; each update graph against JAX's
    ``_optim_jit`` with JAX's KL gain: the gain, the parameters and the
    RMSprop state within 1e-4, the update within 1e-4 norm-wise."""
    for t, rec in enumerate(ladder["frames"][1:], 2):
        grid, x, bn, ep, sp = rec["jax_forward"]
        kept = rec["kept"][0]
        assert_same(grid, kept[0], f"grid, frame {t}")
        close_rel(x, kept[1], TOL, f"policy input, frame {t}")
        close_rel(np.stack([ep, sp]), np.stack([npf(kept[2]),
                                                npf(kept[3])]), TOL)
        got = rec["policy"][0]
        assert_tree(bn, got["bn"], lambda a, b, m: close_rel(
            a, b, TOL, f"bn_state, frame {t}{m}"))
        if "jax_optim" not in rec:
            continue
        ref = rec["jax_optim"]
        close_rel(ref["ig"], kept[4], TOL, f"gain, frame {t}")
        assert_tree(ref["params"], got["params"], lambda a, b, m: close_rel(
            a, b, TOL, f"params, frame {t}{m}"))
        assert_tree(ref["opt"], got["opt"], lambda a, b, m: close_rel(
            a, b, TOL, f"RMSprop state, frame {t}{m}"))
        assert _update_err(ref["before"], ref["params"],
                           got["params"]) < TOL


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_inplace_rmsprop_equals_update(momentum):
    """``update_`` writes ``update``'s values bitwise, into the same
    tensors, over two steps."""
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    params = {"a": rnd(3, 4), "b": [rnd(5), rnd(2, 2, 3)]}
    grads = [rmsprop.tree_map(lambda p: rnd(*p.shape), params)
             for _ in range(2)]
    kw = dict(lr=1e-2, weight_decay=1e-3, momentum=momentum)
    ref_p, ref_s = params, rmsprop.init(params)
    got_p = rmsprop.tree_map(torch.clone, params)
    got_s = rmsprop.init(got_p)
    ptrs = [t.data_ptr() for t in tree_leaves((got_p, got_s))]
    for g in grads:
        ref_p, ref_s = rmsprop.update(g, ref_s, ref_p, **kw)
        rmsprop.update_(g, got_s, got_p, **kw)
        for a, b in zip(tree_leaves((ref_p, ref_s)),
                        tree_leaves((got_p, got_s))):
            assert torch.equal(a, b)
    assert ptrs == [t.data_ptr() for t in tree_leaves((got_p, got_s))]


def test_load_state_keeps_storage():
    """``load_state`` copies into the policy's tensors (its graphs hold
    them) and refuses another shape."""
    settings = tset(block_policy="rl_semseg", block_policy_arch="fast")
    pol = build_policy_from_settings(settings, "cpu")
    other = build_policy_from_settings({**settings, "block_seed": 3}, "cpu")
    ptrs = _ptrs(pol)
    state = {**other.state(), "running_cost": 0.25}
    pol.load_state(state)
    assert _ptrs(pol) == ptrs and pol.running_cost == 0.25
    for a, b in zip(tree_leaves(pol._held()[:3]),
                    tree_leaves(other._held()[:3])):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    bad = rmsprop.tree_map(lambda t: t, state)
    bad["net_params"]["head1"]["w"] = torch.zeros(1)
    with pytest.raises(ValueError, match="shape"):
        pol.load_state(bad)


_CSP = []


def _det_engine(graphs):
    """A CSP ladder engine (stages (1, 1, 1, 1), the ``csp_cls`` bias 0,
    ``score_thr`` 0.6: live boxes) executing every block."""
    cfg = TC.CSPConfig(stage_blocks=(1, 1, 1, 1), score_thr=0.6)
    if not _CSP:
        _CSP.append(TC.init_csp(cfg, seed=0, device="cpu"))
        _CSP[0]["head"]["csp_cls"]["b"].zero_()
    model = TC.CSPBlockCopy(_CSP[0], cfg, tset(
        block_policy="all", block_num_classes=1, block_size=128),
        device="cpu")
    model.graphs = graphs
    return model


def test_csp_decode_graph_equals_csp_decode(monkeypatch):
    """The ladder's decode as a graph over 3 frames: boxes bitwise the
    op-by-op engine's, one graph whose buffers keep their storage, keyed by
    the image shape, the rescale factor and the lowerings; under the
    fixpoint NMS the decode runs op by op (no graph), with the same boxes.
    The graph's body on two maps, bitwise ``csp_decode``."""
    models = {"graphs": _det_engine(True), "eager": _det_engine(False)}
    frames = [tt(f) for f in engine_clip(3)]
    boxes = {k: [m(f) for f in frames] for k, m in models.items()}
    for a, b in zip(boxes["graphs"], boxes["eager"]):
        assert len(a) == len(b) == 1
        assert_same(b[0], a[0])
    assert 0 < sum(len(b[0]) for b in boxes["graphs"])
    calls = models["graphs"]._calls
    (key, _), = [k for k in calls.graphs if k[0][0] == "csp_decode"]
    assert key == ("csp_decode", (ENGINE_H, ENGINE_W), 1.0, "loop",
                   TC.TOPK_IMPL, TC.DECODE_LEAN_POINTS)
    monkeypatch.setattr(TNMS, "NMS_IMPL", "fixpoint")
    fix = _det_engine(True)
    for f, ref in zip(frames, boxes["eager"]):
        assert_same(ref[0], fix(f)[0])
    assert not any(k[0][0] == "csp_decode" for k in fix._calls.graphs)

    gen = torch.Generator().manual_seed(1)
    graphs = CallGraphs("cpu")
    cfg = models["graphs"].cfg
    body = TC._decode_graph((ENGINE_H, ENGINE_W), cfg, 1.0, "loop")
    ptrs = None
    for _ in range(2):
        maps = (torch.randn(1, 64, 128, 1, generator=gen) + 1.0,
                torch.randn(1, 64, 128, 1, generator=gen),
                torch.randn(1, 64, 128, 2, generator=gen))
        got = graphs(("csp_decode",), body, (), *maps)
        ref = TC.csp_decode(*maps, (ENGINE_H, ENGINE_W), cfg, 1.0, "loop")
        for a, b in zip(ref, got):
            assert torch.equal(a, b)
        assert ptrs in (None, [t.data_ptr() for t in got])
        ptrs = [t.data_ptr() for t in got]


@pytest.fixture(scope="module")
def dense():
    """RN18 256x512 parameters drawn by the port, as JAX's and the port's,
    and a frame."""
    cfg = TS.SwiftNetConfig(backbone="resnet18")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(
        TS.init_swiftnet(cfg, seed=0, device="cpu")))
    frame = engine_clip(1)[0]
    return cfg, jp, params_from_jax(jtree(jp), device="cpu"), frame


def test_dense_graphs_match_jax(dense):
    """The semseg CLI's dense forward (``--block-policy static``) and its
    upsample against JAX's jitted ones (JAX ``tasks/semseg/eval.py:224,
    232``): logits within 1e-4; the upsample of the same logits equal
    wherever JAX's top two classes are 1e-3 apart; a second call
    overwrites the buffers the first returned."""
    cfg, jp, tp, frame = dense
    jcfg = JS.SwiftNetConfig(backbone="resnet18")
    jdense = jax.jit(lambda p, x: JS.swiftnet_apply(p, x, JExecCtx.dense(),
                                                    jcfg))
    jup = jax.jit(lambda o, hw: jnp.argmax(jresize(o.astype(jnp.float32),
                                                   hw), axis=-1),
                  static_argnums=(1,))
    graphs = DenseGraphs(cfg, "cpu")
    hw = frame.shape[1:3]
    logits = graphs.dense_fwd(tp, tt(frame))
    close_rel(jdense(jp, jnp.asarray(frame)), logits, TOL, "logits")
    preds = graphs.upsample(logits, hw)
    kept = preds.clone()
    ref = np.asarray(jup(jnp.asarray(npf(logits)), hw))
    top2 = np.sort(np.asarray(jresize(jnp.asarray(npf(logits)), hw)),
                   -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(npf(preds)[clear], ref[clear])
    again = graphs.upsample(graphs.dense_fwd(tp, tt(-frame)), hw)
    assert again.data_ptr() == preds.data_ptr()
    assert not torch.equal(again, kept)
    assert sorted(k for k, _ in graphs.calls.graphs) == [
        ("dense_fwd",), ("upsample", hw)]


def test_parallel_graphs_two_gloo_ranks():
    """Two gloo ranks on the CPU, RN18 256x512, capacity 4, REINFORCE
    every 2nd frame, 5 frames in lockstep: the captured parallel steps (the
    gloo split) bitwise the eager parallel step on each rank (policy after
    each update, outputs after the clip), the policy bitwise across the
    ranks and moved by each update."""
    spec = clip_parallel.make_group(2, ["cpu", "cpu"])
    ranks = clip_parallel.spawn(spec, parallel_graphs_rank, "resnet18",
                                (1, 256, 512, 3), 4, "float32", 128, 2, 5,
                                0, timeout=300)
    for r in ranks:
        assert r["outputs_equal"] and r["finite"]
        assert len(r["digests"]) == 2
        assert all(e == c for e, c in r["digests"])
    assert ranks[0]["digests"] == ranks[1]["digests"]
    assert len({c for _, c in ranks[0]["digests"]}) == 2
