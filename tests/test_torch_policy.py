"""Port of policy/net.py, policy/optim.py and policy/information_gain.py held
against the JAX package: logits and new BN state of both archs, the
REINFORCE-loss gradients, one RMSprop step, and the information gain.
fp32 compute at 1e-4; the default bf16 compute at 3e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import blockcopy_tpu.policy.net as JN
import blockcopy_tpu_torch.policy.net as TN
from blockcopy_tpu.policy import optim as JO
from blockcopy_tpu.policy.information_gain import semseg_information_gain \
    as jig
from blockcopy_tpu_torch.policy import optim as TO
from blockcopy_tpu_torch.policy.information_gain import \
    semseg_information_gain as tig
from blockcopy_tpu_torch.utils.convert import params_from_jax, \
    params_to_numpy
from torch_port_util import assert_close, assert_tree, jtree, npf, tt
from torch_port_util import two_torch_threads  # noqa: F401

CIN = JN.policy_in_channels(19)


def _setup(arch, seed=0):
    rs = np.random.RandomState(seed)
    params, bn_state = JN.init_policy_net(jax.random.PRNGKey(seed), CIN,
                                          arch=arch, head_bias=0.3)
    if arch == "fast":   # the zero-init head would hide the trunk
        params["head1"]["w"] = jnp.asarray(
            0.05 * rs.randn(*params["head1"]["w"].shape).astype(np.float32))
    bn_state = jax.tree.map(
        lambda a: a + jnp.asarray(0.1 * rs.rand(*a.shape), a.dtype),
        bn_state)
    x = rs.randn(2, 64, 128, CIN).astype(np.float32)
    return params, bn_state, x


def _close(t):
    return lambda a, b, m: assert_close(a, b, t, msg=m)


@pytest.mark.parametrize("arch", ["fast", "ref"])
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_forward_and_bn_state(arch, compute, monkeypatch):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    monkeypatch.setattr(JN, "COMPUTE_DTYPE", jdt)
    monkeypatch.setattr(TN, "COMPUTE_DTYPE", tdt)
    t = 1e-4 if compute == "fp32" else 3e-2
    params, bn_state, x = _setup(arch)
    tp = params_from_jax(jtree(params), device="cpu")
    ts = params_from_jax(jtree(bn_state), device="cpu")
    # JAX jitted (eager JAX compiles every op); traced after the patch
    japply = jax.jit(JN.policy_net_apply,
                     static_argnames=("update_stats", "arch"))
    for update in (True, False):
        ref, ref_s = japply(params, bn_state, jnp.asarray(x),
                            update_stats=update, arch=arch)
        got, got_s = TN.policy_net_apply(tp, ts, tt(x), update_stats=update,
                                         arch=arch)
        assert got.shape == (2, 2, 4, 1) and got.dtype == torch.float32
        # bf16: eight convs under train-mode BN round differently in the two
        # frameworks, so logits are held relative to their largest magnitude
        # (the JAX suite's normalised bf16 check,
        # test_policy_net_reference_parity.py:216)
        scale = 1.0 if compute == "fp32" else float(np.abs(ref).max())
        assert_close(ref, got, t, t * scale)
        assert_tree(jtree(ref_s), params_to_numpy(got_s), _close(t))


@pytest.mark.parametrize("arch", ["fast", "ref"])
def test_reinforce_grads_and_rmsprop(arch, monkeypatch):
    monkeypatch.setattr(JN, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TN, "COMPUTE_DTYPE", torch.float32)
    params, bn_state, x = _setup(arch, seed=1)
    rs = np.random.RandomState(2)
    grid = (rs.rand(2, 2, 4) < 0.5).astype(np.float32)
    signed = rs.randn(2, 2, 4).astype(np.float32)

    def jloss(p):
        lg, _ = JN.policy_net_apply(p, bn_state, jnp.asarray(x),
                                    update_stats=False, arch=arch)
        l = lg[..., 0]
        logp = grid * jax.nn.log_sigmoid(l) + (1 - grid) * \
            jax.nn.log_sigmoid(-l)
        return jnp.mean(-logp * signed)

    jgrads = jax.jit(jax.grad(jloss))(params)
    tp = params_from_jax(jtree(params), device="cpu")
    leaves = TO.tree_map(lambda a: a.clone().requires_grad_(True), tp)
    ts = params_from_jax(jtree(bn_state), device="cpu")
    lg, _ = TN.policy_net_apply(leaves, ts, tt(x), update_stats=False,
                                arch=arch)
    l = lg[..., 0]
    g = torch.from_numpy(grid)
    logp = g * F.logsigmoid(l) + (1 - g) * F.logsigmoid(-l)
    loss = torch.mean(-logp * torch.from_numpy(signed))
    grads = iter(torch.autograd.grad(loss, TO.tree_leaves(leaves)))
    tgrads = TO.tree_map(lambda _: next(grads), leaves)
    # train-mode BN backward subtracts batch means of the incoming grads,
    # which cancels digits, and a ReLU input within rounding of 0 passes
    # the gradient in one package and blocks it in the other: single
    # elements near 0 are ill-conditioned, so each leaf is held by its
    # norm-wise relative error (measured up to 3e-4 in fp32 on this input)
    def grads_close(a, b, m):
        err = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
        assert err < 1e-3, (m, err)

    assert_tree(jtree(jgrads), params_to_numpy(tgrads), grads_close)

    # one RMSprop step, then a second from the carried state, on JAX's grads
    jopt, topt = JO.init(params), TO.init(tp)
    jp, tq = params, tp
    jupdate = jax.jit(lambda g, o, q: JO.update(g, o, q, lr=1e-2,
                                                momentum=0.9))
    for _ in range(2):
        jp, jopt = jupdate(jgrads, jopt, jp)
        tg = params_from_jax(jtree(jgrads), device="cpu")
        tq, topt = TO.update(tg, topt, tq, lr=1e-2, momentum=0.9)
    assert_tree(jtree(jp), params_to_numpy(tq), _close(1e-6))
    assert_tree(jtree(jopt.square_avg), params_to_numpy(topt["square_avg"]),
                _close(1e-6))
    assert_tree(jtree(jopt.momentum_buf),
                params_to_numpy(topt["momentum_buf"]), _close(1e-5))


@pytest.mark.parametrize("arch", ["fast", "ref"])
def test_reinforce_update_matches_jax(arch, monkeypatch):
    """``reinforce_update`` as the steppers and ``PolicyTrainRL`` run it
    (the BatchNorm kernels' plain versions and their autograd backward,
    RMSprop through ``rmsprop_multi`` into the given trees) against JAX's
    gradient and RMSprop step from square averages of 1e-4: each leaf's
    change and square averages at 1e-3 norm-wise (the gradients' own error,
    measured up to 3e-4)."""
    from blockcopy_tpu_torch.policy.policies import reinforce_update
    monkeypatch.setattr(JN, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TN, "COMPUTE_DTYPE", torch.float32)
    params, bn_state, x = _setup(arch, seed=3)
    rs = np.random.RandomState(4)
    grid = (rs.rand(2, 2, 4) < 0.5).astype(np.float32)
    signed = rs.randn(2, 2, 4).astype(np.float32)

    def jloss(p):
        lg, _ = JN.policy_net_apply(p, bn_state, jnp.asarray(x),
                                    update_stats=False, arch=arch)
        l = lg[..., 0]
        logp = grid * jax.nn.log_sigmoid(l) + (1 - grid) * \
            jax.nn.log_sigmoid(-l)
        return jnp.mean(-logp * signed)

    jopt = JO.init(params)
    jopt = jopt._replace(square_avg=jax.tree.map(
        lambda a: jnp.full_like(a, 1e-4), jopt.square_avg))
    hp = dict(lr=1e-2, weight_decay=1e-3, momentum=0.0)
    jp, jopt = jax.jit(lambda p, o: JO.update(jax.grad(jloss)(p), o, p,
                                              **hp))(params, jopt)
    tp = params_from_jax(jtree(params), device="cpu")
    topt = {"square_avg": TO.tree_map(lambda t: torch.full_like(t, 1e-4),
                                      tp),
            "momentum_buf": TO.tree_map(torch.zeros_like, tp)}
    got_p, got_opt, _ = reinforce_update(
        tp, params_from_jax(jtree(bn_state), device="cpu"), topt, tt(x),
        torch.from_numpy(grid), torch.from_numpy(signed), arch,
        hp["lr"], hp["weight_decay"], hp["momentum"])
    assert got_p is tp and got_opt is topt

    old = jtree(params)
    assert_tree(jtree(jp), params_to_numpy(got_p),
                lambda a, b, m: _close_rel(a - old_leaf(old, m),
                                           b - old_leaf(old, m), m))
    assert_tree(jtree(jopt.square_avg),
                params_to_numpy(got_opt["square_avg"]), _close_rel)


def old_leaf(tree, path):
    """The leaf of ``tree`` at ``assert_tree``'s ``path`` (".a.b[0]")."""
    for part in path.replace("[", ".[").split(".")[1:]:
        tree = tree[int(part[1:-1])] if part.startswith("[") else tree[part]
    return tree


def _close_rel(a, b, m, tol=1e-3):
    err = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
    assert err < tol, (m, err)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_information_gain(dtype):
    rs = np.random.RandomState(3)
    cur = (3 * rs.randn(2, 16, 32, 19)).astype(dtype)
    prev = (3 * rs.randn(2, 16, 32, 19)).astype(dtype)
    ref = jig(jnp.asarray(cur), jnp.asarray(prev))
    got = tig(tt(cur), tt(prev))
    assert got.shape == (2, 4, 8, 1) and got.dtype == torch.float32
    assert_close(ref, got, 1e-4)


def test_assemble_policy_input():
    rs = np.random.RandomState(4)
    frame = rs.randn(1, 256, 512, 3).astype(np.float32)
    fs = rs.randn(1, 64, 128, 3).astype(np.float32)
    out = rs.randn(1, 64, 128, 19).astype(np.float32)
    grid = (rs.rand(1, 2, 4) < 0.5).astype(np.float32)
    jassemble = jax.jit(JN.assemble_policy_input, static_argnums=(4, 5))
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        ref = jassemble(*map(jnp.asarray, (frame, fs, out, grid)), 128, jd)
        got = TN.assemble_policy_input(*map(tt, (frame, fs, out, grid)), 128,
                                       td)
        assert got.dtype == td
        np.testing.assert_array_equal(npf(got), npf(ref))
