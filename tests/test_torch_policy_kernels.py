"""The plain versions of the policy net's kernels (``ops/kernels/policy.py``:
train-mode BatchNorm forward and backward, RMSprop over a tree) held
against the op-by-op code they replace, which stays here as the oracle:
the BatchNorm forward bitwise, its backward against autograd of the
op-by-op path, RMSprop bitwise, the whole net's logits, statistics and
REINFORCE gradients for both archs; and the launch plan of the CUDA
kernels, which the CPU cannot run."""

import pytest
import torch
import torch.nn.functional as F

from blockcopy_tpu_torch.ops.kernels import policy as P
from blockcopy_tpu_torch.ops.layers import nchw, nhwc
from blockcopy_tpu_torch.policy import net as N
from blockcopy_tpu_torch.policy import optim
from blockcopy_tpu_torch.policy.policies import reinforce_grads
from torch_port_util import two_torch_threads  # noqa: F401

HP = dict(eps=N.BN_EPS, momentum=N.BN_MOMENTUM)


# -- the op-by-op oracle (policy/net.py and policy/optim.py before the
# kernels) ----------------------------------------------------------------


def _conv(x, p, stride=1):
    w = p["w"]
    pad = 1 if w.shape[2] == 3 else 0
    out = F.conv2d(nchw(x.to(N.COMPUTE_DTYPE)), w.to(N.COMPUTE_DTYPE), None,
                   stride, pad)
    out = nhwc(out).float()
    return out + p["b"] if "b" in p else out


def _bn_train(x, p, s, update_stats):
    dims = (0, 1, 2)
    mean = x.mean(dims)
    var = x.var(dims, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + N.BN_EPS) * p["gamma"] + p["beta"]
    if update_stats:
        count = x.shape[0] * x.shape[1] * x.shape[2]
        unbiased = var * count / max(count - 1, 1)
        s = {"mean": (1 - N.BN_MOMENTUM) * s["mean"]
             + N.BN_MOMENTUM * mean,
             "var": (1 - N.BN_MOMENTUM) * s["var"]
             + N.BN_MOMENTUM * unbiased}
    return y, s


def _basic_block(x, p, s, stride, update_stats):
    s = dict(s)
    identity = x
    if "down_conv" in p:
        identity = _conv(x, p["down_conv"], stride)
        identity, s["down_bn"] = _bn_train(identity, p["down_bn"],
                                           s["down_bn"], update_stats)
    out = _conv(x, p["conv1"], stride)
    out, s["bn1"] = _bn_train(out, p["bn1"], s["bn1"], update_stats)
    out = torch.clamp_min(out, 0)
    out = _conv(out, p["conv2"], 1)
    out, s["bn2"] = _bn_train(out, p["bn2"], s["bn2"], update_stats)
    return torch.clamp_min(out + identity, 0), s


def oracle_apply(params, bn_state, x, update_stats=True, arch="ref"):
    s = dict(bn_state)
    if arch == "fast":
        x = N._conv_stem4(x, params["stem"]).float()
        x, s["stem_bn"] = _bn_train(x, params["stem_bn"], s["stem_bn"],
                                    update_stats)
        x = torch.clamp_min(x, 0)
        for name, stride in (("block1", 1), ("block2", 2)):
            x, s[name] = _basic_block(x, params[name], s[name], stride,
                                      update_stats)
        x = _conv(x, params["head0"], 2)
        x, s["head0_bn"] = _bn_train(x, params["head0_bn"], s["head0_bn"],
                                     update_stats)
        return _conv(torch.clamp_min(x, 0), params["head1"], 2), s
    x = _conv(x, params["conv1"], 1)
    x, s["bn1"] = _bn_train(x, params["bn1"], s["bn1"], update_stats)
    x = torch.clamp_min(x, 0)
    for i, stride in enumerate([1, 2, 2]):
        x, s[f"layer{i + 1}"] = _basic_block(
            x, params[f"layer{i + 1}"], s[f"layer{i + 1}"], stride,
            update_stats)
    for i in range(2):
        x = _conv(x, params[f"head{i}"], 2)
        x, s[f"head{i}_bn"] = _bn_train(x, params[f"head{i}_bn"],
                                        s[f"head{i}_bn"], update_stats)
        x = torch.clamp_min(x, 0)
    return _conv(x, params["head2"], 2), s


def oracle_update(grads, state, params, lr, weight_decay, momentum,
                  alpha=0.99, eps=1e-8):
    def upd(g, sq, buf, p):
        g = g + weight_decay * p
        sq = alpha * sq + (1.0 - alpha) * g * g
        step = g / (torch.sqrt(sq) + eps)
        if momentum > 0:
            buf = momentum * buf + step
            step = buf
        return p - lr * step, sq, buf

    out = [upd(*leaves) for leaves in zip(
        optim.tree_leaves(grads), optim.tree_leaves(state["square_avg"]),
        optim.tree_leaves(state["momentum_buf"]), optim.tree_leaves(params))]
    return [list(x) for x in zip(*out)]


# -- helpers ------------------------------------------------------------------


def _unit(dtype=torch.float32, c=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    return {"y": (rnd(2, 6, 10, c) * 2 + 0.5).to(dtype),
            "gamma": rnd(c) * 0.2 + 1, "beta": rnd(c) * 0.1,
            "residual": rnd(2, 6, 10, c), "mean": rnd(c) * 0.1,
            "var": rnd(c).abs() + 0.5}


def _oracle_unit(u, relu, residual, update_stats):
    out, s = _bn_train(u["y"].float(), u, {"mean": u["mean"],
                                           "var": u["var"]}, update_stats)
    if residual:
        out = out + u["residual"]
    if relu:
        out = torch.clamp_min(out, 0)
    return out, s


def _ours(u, relu, residual, update_stats, outs, dtype_c=torch.bfloat16,
          y=None, gamma=None, beta=None, res=None):
    return P.bn_train(
        u["y"] if y is None else y, u["gamma"] if gamma is None else gamma,
        u["beta"] if beta is None else beta, u["mean"], u["var"],
        update_stats=update_stats, relu=relu,
        residual=(u["residual"] if res is None else res) if residual
        else None, outs=outs, dtype_c=dtype_c, **HP)


# -- the BatchNorm forward ----------------------------------------------------


@pytest.mark.parametrize("update_stats", [True, False])
@pytest.mark.parametrize("relu,residual,outs", [
    (True, False, "c"), (True, False, "cf"), (True, True, "cc"),
    (False, False, "f"), (True, True, "c")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_forward_matches_oracle(dtype, relu, residual, outs,
                                   update_stats):
    """Every output ``outs`` names and the running statistics, bitwise the
    op-by-op BatchNorm, residual and ReLU (then the cast to the next
    conv's bf16); ``cc``'s second output is a view of the first."""
    u = _unit(dtype)
    ref, ref_s = _oracle_unit(u, relu, residual, update_stats)
    got, (mean, var) = _ours(u, relu, residual, update_stats, outs)
    assert len(got) == len(outs)
    for kind, t in zip(outs, got):
        want = ref.to(torch.bfloat16) if kind == "c" else ref
        assert t.dtype == want.dtype and torch.equal(t, want)
    if outs == "cc":
        assert got[1].data_ptr() == got[0].data_ptr()
    assert torch.equal(mean, ref_s["mean"]) and torch.equal(var, ref_s["var"])


# -- the BatchNorm backward ---------------------------------------------------


@pytest.mark.parametrize("relu,residual,outs", [
    (True, False, "c"), (True, False, "cf"), (True, True, "cc"),
    (False, False, "f"), (True, True, "cf")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_backward_matches_autograd(dtype, relu, residual, outs):
    """The autograd function's backward (``bn_grad``, ``bn_grad_apply``'s
    plain versions) against autograd through the op-by-op BatchNorm: the
    gradients of y, gamma, beta and the residual, each output taking its
    own upstream gradient, at 1e-5 norm-wise (fp32 throughout)."""
    u = _unit(dtype, seed=1)
    gen = torch.Generator().manual_seed(2)
    ups = [torch.randn(u["y"].shape, generator=gen) for _ in outs]
    leaves = {k: u[k].float().clone().requires_grad_(True)
              for k in ("y", "gamma", "beta", "residual")}
    ref, _ = _bn_train(leaves["y"], leaves, {"mean": u["mean"],
                                             "var": u["var"]}, False)
    if residual:
        ref = ref + leaves["residual"]
    if relu:
        ref = torch.clamp_min(ref, 0)
    loss = sum((ref * g).sum() for g in ups)
    names = ["y", "gamma", "beta"] + (["residual"] if residual else [])
    want = torch.autograd.grad(loss, [leaves[k] for k in names])
    mine = {k: u[k].clone().requires_grad_(True)
            for k in ("y", "gamma", "beta", "residual")}
    got, _ = _ours(u, relu, residual, False, outs, dtype_c=torch.float32,
                   y=mine["y"], gamma=mine["gamma"], beta=mine["beta"],
                   res=mine["residual"])
    loss = sum((t * g).sum() for t, g in zip(got, ups))
    have = torch.autograd.grad(loss, [mine[k] for k in names])
    for k, a, b in zip(names, want, have):
        err = float((a - b.float()).norm() / a.norm())
        assert err < (1e-5 if dtype == torch.float32 else 1e-2), (k, err)


@pytest.mark.parametrize("arch", ["ref", "fast"])
def test_net_matches_oracle(arch, monkeypatch):
    """The whole policy net through the new functions against the op-by-op
    net, fp32 convs: logits and running statistics bitwise; the REINFORCE
    loss's gradients (``reinforce_grads``) against autograd through the
    op-by-op net at 1e-5 norm-wise each leaf."""
    monkeypatch.setattr(N, "COMPUTE_DTYPE", torch.float32)
    params, state = N.init_policy_net(26, seed=3, arch=arch, device="cpu")
    gen = torch.Generator().manual_seed(4)
    state = optim.tree_map(
        lambda t: t + 0.1 * torch.rand(t.shape, generator=gen), state)
    x = torch.randn((2, 64, 128, 26), generator=gen)
    grid = (torch.rand((2, 2, 4), generator=gen) < 0.5).float()
    signed = torch.randn((2, 2, 4), generator=gen)
    lg, s = N.policy_net_apply(params, state, x, arch=arch)
    ref_lg, ref_s = oracle_apply(params, state, x, arch=arch)
    assert torch.equal(lg, ref_lg)
    for a, b in zip(optim.tree_leaves(s), optim.tree_leaves(ref_s)):
        assert torch.equal(a, b)
    grads, _ = reinforce_grads(params, state, x, grid, signed, arch)
    leaves = optim.tree_map(lambda t: t.clone().requires_grad_(True),
                            params)
    ref, _ = oracle_apply(leaves, state, x, update_stats=False, arch=arch)
    l = ref[..., 0]
    logp = grid * F.logsigmoid(l) + (1 - grid) * F.logsigmoid(-l)
    want = torch.autograd.grad(torch.mean(-logp * signed),
                               optim.tree_leaves(leaves))
    for a, b in zip(want, optim.tree_leaves(grads)):
        assert b.is_contiguous()
        err = float((a - b).norm() / a.norm().clamp_min(1e-30))
        assert err < 1e-5, err


def test_bf16_net_close_to_oracle():
    """The served precision (bf16 convs, fp32 BatchNorm): the ref net's
    logits as the op-by-op net's, which rounds at the same points."""
    params, state = N.init_policy_net(26, seed=5, device="cpu")
    x = torch.randn((1, 64, 128, 26), generator=torch.Generator()
                    .manual_seed(6))
    lg, _ = N.policy_net_apply(params, state, x)
    ref, _ = oracle_apply(params, state, x)
    assert float((lg - ref).abs().max()) <= 3e-2 * float(ref.abs().max())


# -- RMSprop ------------------------------------------------------------------


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_rmsprop_multi_matches_update(momentum):
    """``rmsprop_multi``'s plain version, and ``update`` / ``update_``
    through it, bitwise the op-by-op update over two steps."""
    gen = torch.Generator().manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    params = {"a": rnd(3, 4), "b": [rnd(5), rnd(2, 2, 3)]}
    state = optim.init(params)
    own_p = optim.tree_map(torch.clone, params)
    own_s = optim.init(own_p)
    hp = dict(lr=1e-2, weight_decay=1e-3, momentum=momentum)
    for _ in range(2):
        grads = optim.tree_map(lambda p: rnd(*p.shape), params)
        want = oracle_update(grads, state, params, **hp)
        got = P.rmsprop_multi_plain(
            *(optim.tree_leaves(t) for t in (grads, params,
                                              state["square_avg"],
                                              state["momentum_buf"])),
            alpha=0.99, eps=1e-8, **hp)
        params, state = optim.update(grads, state, params, **hp)
        optim.update_(grads, own_s, own_p, **hp)
        kept = [optim.tree_leaves(t) for t in (
            params, state["square_avg"], state["momentum_buf"])]
        inplace = [optim.tree_leaves(t) for t in (
            own_p, own_s["square_avg"], own_s["momentum_buf"])]
        for w, g, k, i in zip(want, got, kept, inplace):
            for a, b, c, d in zip(w, g, k, i):
                assert torch.equal(a, b) and torch.equal(a, c) \
                    and torch.equal(a, d)


# -- the CUDA kernels' launch plan ----------------------------------------------


@pytest.mark.parametrize("m,c,itemsize", [
    (131072, 32, 2), (32768, 64, 2), (8192, 128, 2), (2048, 128, 2),
    (512, 128, 2), (128, 128, 2), (8192, 128, 4), (2048, 256, 4),
    (8192, 256, 2), (1, 8, 2)])
def test_policy_bn_plan_covers_rows(m, c, itemsize):
    """Every row in exactly one CTA (the last may hold fewer), at most
    ``REDUCE_CTAS_PER_SM`` CTAs an SM, whole 16-byte vectors, the channel
    groups dividing the CTA's threads."""
    sms = 132
    plan = P.policy_bn_plan(m, c, itemsize, sms)
    assert plan["vec"] * itemsize == 16
    assert plan["groups"] * plan["lanes"] <= P.THREADS
    assert P.THREADS % plan["groups"] == 0
    assert 1 <= plan["ctas"] <= P.REDUCE_CTAS_PER_SM * sms
    assert (plan["ctas"] - 1) * plan["rows"] < m <= plan["ctas"] * plan["rows"]
    assert 1 <= plan["apply_ctas"] <= P.APPLY_CTAS_PER_SM * sms


@pytest.mark.parametrize("m,c,itemsize", [
    (100, 12, 2), (100, 48, 2), (100, 512, 2), (100, 6, 4), (0, 32, 2),
    (2 ** 27, 32, 2)])
def test_policy_bn_plan_refuses(m, c, itemsize):
    with pytest.raises(ValueError):
        P.policy_bn_plan(m, c, itemsize, 132)


def test_outs_spec_refused():
    u = _unit()
    with pytest.raises(ValueError, match="outs"):
        _ours(u, True, False, False, "fc")
