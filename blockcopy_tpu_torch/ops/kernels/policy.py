"""The policy net's fused kernels (``csrc/policy.cu``) with their plain
versions: train-mode BatchNorm forward (``bn_stats``, ``bn_apply``) and
backward (``bn_grad``, ``bn_grad_apply``, joined with the forward in
``bn_train``'s autograd function), and RMSprop over a parameter tree in one
launch (``rmsprop_multi``).

They replace no TPU kernel: XLA fused these ops on the TPU, where the
port ran them op by op (some 1,300 launches a train frame).  All are bound
by bytes (see the source's note).

Activations are NHWC: a BatchNorm reads a convolution's output ``y`` of
shape ``(..., C)`` in its own dtype (bf16, or fp32) as ``(M, C)`` rows, and
writes the next convolution's input in ``dtype_c`` and, where asked, the
fp32 values a residual reads later.  Statistics, parameters and gradients
are fp32.  ``policy_bn_plan`` chooses the CTAs of a reduction from ``C``
and ``M``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Every launch adds one to its entry of ``ops/kernels.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.ops.kernels import build

THREADS = 256           # csrc/policy.cu kThreads
ROWS_PER_THREAD = 8     # a reduction's rows a thread, before the cap
REDUCE_CTAS_PER_SM = 2  # a reduction's CTAs a card SM, at most
APPLY_CTAS_PER_SM = 2   # an apply's CTAs a card SM, at most
RMS_LEAVES = 40         # csrc/policy.cu kLeaves: leaves a launch
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}

# outputs of a BatchNorm, by its consumers: "c" the next convolution's
# input (dtype_c); "cc" that input for two convolutions (the second a view
# of the first, so that each one's gradient arrives apart and they are
# summed in fp32); "cf" it and the fp32 values for a residual; "f" fp32 only
OUTS = ("c", "cc", "cf", "f")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _dims(y: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(y.dim() - 1))


def bn_stats_plain(y, run_mean=None, run_var=None, *, eps: float,
                   momentum: float):
    """Mean and ``1 / sqrt(var + eps)`` (biased variance) over all but the
    last dim, and, with ``run_mean`` / ``run_var``, the running statistics
    (unbiased variance, ``momentum``); ``(mean, rstd, new_mean,
    new_var)``, the last two None without them."""
    x = y.float()
    dims = _dims(x)
    mean = x.mean(dims)
    var = x.var(dims, unbiased=False)
    rstd = torch.rsqrt(var + eps)
    if run_mean is None:
        return mean, rstd, None, None
    count = x.numel() // x.shape[-1]
    unbiased = var * count / max(count - 1, 1)
    return (mean, rstd, (1 - momentum) * run_mean + momentum * mean,
            (1 - momentum) * run_var + momentum * unbiased)


def bn_apply_plain(y, mean, rstd, gamma, beta, residual=None,
                   relu: bool = False, dtype_c=torch.bfloat16,
                   want_c: bool = True, want_f: bool = False):
    """``((y - mean) * rstd) * gamma + beta``, plus ``residual``, then the
    ReLU where ``relu``: ``(in dtype_c or None, fp32 or None)``."""
    t = (y.float() - mean) * rstd * gamma + beta
    if residual is not None:
        t = t + residual
    if relu:
        t = torch.clamp_min(t, 0)
    return (t.to(dtype_c) if want_c else None), (t if want_f else None)


def _arriving_plain(y, grads, residual, mean, rstd, gamma, beta, relu):
    """The gradient at the BatchNorm's output (the arriving ones summed in
    fp32, masked where the ReLU's input was negative) and xhat."""
    xhat = (y.float() - mean) * rstd
    g = None
    for a in grads:
        if a is not None:
            g = a.float() if g is None else g + a.float()
    if g is None:
        g = torch.zeros_like(xhat)
    if relu:
        pre = xhat * gamma + beta
        if residual is not None:
            pre = pre + residual
        g = torch.where(pre >= 0, g, torch.zeros((), dtype=g.dtype,
                                                 device=g.device))
    return g, xhat


def bn_grad_plain(y, grads, residual, mean, rstd, gamma, beta,
                  relu: bool = False, want_res: bool = False):
    """The backward's reduction: ``(g for the residual or None, dgamma,
    dbeta)``; ``grads`` are the gradients arriving at the outputs (None
    where an output took none)."""
    g, xhat = _arriving_plain(y, grads, residual, mean, rstd, gamma, beta,
                              relu)
    dims = _dims(g)
    return (g if want_res else None), (g * xhat).sum(dims), g.sum(dims)


def bn_grad_apply_plain(y, grads, residual, mean, rstd, gamma, beta,
                        relu, d_res, dgamma, dbeta):
    """``dy = (gamma * rstd) * ((g - dbeta / M) - xhat * (dgamma / M))`` in
    ``y``'s dtype; ``g`` is ``d_res`` where given."""
    g, xhat = _arriving_plain(y, grads, residual, mean, rstd, gamma, beta,
                              relu)
    if d_res is not None:
        g = d_res
    m = y.numel() // y.shape[-1]
    return ((gamma * rstd) * (g - dbeta / m - xhat * (dgamma / m))) \
        .to(y.dtype)


def rmsprop_multi_plain(grads, params, square_avg, momentum_buf, *, lr,
                        weight_decay, momentum, alpha, eps):
    """``policy/optim.py``'s RMSprop step leaf by leaf: the new params,
    square averages and momentum buffers as lists (the buffers as given
    where ``momentum`` is 0)."""
    new_p, new_sq, new_buf = [], [], []
    for g, p, sq, buf in zip(grads, params, square_avg, momentum_buf):
        g = g + weight_decay * p
        sq = alpha * sq + (1.0 - alpha) * g * g
        step = g / (torch.sqrt(sq) + eps)
        if momentum > 0:
            buf = momentum * buf + step
            step = buf
        new_p.append(p - lr * step)
        new_sq.append(sq)
        new_buf.append(buf)
    return new_p, new_sq, new_buf


# ---------------------------------------------------------------------------
# launch plans and the library
# ---------------------------------------------------------------------------


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def policy_bn_plan(m: int, c: int, itemsize: int, sms: int) -> Dict:
    """The launch plan of a BatchNorm over ``m`` rows of ``c`` channels of
    ``itemsize`` bytes on a card of ``sms`` SMs.  A thread takes one
    16-byte vector of ``vec`` channels of a row (``groups`` a row); a CTA's
    ``THREADS`` are ``lanes`` rows at a time.  A reduction (``bn_stats``,
    ``bn_grad``) gives each of its ``ctas`` CTAs ``rows`` consecutive rows,
    about ``ROWS_PER_THREAD`` a thread and at most ``REDUCE_CTAS_PER_SM``
    CTAs an SM; an apply
    strides ``apply_ctas`` CTAs over the vectors.  Raises for widths the
    kernels do not take: ``c`` a multiple of ``vec``, ``groups`` dividing
    ``THREADS``, at most ``THREADS`` channels."""
    vec = 16 // itemsize
    if c <= 0 or c % vec or THREADS % (c // vec) or c > THREADS:
        raise ValueError(f"policy BatchNorm kernels take C a multiple of "
                         f"{vec} with C/{vec} dividing {THREADS}, C <= "
                         f"{THREADS}; got C={c}")
    if m <= 0 or m * c >= 2 ** 31:
        raise ValueError(f"policy BatchNorm kernels take 0 < M*C < 2^31; "
                         f"got M={m}, C={c}")
    groups = c // vec
    lanes = THREADS // groups
    ctas = max(1, min(_ceil(m, lanes * ROWS_PER_THREAD),
                      REDUCE_CTAS_PER_SM * sms))
    rows = _ceil(m, ctas)
    return {"vec": vec, "groups": groups, "lanes": lanes,
            "ctas": _ceil(m, rows), "rows": rows,
            "apply_ctas": max(1, min(_ceil(m * groups, THREADS),
                                     APPLY_CTAS_PER_SM * sms))}


def _lib():
    lib = build.library("policy")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.policy_bn_stats.argtypes = [p, i, i, i, i, i] + [p] * 7 \
            + [f, f, f, p, p]
        lib.policy_bn_apply.argtypes = [p, i, i] + [p] * 7 + [i] * 4 + [p]
        lib.policy_bn_grad.argtypes = [p, i, i] + [p] * 12 + [i] * 5 \
            + [p, p]
        lib.policy_bn_grad_apply.argtypes = [p, i, i] + [p] * 12 \
            + [i] * 4 + [p]
        lib.rmsprop_multi.argtypes = [p, p, i, i] + [f] * 6 + [i, p]
        for fn in (lib.policy_bn_stats, lib.policy_bn_apply,
                   lib.policy_bn_grad, lib.policy_bn_grad_apply,
                   lib.rmsprop_multi):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


_SEMS: Dict[Tuple[int, int], torch.Tensor] = {}


def _sem(device: torch.device) -> torch.Tensor:
    """The current stream's last-CTA counter of the reductions on
    ``device``: zero between launches, as the last CTA resets it.  Launches
    on one stream run one after another, so they share it; two streams
    never do, so reductions may overlap across streams.  A CUDA graph's
    launches keep the counter of the stream that captured them, so replay
    a graph on one stream at a time.  Made at a stream's first reduction,
    which must not be under CUDA-graph capture (``core/graphs.py`` runs
    each body eagerly first on the stream that captures it)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    sem = _SEMS.get(key)
    if sem is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the policy BatchNorm kernels' first launch "
                               "on a stream is under CUDA-graph capture: "
                               "run the body once eagerly on that stream "
                               "first")
        sem = _SEMS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return sem


def _check(name: str, t: torch.Tensor, dtype, device, numel: int,
           align: int = 16) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
    if t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected "
                         f"{numel}")


def _prepare(y: torch.Tensor):
    """(m, c, plan) of a CUDA BatchNorm input, checked."""
    if y.device.type != "cuda":
        raise ValueError(f"policy kernels need CUDA tensors, got {y.device}")
    if y.dtype not in _DTYPE:
        raise ValueError(f"unsupported dtype {y.dtype}")
    c = y.shape[-1]
    m = y.numel() // c
    plan = policy_bn_plan(m, c, y.element_size(), kernels.sms(y.device))
    _check("y", y, y.dtype, y.device, m * c)
    return m, c, plan


def _check_channels(device, c, **vectors) -> None:
    for name, t in vectors.items():
        _check(name, t, torch.float32, device, c)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def bn_stats(y, run_mean=None, run_var=None, *, eps: float,
             momentum: float):
    """``bn_stats_plain``'s values; on CUDA one launch (``policy_bn_stats``),
    the running update in its last CTA (found through the stream's counter,
    ``_sem``)."""
    if y.device.type != "cuda":
        return bn_stats_plain(y, run_mean, run_var, eps=eps,
                              momentum=momentum)
    m, c, plan = _prepare(y)
    dev = y.device
    update = run_mean is not None
    if update:
        _check_channels(dev, c, run_mean=run_mean, run_var=run_var)
    part = torch.empty((plan["ctas"], 2, c), dtype=torch.float32, device=dev)
    out = torch.empty((4 if update else 2, c), dtype=torch.float32,
                      device=dev)
    mean, rstd = out[0], out[1]
    new_mean, new_var = (out[2], out[3]) if update else (None, None)
    err = _lib().policy_bn_stats(
        _ptr(y), _DTYPE[y.dtype], m, c, plan["ctas"], plan["rows"],
        _ptr(part), _ptr(mean), _ptr(rstd), _ptr(run_mean), _ptr(run_var),
        _ptr(new_mean), _ptr(new_var), eps, momentum, 1.0 - momentum,
        _ptr(_sem(dev)), _stream())
    build.check(err, "policy_bn_stats")
    kernels.launches["policy_bn_stats"] += 1
    return mean, rstd, new_mean, new_var


def bn_apply(y, mean, rstd, gamma, beta, residual=None, relu: bool = False,
             dtype_c=torch.bfloat16, want_c: bool = True,
             want_f: bool = False):
    """``bn_apply_plain``'s values; on CUDA one launch
    (``policy_bn_apply``) writing each asked output once."""
    if y.device.type != "cuda":
        return bn_apply_plain(y, mean, rstd, gamma, beta, residual, relu,
                              dtype_c, want_c, want_f)
    m, c, plan = _prepare(y)
    dev = y.device
    if dtype_c not in _DTYPE or (y.dtype, dtype_c) == (torch.bfloat16,
                                                       torch.float32):
        raise ValueError(f"unsupported output dtype {dtype_c} for a "
                         f"{y.dtype} input")
    if not (want_c or want_f):
        raise ValueError("bn_apply with no output")
    _check_channels(dev, c, mean=mean, rstd=rstd, gamma=gamma, beta=beta)
    if residual is not None:
        _check("residual", residual, torch.float32, dev, m * c)
    out_c = torch.empty(y.shape, dtype=dtype_c, device=dev) if want_c \
        else None
    out_f = torch.empty(y.shape, dtype=torch.float32, device=dev) \
        if want_f else None
    err = _lib().policy_bn_apply(
        _ptr(y), _DTYPE[y.dtype], _DTYPE[dtype_c], _ptr(residual),
        _ptr(mean), _ptr(rstd), _ptr(gamma), _ptr(beta), _ptr(out_c),
        _ptr(out_f), m, c, int(relu), plan["apply_ctas"], _stream())
    build.check(err, "policy_bn_apply")
    kernels.launches["policy_bn_apply"] += 1
    return out_c, out_f


def _grad_args(y, grads, residual, mean, rstd, gamma, beta):
    """The CUDA backward's checked inputs: (m, c, plan, (g0, g1, gf), the
    dtype of g0 and g1)."""
    m, c, plan = _prepare(y)
    dev = y.device
    _check_channels(dev, c, mean=mean, rstd=rstd, gamma=gamma, beta=beta)
    g0, g1, gf = grads
    # without g0 and g1 their dtype is moot: take the input's
    dtype_c = g0.dtype if g0 is not None else y.dtype
    if g0 is not None:
        _check("g0", g0, dtype_c, dev, m * c)
    if g1 is not None:
        if g0 is None:
            raise ValueError("g1 without g0")
        _check("g1", g1, dtype_c, dev, m * c)
    if gf is not None:
        _check("gf", gf, torch.float32, dev, m * c)
    if residual is not None:
        _check("residual", residual, torch.float32, dev, m * c)
    if dtype_c not in _DTYPE or (y.dtype, dtype_c) == (torch.bfloat16,
                                                       torch.float32):
        raise ValueError(f"unsupported gradient dtype {dtype_c} for a "
                         f"{y.dtype} input")
    return m, c, plan, (g0, g1, gf), dtype_c


def bn_grad(y, grads, residual, mean, rstd, gamma, beta, relu: bool = False,
            want_res: bool = False):
    """``bn_grad_plain``'s values; on CUDA one launch (``policy_bn_grad``),
    merged in its last CTA (``_sem``).  ``grads`` is ``(g0, g1, gf)``: two
    gradients in the conv inputs' dtype (``g1`` only with ``g0``) and one
    fp32, each None where absent."""
    if y.device.type != "cuda":
        return bn_grad_plain(y, grads, residual, mean, rstd, gamma, beta,
                             relu, want_res)
    m, c, plan, (g0, g1, gf), dtype_c = _grad_args(
        y, grads, residual, mean, rstd, gamma, beta)
    dev = y.device
    d_res = torch.empty(y.shape, dtype=torch.float32, device=dev) \
        if want_res else None
    part = torch.empty((plan["ctas"], 2, c), dtype=torch.float32, device=dev)
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    dbeta, dgamma = out[0], out[1]
    err = _lib().policy_bn_grad(
        _ptr(y), _DTYPE[y.dtype], _DTYPE[dtype_c], _ptr(g0), _ptr(g1),
        _ptr(gf), _ptr(residual), _ptr(mean), _ptr(rstd), _ptr(gamma),
        _ptr(beta), _ptr(d_res), _ptr(part), _ptr(dbeta), _ptr(dgamma), m,
        c, int(relu), plan["ctas"], plan["rows"], _ptr(_sem(dev)), _stream())
    build.check(err, "policy_bn_grad")
    kernels.launches["policy_bn_grad"] += 1
    return d_res, dgamma, dbeta


def bn_grad_apply(y, grads, residual, mean, rstd, gamma, beta, relu,
                  d_res, dgamma, dbeta):
    """``bn_grad_apply_plain``'s values; on CUDA one launch
    (``policy_bn_grad_apply``)."""
    if y.device.type != "cuda":
        return bn_grad_apply_plain(y, grads, residual, mean, rstd, gamma,
                                   beta, relu, d_res, dgamma, dbeta)
    m, c, plan, (g0, g1, gf), dtype_c = _grad_args(
        y, grads, residual, mean, rstd, gamma, beta)
    dev = y.device
    _check_channels(dev, c, dgamma=dgamma, dbeta=dbeta)
    if d_res is not None:
        _check("d_res", d_res, torch.float32, dev, m * c)
    dy = torch.empty(y.shape, dtype=y.dtype, device=dev)
    err = _lib().policy_bn_grad_apply(
        _ptr(y), _DTYPE[y.dtype], _DTYPE[dtype_c], _ptr(g0), _ptr(g1),
        _ptr(gf), _ptr(residual), _ptr(mean), _ptr(rstd), _ptr(gamma),
        _ptr(beta), _ptr(d_res), _ptr(dbeta), _ptr(dgamma), _ptr(dy), m, c,
        int(relu), plan["apply_ctas"], _stream())
    build.check(err, "policy_bn_grad_apply")
    kernels.launches["policy_bn_grad_apply"] += 1
    return dy


def _as_outputs(outs: str, c, f) -> tuple:
    if outs == "c":
        return (c,)
    if outs == "cc":
        return c, c.view(c.shape)
    if outs == "cf":
        return c, f
    return (f,)


def _split_grads(outs: str, grads) -> tuple:
    """``(g0, g1, gf)`` from the gradients of ``_as_outputs``' outputs."""
    grads = [None if g is None else g.contiguous() for g in grads]
    if outs == "c":
        return grads[0], None, None
    if outs == "cc":
        return grads[0], grads[1], None
    if outs == "cf":
        return grads[0], None, grads[1]
    return None, None, grads[0]


class _BNTrain(torch.autograd.Function):
    """Normalise ``y`` with its batch statistics ``mean`` / ``rstd``
    (computed from ``y`` outside, without grad; the backward is the whole
    of BatchNorm's, the statistics' dependence on ``y`` included), the
    affine, the residual and the ReLU.  Saves ``y`` as it is (bf16 for a
    bf16 conv) and recomputes xhat from it."""

    @staticmethod
    def forward(ctx, y, gamma, beta, residual, mean, rstd, relu, outs,
                dtype_c):
        c, f = bn_apply(y, mean, rstd, gamma, beta, residual, relu, dtype_c,
                        outs != "f", "f" in outs)
        ctx.save_for_backward(y, gamma, beta, residual, mean, rstd)
        ctx.relu, ctx.outs = relu, outs
        return _as_outputs(outs, c, f)

    @staticmethod
    def backward(ctx, *grads):
        y, gamma, beta, residual, mean, rstd = ctx.saved_tensors
        split = _split_grads(ctx.outs, grads)
        d_res, dgamma, dbeta = bn_grad(y, split, residual, mean, rstd, gamma,
                                       beta, ctx.relu, residual is not None)
        dy = bn_grad_apply(y, split, residual, mean, rstd, gamma, beta,
                           ctx.relu, d_res, dgamma, dbeta)
        return dy, dgamma, dbeta, d_res, None, None, None, None, None


def bn_train(y, gamma, beta, run_mean, run_var, *, update_stats: bool,
             relu: bool, residual=None, outs: str = "c",
             dtype_c=torch.bfloat16, eps: float, momentum: float):
    """Train-mode BatchNorm of a convolution's NHWC output ``y`` (its
    batch statistics, the running update where ``update_stats``), the
    affine, ``residual`` (fp32) and the ReLU where ``relu``.  Returns the
    tuple of outputs ``outs`` names (``OUTS``) and the new running
    ``(mean, var)`` (the given ones where not ``update_stats``).
    Differentiable in ``y``, ``gamma``, ``beta`` and ``residual``: two
    launches forward, two backward on CUDA."""
    if outs not in OUTS:
        raise ValueError(f"outs {outs!r} not in {OUTS}")
    with torch.no_grad():
        mean, rstd, new_mean, new_var = bn_stats(
            y, run_mean if update_stats else None,
            run_var if update_stats else None, eps=eps, momentum=momentum)
    running = (new_mean, new_var) if update_stats else (run_mean, run_var)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (y, gamma, beta, residual)):
        return _BNTrain.apply(y, gamma, beta, residual, mean, rstd, relu,
                              outs, dtype_c), running
    c, f = bn_apply(y, mean, rstd, gamma, beta, residual, relu, dtype_c,
                    outs != "f", "f" in outs)
    return _as_outputs(outs, c, f), running


def rmsprop_multi(grads: Sequence[torch.Tensor],
                  params: Sequence[torch.Tensor],
                  square_avg: Sequence[torch.Tensor],
                  momentum_buf: Sequence[torch.Tensor], out=None, *,
                  lr: float, weight_decay: float, momentum: float,
                  alpha: float, eps: float
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                             List[torch.Tensor]]:
    """One RMSprop step over every leaf (``rmsprop_multi_plain``'s
    values).  ``out``: the ``(params, square_avg, momentum_buf)`` lists to
    write, which may be the inputs (in place); None makes new tensors (the
    buffers stay the given ones where ``momentum`` is 0).  On CUDA one
    launch (``rmsprop_multi``) each ``RMS_LEAVES`` leaves: fp32, contiguous,
    on one card."""
    hp = dict(lr=lr, weight_decay=weight_decay, momentum=momentum,
              alpha=alpha, eps=eps)
    lists = [list(grads), list(params), list(square_avg), list(momentum_buf)]
    if len({len(x) for x in lists}) != 1 or not lists[0]:
        raise ValueError("rmsprop_multi takes equally long, non-empty lists")
    dev = lists[1][0].device
    if dev.type != "cuda":
        new = rmsprop_multi_plain(*lists, **hp)
        if out is None:
            return new
        with torch.no_grad():
            for dst, src in zip(out, new):
                for d, s in zip(dst, src):
                    if d is not s:
                        d.copy_(s)
        return tuple(list(o) for o in out)
    if out is None:
        out = ([torch.empty_like(p) for p in lists[1]],
               [torch.empty_like(s) for s in lists[2]],
               [torch.empty_like(b) for b in lists[3]] if momentum > 0
               else lists[3])
    out = tuple(list(o) for o in out)
    rows = list(zip(*lists, *out))
    for row in rows:
        n = row[1].numel()
        for name, t in zip(("grad", "param", "square_avg", "momentum_buf",
                            "param out", "square_avg out",
                            "momentum_buf out"), row):
            # scalar loads: the leaves may be views into one buffer
            # (parallel/distributed.py mean_tree)
            if momentum > 0 or "momentum_buf" not in name:
                _check(name, t, torch.float32, dev, n, align=4)
    lib = _lib()
    for lo in range(0, len(rows), RMS_LEAVES):
        chunk = rows[lo:lo + RMS_LEAVES]
        ptrs = (ctypes.c_void_p * (7 * len(chunk)))(*[
            t.data_ptr() if (momentum > 0 or k not in (3, 6)) else None
            for row in chunk for k, t in enumerate(row)])
        sizes = (ctypes.c_longlong * len(chunk))(
            *[row[1].numel() for row in chunk])
        most = max(row[1].numel() for row in chunk)
        ctas_x = max(1, min(_ceil(most, THREADS * 8), 64))
        err = lib.rmsprop_multi(
            ptrs, sizes, len(chunk), ctas_x, lr, weight_decay, alpha,
            1.0 - alpha, eps, momentum, int(momentum > 0), _stream())
        build.check(err, "rmsprop_multi")
        kernels.launches["rmsprop_multi"] += 1
    return out
