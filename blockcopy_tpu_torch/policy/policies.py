"""Execution policies: which blocks run this frame (counterpart of
``blockcopy_tpu/policy/policies.py``).

Grids are drawn on the device from each policy's ``torch.Generator``
(seeded from ``block_seed``); ``forward`` takes injected draws instead, so
tests can feed in another framework's random numbers.  The only host read
per frame is the executed-block count (``Policy._finalize``): the ladder
engine needs it to pick the capacity.  The running-cost EMA is a Python
float and the complexity reward enters the update as a Python scalar, so
neither adds a transfer.

``policy_meta`` carries the reference's keys: ``inputs``, ``outputs``,
``outputs_prev``, ``frame_state``, ``grid``, ``num_exec``, ``num_total``,
``perc_exec``, ``output_repr``, ``information_gain``.

``forward`` and ``optim`` take ``graphs`` (a ``core/graphs.py``
``CallGraphs``, or None for op by op): with it ``PolicyTrainRL`` runs its
forward and its REINFORCE update as CUDA graphs, JAX's ``_forward_jit`` and
``_optim_jit`` (``policies.py:254-255``), which write the BN statistics,
the parameters and the RMSprop state into the policy's own tensors.
"""

from __future__ import annotations

import logging
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from blockcopy_tpu_torch.core import grid as gridlib
from blockcopy_tpu_torch.device import resolve_device
from blockcopy_tpu_torch.ops.layers import adaptive_max_pool2d
from blockcopy_tpu_torch.policy import optim as rmsprop
from blockcopy_tpu_torch.policy.information_gain import (
    semseg_information_gain,
    semseg_output_repr,
)
from blockcopy_tpu_torch.policy.net import (
    assemble_policy_input,
    init_policy_net,
    policy_in_channels,
    policy_net_apply,
)

logger = logging.getLogger(__name__)

Draws = Optional[Tuple[torch.Tensor, torch.Tensor]]


def build_policy_from_settings(settings: dict, device=None):
    """The policy a settings dict names (``policies.py:45``), on ``device``
    (default CUDA; raises where it is absent)."""
    name = settings["block_policy"]
    logger.info(
        "> Policy: %s with execution percentage target %s and block size %s",
        name, settings.get("block_target"), settings["block_size"])
    quantum = settings.get("block_quantize_number_exec", 1.0 / 16.0)
    verbose = settings.get("block_policy_verbose", False)
    seed = settings.get("block_seed", 0)
    bs = settings["block_size"]
    device = resolve_device(device)
    if name == "all":
        return PolicyAll(bs, verbose=verbose, seed=seed, device=device)
    if name == "none":
        return PolicyNone(bs, verbose=verbose, seed=seed, device=device)
    if name == "random":
        return PolicyRandom(bs, verbose=verbose, quantize=quantum, seed=seed,
                            device=device)
    if name.startswith("rl_"):
        num_classes = settings["block_num_classes"]
        if name == "rl_semseg":
            ig = SemsegInformationGain(num_classes)
        elif name == "rl_objectdetection":
            from blockcopy_tpu_torch.tasks.detection.information_gain import \
                DetectionInformationGain
            ig = DetectionInformationGain(num_classes, device)
        else:
            raise AttributeError(f'Policy with name "{name}" not defined!')
        return PolicyTrainRL(
            block_size=bs,
            block_target=settings["block_target"],
            cost_momentum=settings["block_cost_momentum"],
            lr=settings["block_optim_lr"],
            weight_decay=settings["block_optim_wd"],
            momentum=settings["block_optim_momentum"],
            complexity_weight=settings["block_complexity_weight"],
            num_classes=num_classes,
            information_gain=ig,
            quantize=quantum,
            verbose=verbose,
            seed=seed,
            arch=settings.get("block_policy_arch", "ref"),
            device=device,
        )
    raise NotImplementedError(f"Policy {name} not implemented")


def reinforce_grads(params, bn_state, cache_x, grid_f, signed, arch: str):
    """The gradients of the REINFORCE loss ``mean(-log p(grid) * signed)``
    through the policy net (BN statistics not updated) with respect to
    ``params``.  Returns ``(grads, loss)``."""
    leaves = rmsprop.tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
    with torch.enable_grad():
        lg, _ = policy_net_apply(leaves, bn_state, cache_x,
                                 update_stats=False, arch=arch)
        l = lg[..., 0]
        logp = grid_f * F.logsigmoid(l) + (1 - grid_f) * F.logsigmoid(-l)
        loss = torch.mean(-logp * signed)
        grads = iter(torch.autograd.grad(loss, rmsprop.tree_leaves(leaves)))
    return rmsprop.tree_map(lambda _: next(grads), leaves), loss.detach()


def reinforce_update(params, bn_state, opt_state, cache_x, grid_f, signed,
                     arch: str, lr: float, weight_decay: float,
                     momentum: float, grad_reduce=None):
    """One REINFORCE step: ``reinforce_grads``, then RMSprop written into
    ``params`` and ``opt_state``'s own tensors (``rmsprop.update_``: on
    CUDA one launch).  ``grad_reduce(grads)``, where given, replaces the
    gradients before the update (clip-parallel ranks average theirs).
    Returns ``(params, opt_state, loss)``, the trees given."""
    grads, loss = reinforce_grads(params, bn_state, cache_x, grid_f, signed,
                                  arch)
    if grad_reduce is not None:
        grads = grad_reduce(grads)
    rmsprop.update_(grads, opt_state, params, lr=lr,
                    weight_decay=weight_decay, momentum=momentum)
    return params, opt_state, loss


class PolicyStats:
    """Average executed-block accounting (reference ``policy.py:72-100``)."""

    def __init__(self):
        self.count_images = 0
        self.exec = 0
        self.total = 0

    def add_policy_meta(self, policy_meta: dict, num_exec: int) -> dict:
        grid = policy_meta["grid"]
        num_total = math.prod(grid.shape)
        policy_meta["num_exec"] = num_exec
        policy_meta["num_total"] = num_total
        policy_meta["perc_exec"] = float(num_exec) / num_total
        self.count_images += grid.shape[0]
        self.exec += num_exec
        self.total += num_total
        return policy_meta

    def get_exec_percentage(self) -> float:
        return float(self.exec) / max(self.total, 1)

    def __repr__(self):
        return ("Policy stats: average exec percentage [0 - 1] : "
                f"{self.get_exec_percentage():0.3f}")


class Policy:
    """Abstract policy (reference ``policy.py:103-157``)."""

    def __init__(self, block_size: int, verbose: bool = False,
                 quantize: float = 0.0, seed: int = 0, device=None):
        self.block_size = block_size
        self.verbose = verbose
        self.quantize = quantize
        self.stats = PolicyStats()
        self.device = resolve_device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.net_params = None  # trainable policies override

    def is_trainable(self) -> bool:
        return self.net_params is not None

    def _grid_geometry(self, inputs):
        n, h, w, _ = inputs.shape
        gh, gw = gridlib.grid_shape(h, w, self.block_size)
        return n, gh, gw

    def _full_grid(self, inputs, value: bool = True) -> torch.Tensor:
        return torch.full(self._grid_geometry(inputs), value,
                          dtype=torch.bool, device=inputs.device)

    def _finalize(self, policy_meta: dict, grid) -> dict:
        policy_meta["grid"] = grid
        # the frame's one host read: the engine picks the capacity from it
        num_exec = int(grid.sum())
        return self.stats.add_policy_meta(policy_meta, num_exec)

    def forward(self, policy_meta: dict, draws: Draws = None,
                graphs=None) -> dict:
        raise NotImplementedError

    def __call__(self, policy_meta: dict, draws: Draws = None,
                 graphs=None) -> dict:
        return self.forward(policy_meta, draws, graphs)

    def optim(self, policy_meta: dict, train: bool = True,
              graphs=None) -> dict:
        return policy_meta

    def state(self) -> dict:
        """Checkpointable policy state (the reference never persists it)."""
        return {}

    def load_state(self, state: dict) -> None:
        pass


class PolicyAll(Policy):
    """Execute every block (reference ``policy.py:160-174``)."""

    def forward(self, policy_meta: dict, draws: Draws = None,
                graphs=None) -> dict:
        return self._finalize(policy_meta,
                              self._full_grid(policy_meta["inputs"]))


class PolicyNone(Policy):
    """Execute everything on the first frame, nothing afterwards
    (reference ``policy.py:177-192``).  Keyed off ``outputs_prev``, as the
    reference: frames 1 and 2 of a clip both execute everything."""

    def forward(self, policy_meta: dict, draws: Draws = None,
                graphs=None) -> dict:
        first = policy_meta.get("outputs_prev", None) is None
        return self._finalize(policy_meta,
                              self._full_grid(policy_meta["inputs"], first))


class PolicyRandom(Policy):
    """All blocks while ``outputs_prev`` is unset, then Bernoulli(0.5) and
    quantization (reference ``policy.py:195-216``).  ``draws=(normals,
    u_rank)`` of shapes ``(N, GH, GW)`` and ``(N*GH*GW,)`` replaces the
    generator's draws."""

    def forward(self, policy_meta: dict, draws: Draws = None,
                graphs=None) -> dict:
        inputs = policy_meta["inputs"]
        if policy_meta.get("outputs_prev", None) is None:
            return self._finalize(policy_meta, self._full_grid(inputs))
        normals, u_rank = draws if draws is not None else (None, None)
        if normals is None:
            normals = torch.randn(self._grid_geometry(inputs),
                                  generator=self.generator,
                                  device=inputs.device)
        grid = gridlib.quantize_grid(normals > 0, self.quantize,
                                     self.generator, u_rank)
        return self._finalize(policy_meta, grid)


class SemsegInformationGain:
    """Strategy object: KL information gain for segmentation, computed on
    the device (inside the REINFORCE graph, as JAX's jitted ``_compute``,
    ``policies.py:207``): ``gain_inputs`` are the outputs and the previous
    ones, ``gain`` the KL."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def get_output_repr(self, policy_meta: dict):
        return semseg_output_repr(policy_meta["outputs"])

    def gain_inputs(self, policy_meta: dict):
        return policy_meta["outputs"], policy_meta["outputs_prev"]

    @staticmethod
    def gain(outputs, outputs_prev):
        return semseg_information_gain(outputs, outputs_prev)


class PolicyTrainRL(Policy):
    """Online-REINFORCE policy (reference ``policy.py:219-370``).

    Per frame: policy-net forward, Bernoulli sampling and count
    quantization; every ``train_interval`` frames a REINFORCE step
    (information gain + complexity reward, signed for skipped blocks) with
    torch-exact RMSprop.
    """

    def __init__(self, block_size, block_target, cost_momentum, lr,
                 weight_decay, momentum, complexity_weight, num_classes,
                 information_gain, quantize=1.0 / 16.0, at_least_one=False,
                 verbose=False, seed=0, arch="ref", device=None):
        super().__init__(block_size, verbose, quantize, seed, device)
        if not 0.0 <= block_target <= 1.0:
            raise ValueError(f"block_target {block_target} not in [0, 1]")
        self.block_target = block_target
        self.cost_momentum = cost_momentum
        self.lr = lr
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.complexity_weight_gamma = complexity_weight
        self.num_classes = num_classes
        self.information_gain = information_gain
        self.at_least_one = at_least_one
        self.arch = arch
        self.running_cost: Optional[float] = None

        # fast arch: the logit-head bias starts at logit(target), so
        # sampling opens at the execution target; the ref arch keeps the
        # reference's init
        t = min(max(block_target, 1e-3), 1 - 1e-3)
        head_bias = math.log(t / (1.0 - t)) if arch == "fast" else 0.0
        self.net_params, self.bn_state = init_policy_net(
            policy_in_channels(num_classes), seed=seed, arch=arch,
            head_bias=head_bias, device=self.device)
        self.opt_state = rmsprop.init(self.net_params)

    def _forward_impl(self, frame, frame_state, output_repr, prev_grid,
                      draws: Draws):
        x = assemble_policy_input(frame, frame_state, output_repr, prev_grid,
                                  self.block_size)
        logits, bn_state = policy_net_apply(self.net_params, self.bn_state,
                                            x, update_stats=True,
                                            arch=self.arch)
        probs = torch.sigmoid(logits[..., 0])
        u, u_rank = draws if draws is not None else (None, None)
        if u is None:
            u = torch.rand(probs.shape, generator=self.generator,
                           device=probs.device)
        grid = u < probs
        if self.at_least_one:
            # nothing sampled: force one block (reference policy.py:289-291)
            grid[0, 0, 0] |= ~grid.any()
        grid = gridlib.quantize_grid(grid, self.quantize, self.generator,
                                     u_rank)
        exec_prob = torch.where(grid, probs, 0).sum() \
            / grid.sum().clamp_min(1)
        skip_prob = torch.where(grid, 0, probs).sum() \
            / (~grid).sum().clamp_min(1)
        return grid, x, bn_state, exec_prob, skip_prob

    def _held(self):
        """What the policy's graphs read and write in place."""
        return self.net_params, self.bn_state, self.opt_state, self.generator

    def _forward_graph(self, held, frame, frame_state, output_repr, grid,
                       draws: Draws = None):
        """The forward graph's body (JAX's ``_forward_jit``):
        ``_forward_impl`` from the previous grid, the BN statistics written
        into the policy's own."""
        with torch.no_grad():
            grid, x, bn_state, exec_p, skip_p = self._forward_impl(
                frame, frame_state, output_repr, grid.float(), draws)
        rmsprop.tree_copy_(self.bn_state, bn_state)
        return grid, x, exec_p, skip_p

    def forward(self, policy_meta: dict, draws: Draws = None,
                graphs=None) -> dict:
        """``draws=(u, u_rank)`` of shapes ``(N, GH, GW)`` and
        ``(N*GH*GW,)`` replaces the generator's Bernoulli and rank
        uniforms.  Under ``graphs`` the frame's forward is a graph (one with
        ``draws``, one without; the policy's generator registered with
        both) and its results are cloned out; frame 1's all-ones grid stays
        outside it."""
        inputs = policy_meta["inputs"]
        if policy_meta.get("outputs", None) is None:
            # no temporal history: execute everything (policy.py:270-274)
            policy_meta["_rl_cache"] = None
            return self._finalize(policy_meta, self._full_grid(inputs))
        args = (inputs, policy_meta["frame_state"],
                policy_meta["output_repr"])
        if graphs is None:
            with torch.no_grad():
                grid, cache_x, self.bn_state, exec_p, skip_p = \
                    self._forward_impl(*args, policy_meta["grid"].float(),
                                       draws)
        else:
            grid, cache_x, exec_p, skip_p = rmsprop.tree_map(
                torch.clone, graphs(
                    ("policy_forward", draws is None), self._forward_graph,
                    self._held(), *args, policy_meta["grid"],
                    *(() if draws is None else (tuple(draws),))))
        if self.verbose and not bool(torch.isfinite(exec_p)
                                     & torch.isfinite(skip_p)):
            # NaN guard (reference policy.py:281-283); verbose only, so the
            # frame loop keeps its single host read
            raise FloatingPointError(
                "Policy net returned NaN's, maybe optimization problem?")
        policy_meta["_rl_cache"] = cache_x
        policy_meta["_rl_probs"] = (exec_p, skip_p)
        return self._finalize(policy_meta, grid)

    def _signed_reward(self, ig, grid, rcw):
        """The gain plus the complexity reward ``rcw``, max-pooled per
        block, signed by the grid (skipped blocks negative)."""
        reward = ig.float() + rcw
        reward_grid = adaptive_max_pool2d(
            reward, (grid.shape[1], grid.shape[2]))[..., 0]
        return torch.where(grid, reward_grid, -reward_grid)

    def _optim_graph(self, held, cache_x, grid, rcw, *gain_inputs):
        """The REINFORCE graph's body (JAX's ``_optim_jit`` with the
        semseg gain): the gain, the signed reward, the gradients and the
        RMSprop update, written into the policy's own tensors.  Returns the
        gain."""
        with torch.no_grad():
            ig = self.information_gain.gain(*gain_inputs)
            signed = self._signed_reward(ig, grid, rcw)
        reinforce_update(self.net_params, self.bn_state, self.opt_state,
                         cache_x, grid.float(), signed, self.arch, self.lr,
                         self.weight_decay, self.momentum)
        return ig

    def optim(self, policy_meta: dict, train: bool = True,
              graphs=None) -> dict:
        """The running cost, and on a train frame the REINFORCE update;
        under ``graphs`` a graph (the complexity reward enters it as a
        host float; the detection gain, painted on the host, as a
        tensor).  The running cost and the verbose and 300-image checks
        stay on the host, as in JAX."""
        policy_meta["output_repr"] = self.information_gain.get_output_repr(
            policy_meta)
        block_use = policy_meta["perc_exec"]
        if self.running_cost is None:
            self.running_cost = block_use
        self.running_cost = (self.running_cost * self.cost_momentum
                             + (1 - self.cost_momentum) * block_use)
        if (policy_meta.get("outputs_prev", None) is None or not train
                or policy_meta.get("_rl_cache", None) is None):
            return policy_meta
        grid = policy_meta["grid"]
        rc = -(self.running_cost - self.block_target)
        rcw = rc * abs(rc) * self.complexity_weight_gamma
        gain_inputs = self.information_gain.gain_inputs(policy_meta)
        if graphs is None:
            with torch.no_grad():
                ig = self.information_gain.gain(*gain_inputs)
                # a Python scalar: an upload from pageable memory would
                # sync
                signed = self._signed_reward(ig, grid, rcw)
            reinforce_update(
                self.net_params, self.bn_state, self.opt_state,
                policy_meta["_rl_cache"], grid.float(), signed, self.arch,
                self.lr, self.weight_decay, self.momentum)
        else:
            ig = graphs(("policy_optim",), self._optim_graph, self._held(),
                        policy_meta["_rl_cache"], grid, float(rcw),
                        *gain_inputs).clone()
        policy_meta["information_gain"] = ig
        if self.verbose:
            exec_p, skip_p = torch.stack(policy_meta["_rl_probs"]).tolist()
            print(f"BLOCKS/running_cost: {self.running_cost: 0.3f}\n"
                  f"BLOCKS/block_use: {block_use:0.3f}\n"
                  f"BLOCKS/reward_complexity_weighted: {rcw}\n"
                  f"BLOCKS/avg_prob_exec: {exec_p:0.3f}\n"
                  f"BLOCKS/avg_prob_skip: {skip_p:0.3f}\n")
            print(self.stats)
        if self.stats.count_images > 300 and "_rl_probs" in policy_meta:
            exec_p, skip_p = torch.stack(policy_meta["_rl_probs"]).tolist()
            if exec_p - skip_p < 0.3:
                logger.warning(
                    "Block execution policy seems not well trained yet.")
        return policy_meta

    def state(self) -> dict:
        return {
            "net_params": self.net_params,
            "bn_state": self.bn_state,
            "opt_state": self.opt_state,
            "running_cost": self.running_cost,
        }

    def load_state(self, state: dict) -> None:
        """Copied into this policy's tensors, which its graphs hold.  The
        JAX state's ``key`` is ignored: draws stay with this policy's
        generator."""
        rmsprop.tree_copy_(self.net_params, state["net_params"])
        rmsprop.tree_copy_(self.bn_state, state["bn_state"])
        rmsprop.tree_copy_(self.opt_state, state["opt_state"])
        self.running_cost = state["running_cost"]
