"""The port's semseg CLI held against the JAX CLI on the CPU
(``--device cpu``), both loading one fake reference ``.pth`` written here:
``gmacs_per_image`` and its breakdown to 1e-9 relative, ``Mean IoU`` (and
the other accuracies) within 1e-3 absolute (fp32 argmax near-ties), for the
ladder engine with ``all`` and ``none`` and for ``static``; ``--speed-mode``
runs; the policy checkpoints round-trip exactly.  No file is fetched.

Then the pieces the CLI uses, each against its JAX counterpart: the ``.pth``
converter (bitwise after the layout transpose), npz files the JAX package
wrote (model parameters, ladder and stepper policy state), the capacity
ladder, ``StreamSegMetrics``, ``PrefetchLoader`` and the eval transforms."""

import json

import numpy as np
import pytest
import torch

from blockcopy_tpu.tasks.semseg import eval as jcli
from blockcopy_tpu_torch.tasks.semseg import eval as tcli
from torch_port_util import two_torch_threads  # noqa: F401

NUM_CLASSES = 19
ARGS = ["--synthetic", "--res", "256", "--clip-length", "3",
        "--num-clips-warmup", "1", "--num-clips-eval", "1", "--workers", "1"]
# the port-only runs: 128x256 frames (two blocks), two frames a clip
SMALL = ["--synthetic", "--res", "128", "--clip-length", "2",
         "--num-clips-warmup", "1", "--num-clips-eval", "1", "--workers", "1",
         "--device", "cpu"]


def fake_torch_sd(layers=(2, 2, 2, 2), num_features=128, spp_levels=3):
    """A reference-style SwiftNet-RN18 ``state_dict`` of random arrays with
    the reference's keys and shapes (as ``test_checkpoint_cli.py``)."""
    rs = np.random.RandomState(0)
    sd = {}

    def conv(key, cout, cin, k, bias=False):
        sd[key + ".weight"] = rs.randn(cout, cin, k, k).astype(np.float32) \
            * np.float32(np.sqrt(2.0 / (k * k * cout)))
        if bias:
            sd[key + ".bias"] = rs.randn(cout).astype(np.float32)

    def bn(key, c):
        sd[key + ".weight"] = rs.rand(c).astype(np.float32) + 0.5
        sd[key + ".bias"] = rs.randn(c).astype(np.float32) * 0.1
        sd[key + ".running_mean"] = rs.randn(c).astype(np.float32) * 0.1
        sd[key + ".running_var"] = rs.rand(c).astype(np.float32) + 0.5

    def bnrc(prefix, cin, cout, k, bias=True):
        bn(prefix + ".norm", cin)
        conv(prefix + ".conv", cout, cin, k, bias=bias)

    conv("backbone.conv1", 64, 3, 7)
    bn("backbone.bn1", 64)
    cin = 64
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 layers)):
        for b in range(blocks):
            pre = f"backbone.layer{stage + 1}.{b}"
            stride = 1 if stage == 0 or b > 0 else 2
            conv(pre + ".conv1", planes, cin, 3)
            bn(pre + ".bn1", planes)
            conv(pre + ".conv2", planes, planes, 3)
            bn(pre + ".bn2", planes)
            if b == 0 and (stride != 1 or cin != planes):
                conv(pre + ".downsample.0", planes, cin, 1)
                bn(pre + ".downsample.1", planes)
            cin = planes
    level = num_features // spp_levels
    bnrc("spp.spp.spp_bn", 512, num_features, 1, bias=False)
    for i in range(spp_levels):
        bnrc(f"spp.spp.spp{i}", num_features, level, 1, bias=False)
    bnrc("spp.spp.spp_fuse", num_features + spp_levels * level, num_features,
         1, bias=False)
    for i, skip in enumerate([256, 128, 64]):
        bnrc(f"upsample.{i}.bottleneck", skip, num_features, 1, bias=False)
        bnrc(f"upsample.{i}.blend_conv", num_features, num_features, 3,
             bias=False)
    bnrc("logits", num_features, NUM_CLASSES, 1, bias=True)
    return sd


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "swiftnet_rn18.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in fake_torch_sd().items()}}, path)
    return str(path)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("policy", ["all", "none", "static"])
def test_cli_matches_jax(pth, policy, capsys):
    argv = ARGS + ["--model-checkpoint", pth, "--block-policy", policy]
    ref = jcli.main(argv)
    ref_line = _last_json(capsys)
    got = tcli.main(argv + ["--device", "cpu"])
    got_line = _last_json(capsys)
    assert set(got_line) == set(ref_line) and got_line["fps"] > 0
    assert got["gmacs_per_image"] == pytest.approx(ref["gmacs_per_image"],
                                                   rel=1e-9)
    assert got["gmacs_breakdown"] == pytest.approx(ref["gmacs_breakdown"],
                                                   rel=1e-9)
    for key in ("Mean IoU", "Overall Acc", "Mean Acc", "FreqW Acc",
                "Fine mIoU"):
        assert abs(got[key] - ref[key]) < 1e-3, key
    if policy != "static":
        assert got["perc_exec"] == ref["perc_exec"]


def test_speed_mode_runs(capsys):
    """``--speed-mode`` runs; the stepper's MAC breakdown, which it reports,
    equals the JAX stepper's."""
    import jax

    from blockcopy_tpu.core import stepper as JST
    from blockcopy_tpu.models import swiftnet as JS
    from blockcopy_tpu_torch.core import stepper as TST
    from blockcopy_tpu_torch.models import swiftnet as TS
    from blockcopy_tpu_torch.utils.convert import params_to_numpy

    got = tcli.main(SMALL + ["--model-checkpoint", "", "--speed-mode",
                             "--half"])
    line = _last_json(capsys)
    assert line["fps"] > 0 and np.isfinite(line["running_cost"])
    assert 0 < got["perc_exec"] <= 1
    shape, capacity = (1, 256, 512, 3), 4
    tparams = TS.init_swiftnet(TS.SwiftNetConfig(), device="cpu")
    tst = TST.FixedCapacityStepper(TS.make_apply_fn(TS.SwiftNetConfig()),
                                   TST.StepperConfig(), shape, capacity,
                                   device="cpu")
    jst = JST.FixedCapacityStepper(JS.make_apply_fn(JS.SwiftNetConfig()),
                                   JST.StepperConfig(), shape, capacity)
    ref = jst.macs_breakdown_per_step(jax.tree.map(
        jax.numpy.asarray, params_to_numpy(tparams)))
    assert tst.macs_breakdown_per_step(tparams) == pytest.approx(ref,
                                                                 rel=1e-12)
    assert got["gmacs_per_image"] > 0


def test_cli_policy_checkpoint_roundtrip(tmp_path, capsys):
    """The CLI loads the ladder policy before warmup and saves it after;
    loading the saved file and saving it again gives the same bytes."""
    from blockcopy_tpu_torch.core.argparser import default_settings
    from blockcopy_tpu_torch.core.engine import BlockCopyModel

    path = str(tmp_path / "policy.npz")
    model = BlockCopyModel(None, None, default_settings(), device="cpu")
    model.policy.running_cost = 0.0      # must not read back as "unset"
    model.save_policy(path)
    tcli.main(SMALL + ["--model-checkpoint", "", "--policy-checkpoint",
                       path])
    assert _last_json(capsys)["fps"] > 0
    model.load_policy(path)
    assert model.policy.running_cost > 0
    again = str(tmp_path / "again.npz")
    model.save_policy(again)
    with np.load(path) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    fresh = BlockCopyModel(None, None, default_settings(), device="cpu")
    fresh.policy.running_cost = 0.0
    fresh.save_policy(again)
    fresh.load_policy(again)
    assert fresh.policy.running_cost == 0.0


def test_cli_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 13"):
        tcli.main(SMALL + ["--num-devices", "2"])
    with pytest.raises(NotImplementedError, match="native"):
        tcli.main(SMALL + ["--native-io"])


# -- the pieces ---------------------------------------------------------------


def test_convert_state_dict_bitwise():
    from blockcopy_tpu.models.swiftnet import SwiftNetConfig as JCfg
    from blockcopy_tpu.utils.checkpoint import convert_swiftnet_state_dict \
        as jconvert
    from blockcopy_tpu_torch.models.swiftnet import SwiftNetConfig as TCfg
    from blockcopy_tpu_torch.utils.checkpoint import \
        convert_swiftnet_state_dict as tconvert
    from blockcopy_tpu_torch.utils.convert import params_to_numpy
    from torch_port_util import assert_same, assert_tree, jtree

    sd = fake_torch_sd()
    ref = jtree(jconvert(sd, JCfg()))
    got = tconvert(sd, TCfg())
    assert got["backbone"]["conv1"]["w"].shape == (64, 3, 7, 7)   # OIHW
    assert_tree(ref, params_to_numpy(got), assert_same)


def test_load_params_matches_jax_files(pth, tmp_path):
    """The ``.pth`` through both loaders, and a model ``.npz`` the JAX
    package wrote, give the same parameters bit for bit."""
    from blockcopy_tpu.models.swiftnet import SwiftNetConfig as JCfg
    from blockcopy_tpu.utils import checkpoint as jck
    from blockcopy_tpu_torch.models.swiftnet import SwiftNetConfig as TCfg
    from blockcopy_tpu_torch.utils import checkpoint as tck
    from blockcopy_tpu_torch.utils.convert import params_to_numpy
    from torch_port_util import assert_same, assert_tree, jtree

    ref = jtree(jck.load_params(pth, JCfg()))
    assert_tree(ref, params_to_numpy(tck.load_params(pth, TCfg(),
                                                     device="cpu")),
                assert_same)
    npz = str(tmp_path / "params.npz")
    jck.save_params(npz, jck.load_params(pth, JCfg()))
    assert_tree(ref, params_to_numpy(tck.load_params(npz, TCfg(),
                                                     device="cpu")),
                assert_same)
    # and back: the port's file loads in the JAX package
    back = str(tmp_path / "back.npz")
    tck.save_params(back, tck.load_params(npz, TCfg(), device="cpu"))
    assert_tree(ref, jtree(jck.load_npz(back, jck.load_params(pth, JCfg()))),
                assert_same)


def test_policy_npz_written_by_jax_loads(tmp_path):
    """Ladder policy state (``save_ladder_policy``) and single-replica
    stepper policy state (``save_stepper_policy``) written by the JAX
    package load in the port; the JAX ``key`` is not read, and a ladder
    file loads into a stepper too (``policy_ckpt.py:91-103``)."""
    import jax
    import jax.numpy as jnp

    from blockcopy_tpu.core import stepper as JST
    from blockcopy_tpu.core.argparser import default_settings as jset
    from blockcopy_tpu.policy.policies import build_policy_from_settings \
        as jbuild
    from blockcopy_tpu.utils import policy_ckpt as jpc
    from blockcopy_tpu_torch.core import stepper as TST
    from blockcopy_tpu_torch.core.argparser import default_settings as tset
    from blockcopy_tpu_torch.policy.policies import \
        build_policy_from_settings as tbuild
    from blockcopy_tpu_torch.utils import policy_ckpt as tpc
    from blockcopy_tpu_torch.utils.convert import (
        ladder_policy_state_from_jax, params_to_numpy,
        policy_state_from_jax)
    from torch_port_util import assert_same, assert_tree, jtree

    jpol = jbuild(jset(block_policy_arch="fast"))
    jpol.running_cost = 0.625
    ladder = str(tmp_path / "ladder")           # np.savez adds .npz
    jpc.save_ladder_policy(jpol, ladder)
    tpol = tbuild(tset(block_policy_arch="fast"), device="cpu")
    gen_state = tpol.generator.get_state()
    tpc.load_ladder_policy(tpol, ladder)
    want = ladder_policy_state_from_jax(jtree(jpol.state()), device="cpu")
    assert tpol.running_cost == 0.625
    for key in ("net_params", "bn_state", "opt_state"):
        assert_tree(params_to_numpy(want[key]),
                    params_to_numpy(tpol.state()[key]), assert_same)
    assert torch.equal(tpol.generator.get_state(), gen_state)

    jst = JST.FixedCapacityStepper(None, JST.StepperConfig(policy_arch="fast"),
                                   (1, 256, 512, 3), 4)
    jp = jst.init_policy_state(jax.random.PRNGKey(3))
    jp["running_cost"] = jnp.float32(0.25)
    stepper_file = str(tmp_path / "stepper.npz")
    jpc.save_stepper_policy(stepper_file, jp)
    tst = TST.FixedCapacityStepper(None, TST.StepperConfig(policy_arch="fast"),
                                   (1, 256, 512, 3), 4, device="cpu")
    tp = tst.init_policy_state(seed=5)
    got = tpc.load_stepper_policy(stepper_file, tp)
    want = policy_state_from_jax(jtree({k: v for k, v in jp.items()
                                        if k != "key"}), device="cpu")
    assert got["generator"] is tp["generator"]
    assert_tree(params_to_numpy({k: want[k] for k in want}),
                params_to_numpy({k: got[k] for k in want}), assert_same)
    # a ladder file into a stepper, and the port's stepper file round trip
    got = tpc.load_stepper_policy(ladder + ".npz", tp)
    assert float(got["running_cost"]) == 0.625
    again = str(tmp_path / "again.npz")
    tpc.save_stepper_policy(again, got)
    back = tpc.load_stepper_policy(again, tp)
    assert_tree(params_to_numpy({k: got[k] for k in want}),
                params_to_numpy({k: back[k] for k in want}), assert_same)
    with pytest.raises(NotImplementedError, match="item 13"):
        tpc.load_stepper_policy(str(tmp_path), tp)


def test_capacity_ladder_matches_jax():
    """The host functions agree everywhere; ``quantize_grid`` agrees given
    the uniforms JAX draws from its key, and from a generator it still
    keeps every executed block and lands on the ladder."""
    import jax
    import jax.numpy as jnp

    from blockcopy_tpu.core import grid as JG
    from blockcopy_tpu_torch.core import grid as TG
    from torch_port_util import tt

    for total in (8, 16, 128, 130):
        for quantum in (0.0, 1 / 16, 0.25, 0.5, 1.0):
            assert TG.capacity_ladder(total, quantum) == \
                JG.capacity_ladder(total, quantum)
            for count in range(total + 1):
                assert TG.capacity_for_count(count, total, quantum) == \
                    JG.capacity_for_count(count, total, quantum)
    rs = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    for i, (shape, quantum) in enumerate((((1, 8, 16), 1 / 16),
                                          ((2, 2, 4), 0.5),
                                          ((1, 2, 4), 0.25))):
        total = int(np.prod(shape))
        for p in (0.0, 0.05, 0.3, 0.9):
            grid = rs.rand(*shape) < p
            key = jax.random.PRNGKey(100 * i + int(10 * p))
            ref = JG.quantize_grid(key, jnp.asarray(grid), quantum)
            u_rank = jax.random.uniform(key, (total,))
            got = TG.quantize_grid(tt(grid), quantum, u_rank=tt(u_rank))
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            q = TG.quantize_grid(tt(grid), quantum, generator=gen)
            assert int(q.sum()) == TG.capacity_for_count(
                int(grid.sum()), total, quantum)
            assert bool((q | ~tt(grid)).all())       # executed stay on


def test_metrics_loader_transforms_match_jax():
    from PIL import Image

    from blockcopy_tpu.data import loader as JL
    from blockcopy_tpu.data import transforms as JT
    from blockcopy_tpu.utils import metrics as JM
    from blockcopy_tpu_torch.data import loader as TL
    from blockcopy_tpu_torch.data import transforms as TT
    from blockcopy_tpu_torch.data.cityscapes_vid import CityscapesVid
    from blockcopy_tpu_torch.utils import metrics as TM

    rs = np.random.RandomState(0)
    lt = rs.randint(0, 21, (3, 32, 64))
    lt[lt >= 19] = 255
    lp = rs.randint(0, 19, (3, 32, 64))
    names = CityscapesVid.train_id_to_name
    jm = JM.StreamSegMetrics(19, classes=[6, 7, 11], class_names=names)
    tm = TM.StreamSegMetrics(19, classes=[6, 7, 11], class_names=names)
    for m in (jm, tm):
        m.update(lt, lp)
        m.update(lt[:1], lt[:1])
    ref, got = jm.get_results(), tm.get_results()
    assert ref.keys() == got.keys()
    for k in ref:
        if k == "Class IoU":
            assert list(ref[k]) == list(got[k])
            np.testing.assert_array_equal(list(ref[k].values()),
                                          list(got[k].values()))
        else:
            assert ref[k] == got[k], k
    ja, ta = JM.AverageMeter(), TM.AverageMeter()
    for v in (1.0, 3.0, 8.0):
        ja.update("x", v)
        ta.update("x", v)
    assert ja.get_results("x") == ta.get_results("x")

    data = [rs.rand(4) for _ in range(11)]
    for kw in ({"num_workers": 3, "prefetch": 2}, {"max_items": 5}):
        jl, tl = JL.PrefetchLoader(data, **kw), TL.PrefetchLoader(data, **kw)
        assert len(jl) == len(tl) and jl.max_in_flight() == tl.max_in_flight()
        for a, b in zip(jl, tl, strict=True):
            np.testing.assert_array_equal(a, b)

    img = Image.fromarray(rs.randint(0, 256, (60, 90, 3)).astype(np.uint8))
    lbl = Image.fromarray(rs.randint(0, 34, (60, 90)).astype(np.uint8))
    mean, std = CityscapesVid.mean, CityscapesVid.std
    jt = JT.ExtCompose([JT.ExtResize((32, 64)), JT.ExtToArray(),
                        JT.ExtNormalize(mean, std)])
    tt_ = TT.ExtCompose([TT.ExtResize((32, 64)), TT.ExtToArray(),
                         TT.ExtNormalize(mean, std)])
    (ji, jlb), (ti, tlb) = jt(img, lbl), tt_(img, lbl)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tlb, jlb)
    np.testing.assert_array_equal(TT.denormalize(ti, mean, std),
                                  JT.denormalize(ji, mean, std))
