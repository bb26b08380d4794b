"""The port's tracing (``utils/profiler.py``, ``csrc/mark.cu``): host spans
with no synchronize, device marks at the stepper's layer boundaries,
counters, and the report.

On the CPU a mark appends the host's clock to a host ring, so the marks'
order, their pairing into steps and a full ring are checked here; the card
cases (marker ``cuda``) capture the marks into CUDA graphs.  This file
imports neither JAX nor the JAX package, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import logging
import types

import pytest
import torch

from blockcopy_tpu_torch.core.graphs import CapturedCall, StepperGraphs
from blockcopy_tpu_torch.device import to_device
from blockcopy_tpu_torch.ops import kernels
from blockcopy_tpu_torch.policy.optim import tree_leaves
from blockcopy_tpu_torch.utils import profiler
from blockcopy_tpu_torch.utils.profiler import timings
from torch_threads import two_torch_threads  # noqa: F401

SHAPE = (1, 256, 256, 3)
FRAMES = 6
# train_interval 2: frames 2, 4, 6 train, 3 and 5 are plain
KINDS = ["first", "train", "plain", "train", "plain", "train"]
SPANS = {"first": ["blocks", "outputs", "writeback"],
         "plain": ["policy", "blocks", "outputs", "reinforce", "writeback"],
         "train": ["policy", "blocks", "outputs", "reinforce", "writeback"],
         "grads": ["policy", "blocks", "outputs", "reinforce", "writeback"],
         "update": ["reinforce", "writeback"]}


@pytest.fixture(autouse=True)
def tracing_off_after():
    """Every test leaves the profiler at level 0 with nothing recorded."""
    yield
    timings.set_level(0)
    profiler.reset()


def _stepper(task, device):
    from blockcopy_tpu_torch.tools import measure
    if task == "semseg":
        return measure.swiftnet_stepper("resnet18", SHAPE, 2, torch.float32,
                                        device, train_interval=2)
    from blockcopy_tpu_torch.models.csp import CSPConfig
    return measure.csp_stepper(SHAPE, 2, torch.float32, device,
                               CSPConfig(stage_blocks=(1, 1, 1, 1)),
                               train_interval=2)


def _frames(device):
    from blockcopy_tpu_torch.tools.measure import synthetic_frames
    return synthetic_frames(SHAPE, FRAMES, torch.float32, device=device)


def _clip(params, stepper, frames, level, group=None):
    """A clip through ``StepperGraphs`` at tracing ``level``: the final
    state's tensors (CPU copies), the report, the graphs and the state."""
    timings.set_level(level)
    profiler.reset()
    graphs = StepperGraphs(stepper, group)
    state = stepper.init_state(params, seed=1)
    for t, frame in enumerate(frames):
        state = graphs.first_step(params, state, frame) if t == 0 \
            else graphs.step(params, state, frame)
    rep = profiler.report()
    leaves = [x.cpu().clone() for x in tree_leaves(
        {k: v for k, v in state.items() if k != "frame_idx"})
        if isinstance(x, torch.Tensor)]
    return leaves, rep, graphs, state


@pytest.fixture(scope="module", params=["semseg", "detection"])
def traced(request):
    """Each task's clip at level 0 and at level 3, on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        params, stepper = _stepper(request.param, "cpu")
        frames = _frames("cpu")
        off = _clip(params, stepper, frames, 0)[:3]
        on = _clip(params, stepper, frames, 3)[:3]
    finally:
        timings.set_level(0)
        profiler.reset()
        torch.set_num_threads(threads)
    return request.param, off, on


# -- host spans ------------------------------------------------------------------


def test_env_never_synchronizes(monkeypatch):
    """A span times the host and waits for nothing: with
    ``torch.cuda.synchronize`` raising, spans of every level, nested, and
    the report and reset all run."""
    def refuse(*a, **k):
        raise AssertionError("a span synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    timings.set_level(5)
    for level in range(1, 6):
        with timings.env("outer", level):
            with timings.env("inner", 2):
                torch.ones(4).sum()
    rep = profiler.report()
    assert rep["spans"]["outer"][1] == 5 and rep["spans"]["inner"][1] == 5
    assert rep["spans"]["outer"][0] >= rep["spans"]["inner"][0] > 0
    profiler.reset()
    assert profiler.report()["spans"] == {}


@pytest.mark.parametrize("level", [0, 1])
def test_spans_below_their_level_record_nothing(level):
    """Level 0 records nothing; a span above the level is left out, and
    the counters start at level 2."""
    timings.set_level(level)
    with timings.env("bc.step", 2):
        timings.count("replays/plain")
    with timings.env("clip", 1):
        pass
    rep = profiler.report()
    assert "bc.step" not in rep["spans"] and rep["counters"] == {}
    assert ("clip" in rep["spans"]) == (level == 1)


def test_spans_are_record_function_events():
    """With tracing on, the step's and the upload's spans are
    ``record_function`` ranges in a CPU ``torch.profiler`` run."""
    from torch.profiler import ProfilerActivity, profile
    params, stepper = _stepper("semseg", "cpu")
    frames = _frames("cpu")[:2]
    timings.set_level(2)
    graphs = StepperGraphs(stepper)
    state = stepper.init_state(params, seed=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = to_device(frames[0], "cpu")
        graphs.first_step(params, state, x)
        graphs.step(params, state, frames[1])
    names = [e.name for e in prof.events()]
    assert names.count("bc.step") == 2 and names.count("bc.upload") == 1
    rep = profiler.report()
    assert rep["spans"]["bc.step"][1] == 2
    assert rep["spans"]["bc.upload"][1] == 1


# -- device marks on the CPU -----------------------------------------------------


def test_tracing_leaves_the_clip_bitwise(traced):
    """A 6-frame clip through ``StepperGraphs`` gives bitwise the same
    state with tracing off and at level 3 (marks on)."""
    _, (off, rep_off, _), (on, _, _) = traced
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert rep_off["steps"] == [] and rep_off["spans"] == {}


def test_mark_sequence_per_kind(traced):
    """Every step opens with its kind, ends at ``writeback``, and marks the
    documented spans in order, each a non-negative time."""
    _, _, (_, rep, _) = traced
    assert [s["kind"] for s in rep["steps"]] == KINDS
    for step in rep["steps"]:
        assert [n for n, _ in step["spans"]] == SPANS[step["kind"]]
        assert all(ns >= 0 for _, ns in step["spans"])
    assert rep["counters"]["marks/dropped"] == 0
    assert rep["counters"]["marks/unpaired"] == 0
    spans = profiler.device_spans(rep["steps"])
    assert spans["train"]["blocks"][1] == 3 and spans["plain"]["policy"][1] \
        == 2
    text = profiler.text(rep)
    assert "Device spans, train steps (3)" in text and "bc.step" in text


def test_gloo_split_marks_grads_and_update():
    """Where the group's collective cannot be captured, a train frame is a
    ``grads`` step and an ``update`` step, each marked as documented."""
    params, stepper = _stepper("semseg", "cpu")
    group = types.SimpleNamespace(capturable=False, mean_tree=lambda t: t)
    _, rep, graphs, _ = _clip(params, stepper, _frames("cpu")[:4], 3,
                              group)
    kinds = [s["kind"] for s in rep["steps"]]
    assert kinds == ["first", "grads", "update", "plain", "grads", "update"]
    for step in rep["steps"]:
        assert [n for n, _ in step["spans"]] == SPANS[step["kind"]]
    assert rep["counters"]["replays/update"] == 1
    assert set(graphs.graphs) == {("first",), ("grads", False),
                                  ("update",), ("plain", False)}


def test_marks_skip_the_meta_device():
    """The stepper's shape pass runs the model on the meta device: it
    marks nothing."""
    params, stepper = _stepper("detection", "cpu")
    timings.set_level(3)
    profiler.reset()
    stepper.init_state(params, seed=1)
    stepper.macs_per_step(params)
    rep = profiler.report()
    assert rep["steps"] == [] and rep["counters"].get("marks/unpaired",
                                                      0) == 0


def test_ring_full_counts_drops(monkeypatch):
    """A full ring keeps its first marks and counts the rest as dropped;
    the step it cut short is left out and its marks counted unpaired."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(profiler, "_rings", {cpu: profiler._Ring(cpu, 8)})
    timings.set_level(3)
    for _ in range(2):
        profiler.enter_step("plain", "cpu")
        for name in ("policy", "blocks", "outputs", "reinforce"):
            profiler.mark(name, "cpu")
        profiler.exit_step("cpu")
    rep = profiler.report()
    assert [s["kind"] for s in rep["steps"]] == ["plain"]
    assert rep["counters"]["marks/dropped"] == 4
    assert rep["counters"]["marks/unpaired"] == 2
    profiler.reset()
    assert profiler.report()["counters"]["marks/dropped"] == 0


def test_pair_leaves_out_what_is_not_a_whole_step():
    """Marks before any step, and a step opened again before it exited,
    are unpaired; the whole steps keep their spans' times."""
    timings.set_level(3)
    ids = {key: profiler._mark_id(*key) for key in [
        ("enter", "plain"), ("span", "policy"), ("exit", "writeback")]}
    enter, span, leave = ids.values()
    marks = [(span, 5), (enter, 10), (span, 12), (enter, 20), (span, 23),
             (leave, 30)]
    got = profiler.pair(marks, dropped=3)
    assert got["steps"] == [{"kind": "plain",
                             "spans": [["policy", 3], ["writeback", 7]]}]
    assert got["unpaired"] == 3 and got["dropped"] == 3


# -- counters ----------------------------------------------------------------------


@pytest.mark.parametrize("level", [0, 2])
def test_captured_call_counters(level):
    """A call's counters (level 2): the first call is the capture, later
    ones replays of its kind that copy each tensor and fill each float.
    Level 0 counts nothing."""
    timings.set_level(level)
    call = CapturedCall(lambda held, x, f: x * f + held, "cpu", kind="toy")
    x = torch.ones(3, 5)
    for i in range(3):
        out = call(torch.zeros(()), x, float(i))
    assert torch.equal(out, 2 * x)
    want = {"captures": 1, "replays/toy": 2, "inputs/tensors": 4,
            "inputs/bytes": 2 * (x.nbytes + 4)} if level else {}
    got = profiler.report()["counters"]
    assert {k: v for k, v in got.items() if k != "capture_s"} == want
    assert ("capture_s" in got) == bool(level)


def test_stepper_graphs_count_replays_by_kind(traced):
    """A clip's replays by kind of frame, and its captures: one a kind."""
    _, _, (_, rep, graphs) = traced
    c = rep["counters"]
    assert c["captures"] == len(graphs.graphs) == 3
    assert (c["replays/train"], c["replays/plain"]) == (2, 1)
    assert "replays/first" not in c
    assert c["inputs/tensors"] == 3 and rep["spans"]["bc.step"][1] == FRAMES


def test_cli_timings_prints_device_spans(caplog, capsys):
    """``--timings 3`` logs the host spans, the counters and the device
    spans a kind of frame after the eval phase."""
    from blockcopy_tpu_torch.tasks.semseg import eval as cli
    with caplog.at_level(logging.INFO, logger="blockcopy_tpu_torch.semseg"):
        cli.main(["--synthetic", "--res", "128", "--clip-length", "2",
                  "--num-clips-warmup", "1", "--num-clips-eval", "1",
                  "--workers", "1", "--device", "cpu", "--model-checkpoint",
                  "", "--speed-mode", "--timings", "3"])
    text = caplog.text
    assert "process_clip/model" in text and "bc.step" in text
    assert "Device spans, first steps (1)" in text
    assert "replays/" in text and "marks/dropped" in text


# -- the card ------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_marks_on_the_card(cuda_device, monkeypatch):
    """RN18 256x512 fp32, 6 frames through ``StepperGraphs`` at level 0
    and at level 3: the same state bitwise (cuDNN deterministic, fp32
    policy convolutions); each graph holds the documented number of marks
    (0 at level 0); the ring's times never go back, and every step takes
    time; a graph captured with marks refuses a call at level 0."""
    from blockcopy_tpu_torch.policy import net as policy_net
    from blockcopy_tpu_torch.tools import measure
    monkeypatch.setattr(policy_net, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    params, stepper = measure.swiftnet_stepper(
        "resnet18", (1, 256, 512, 3), 4, torch.float32, cuda_device,
        train_interval=2)
    frames = measure.synthetic_frames((1, 256, 512, 3), FRAMES,
                                      torch.float32, device=cuda_device)
    off, _, g_off, _ = _clip(params, stepper, frames, 0)
    on, rep, g_on, state = _clip(params, stepper, frames, 3)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    marks = {key: g.launches.get("mark", 0) for key, g in g_on.graphs.items()}
    assert marks == {("first",): 4, ("train", False): 6, ("plain", False): 6}
    assert all(g.launches.get("mark", 0) == 0 for g in g_off.graphs.values())
    # a graph's first call is its eager run, which marks as a replay does
    assert [s["kind"] for s in rep["steps"]] == KINDS
    ring = profiler._rings[torch.device("cuda", torch.cuda.current_device())]
    stamps = [t for _, t in ring.read()[0]]
    assert stamps == sorted(stamps)
    for step in rep["steps"]:
        assert [n for n, _ in step["spans"]] == SPANS[step["kind"]]
        assert sum(ns for _, ns in step["spans"]) > 0
    assert rep["counters"]["replays/train"] == 2
    assert rep["counters"]["inputs/tensors"] == 3
    assert rep["spans"]["bc.graph.launch"][1] == 3
    timings.set_level(0)
    with pytest.raises(RuntimeError, match="device marks on"):
        g_on.first_step(params, state, frames[0])


@pytest.mark.cuda
def test_card_ring_full_counts_drops(cuda_device, monkeypatch):
    """The device ring keeps its first ``capacity`` marks and counts the
    rest in its drop count; each mark is one launch of ``mark``."""
    x = torch.zeros(1, device=cuda_device)
    monkeypatch.setattr(profiler, "_rings", {
        x.device: profiler._Ring(x.device, 5)})
    timings.set_level(3)
    before = kernels.launches["mark"]
    for _ in range(2):
        profiler.enter_step("plain", x)
        profiler.mark("blocks", x)
        profiler.exit_step(x)
    assert kernels.launches["mark"] - before == 6
    torch.cuda.synchronize()
    rep = profiler.report()
    assert [s["kind"] for s in rep["steps"]] == ["plain"]
    assert rep["counters"]["marks/dropped"] == 1
    assert rep["counters"]["marks/unpaired"] == 2
