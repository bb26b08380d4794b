"""The port's multi-process startup (``blockcopy_tpu_torch/parallel/
distributed.py``) held against the JAX package's
(``blockcopy_tpu/parallel/distributed.py``): the launcher environment read
into the same dict, the single-process no-op, the env-driven
``init_process_group`` (mocked), ``global_group``'s divisibility rule and
``local_batch_slice``; then, unmocked, two real processes on localhost
joined on gloo through the torch launcher's environment, whose averaged
REINFORCE update leaves the same policy on both (and the same through
``clip_parallel.dryrun_multichip``'s spawned ranks), and a launch whose
coordinator never answers, which raises.
"""

import datetime
import os
import socket
import subprocess
import sys
from unittest import mock

import pytest
import torch.distributed as dist

from blockcopy_tpu.parallel import distributed as jdist
from blockcopy_tpu_torch.parallel import clip_parallel
from blockcopy_tpu_torch.parallel import distributed as tdist
from torch_port_util import two_torch_threads  # noqa: F401

ENV_KEYS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
            "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "JAX_COORDINATOR_ADDRESS",
            "LOCAL_RANK")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    jdist._initialized = False
    yield
    jdist._initialized = False


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# every case of tests/test_distributed.py::TestDetectEnv, and the defaults
# of both contracts
ENVS = {
    "no_signal": ({}, None),
    "world_size_one": ({"WORLD_SIZE": "1"}, None),
    "torch_launcher": ({"WORLD_SIZE": "4", "RANK": "2",
                        "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500"},
                       {"coordinator_address": "10.0.0.1:29500",
                        "num_processes": 4, "process_id": 2}),
    "jax_native": ({"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1",
                    "JAX_COORDINATOR_ADDRESS": "host0:1234"},
                   {"coordinator_address": "host0:1234",
                    "num_processes": 2, "process_id": 1}),
    "torch_defaults": ({"WORLD_SIZE": "2"},
                       {"coordinator_address": "127.0.0.1:8476",
                        "num_processes": 2, "process_id": 0}),
    "jax_defaults": ({"JAX_NUM_PROCESSES": "3"},
                     {"coordinator_address": "127.0.0.1:8476",
                      "num_processes": 3, "process_id": 0}),
}


@pytest.mark.parametrize("case", sorted(ENVS))
def test_detect_env_matches_jax(monkeypatch, case):
    env, want = ENVS[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tdist.detect_env() == jdist.detect_env() == want


class TestMaybeInitialize:
    def test_single_process_is_noop(self):
        with mock.patch.object(dist, "init_process_group") as ini:
            assert tdist.maybe_initialize() is False
        ini.assert_not_called()

    def test_explicit_num_processes_one_is_noop(self):
        with mock.patch.object(dist, "init_process_group") as ini:
            assert tdist.maybe_initialize(coordinator_address="x:1",
                                          num_processes=1,
                                          process_id=0) is False
        ini.assert_not_called()

    @pytest.mark.parametrize("device,backend", [("cpu", "gloo"),
                                                ("cuda", "nccl")])
    def test_env_driven_initialize(self, monkeypatch, device, backend):
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "1")
        monkeypatch.setenv("MASTER_ADDR", "h0")
        with mock.patch.object(dist, "init_process_group") as ini:
            assert tdist.maybe_initialize(device=device) is True
        ini.assert_called_once_with(backend=backend,
                                    init_method="tcp://h0:8476",
                                    world_size=2, rank=1,
                                    timeout=tdist.TIMEOUT)

    def test_explicit_arguments_win(self, monkeypatch):
        monkeypatch.setenv("WORLD_SIZE", "4")
        with mock.patch.object(dist, "init_process_group") as ini:
            assert tdist.maybe_initialize("h1:99", 2, 1, backend="gloo")
        assert ini.call_args.kwargs["init_method"] == "tcp://h1:99"
        assert ini.call_args.kwargs["world_size"] == 2

    def test_idempotent(self, monkeypatch):
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "0")
        up = []
        with mock.patch.object(dist, "init_process_group",
                               side_effect=lambda **kw: up.append(kw)), \
                mock.patch.object(dist, "is_initialized",
                                  side_effect=lambda: bool(up)):
            assert tdist.maybe_initialize(device="cpu") is True
            assert tdist.maybe_initialize(device="cpu") is True
        assert len(up) == 1

    def test_coordinator_without_count_raises(self):
        with pytest.raises(ValueError, match="num_processes"):
            tdist.maybe_initialize(coordinator_address="h0:1")


class TestGlobalGroup:
    def test_single_process(self):
        g = tdist.global_group(device="cpu")
        assert (g.rank, g.size, g.pg) == (0, 1, None)
        with pytest.raises(ValueError, match="launch 2 processes"):
            tdist.global_group(2, "cpu")

    def test_multi_process_divisibility(self):
        """JAX's rule (n divisible by the process count), and the port's
        one process per device (n equal to it)."""
        with mock.patch.object(dist, "is_initialized", return_value=True), \
                mock.patch.object(dist, "get_world_size", return_value=4), \
                mock.patch.object(dist, "get_rank", return_value=2):
            g = tdist.global_group(4, "cpu")
            assert (g.rank, g.size) == (2, 4)
            assert tdist.global_group(device="cpu").size == 4
            with pytest.raises(ValueError, match="divisible"):
                tdist.global_group(6, "cpu")
            with pytest.raises(ValueError, match="one device"):
                tdist.global_group(8, "cpu")

    def test_local_batch_slice_matches_jax(self):
        import jax
        with mock.patch.object(dist, "is_initialized", return_value=True), \
                mock.patch.object(dist, "get_world_size", return_value=4), \
                mock.patch.object(dist, "get_rank", return_value=2), \
                mock.patch.object(jax, "process_count", return_value=4), \
                mock.patch.object(jax, "process_index", return_value=2):
            for n in (4, 8, 12):
                assert tdist.local_batch_slice(n) == \
                    jdist.local_batch_slice(n)
            assert tdist.local_batch_slice(8) == (4, 6)


def test_world_of_one_collectives():
    """Without a process group the collectives are the identity."""
    import numpy as np
    import torch
    g = tdist.Group(0, 1, "cpu")
    tree = {"a": torch.arange(6.0).view(2, 3), "b": [torch.ones(2)]}
    out = g.mean_tree(tree)
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"][0],
                                                            tree["b"][0])
    assert g.sum_array(np.arange(3)).tolist() == [0.0, 1.0, 2.0]
    assert g.gather_objects("x") == ["x"]
    g.barrier()


def test_two_real_processes_keep_one_policy():
    """Two processes through ``maybe_initialize`` (the torch launcher's
    environment) on localhost, gloo, unmocked: after an averaged REINFORCE
    update both hold bitwise the same policy parameters, and the update
    moved them."""
    worker = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, worker],
        env={**os.environ, "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": str(r),
             "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
    digests = {}
    for _, out, _ in outs:
        for line in out.splitlines():
            if line.startswith("POLICY_DIGEST"):
                _, rank, before, after = line.split()
                digests[rank] = (before, after)
    assert set(digests) == {"RANK0", "RANK1"}, outs
    assert digests["RANK0"] == digests["RANK1"]
    assert digests["RANK0"][0] != digests["RANK0"][1]


def test_dryrun_multichip(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    clip_parallel.dryrun_multichip(2, "cpu")
    assert "ok" in capsys.readouterr().out


def test_unreachable_coordinator_raises(monkeypatch):
    """A launch whose coordinator never answers fails; it does not carry
    on as one process."""
    monkeypatch.setattr(tdist, "TIMEOUT", datetime.timedelta(seconds=3))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    with pytest.raises(RuntimeError):
        tdist.maybe_initialize(device="cpu")
    assert not dist.is_initialized()
