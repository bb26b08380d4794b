"""The port tests' thread fixture, in a module that imports no JAX, so that
test files which import no JAX can use it too."""

import pytest
import torch


@pytest.fixture(autouse=True)
def two_torch_threads():
    """Two intra-op threads per test: the suite runs in parallel workers,
    and torch's default of one thread per core in every worker
    oversubscribes the CPU several times over.  Test modules import this
    fixture to use it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
