"""The port's tests run with one PyTorch intra-op thread. Their tensors
are small: one thread runs them as fast alone, and under pytest-xdist
the default (a thread per core, in every worker) oversubscribes the
cores — the six workers' port tests then took 2.4x the wall time and
2.5x the CPU time, and slowed the suite's other tests beside them. A
test module takes the fixture by importing it. Not a test module
(leading underscore)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the test, the previous count restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
