"""One intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist worker processes that share the
cores.  PyTorch's default intra-op pool (one thread per core) in each of
them oversubscribes the cores, which slows the port's small-tensor tests
many times over.  A test module imports :func:`one_torch_thread` to take
it as an autouse fixture; the previous thread count comes back after the
module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
