"""The benchmark's own tests: one torch thread, and the ``cuda`` marker for
the tests that need a card (they skip without one, decided in a fixture)."""

import os

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA GPU (skips without one)")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="session")
def run_tmpdir(tmp_path_factory):
    """A run writes only under ``TMPDIR`` and refuses to start without one:
    the tests' runs get a directory of their own where none is set."""
    if os.environ.get("TMPDIR"):
        yield
        return
    os.environ["TMPDIR"] = str(tmp_path_factory.mktemp("run"))
    yield
    del os.environ["TMPDIR"]
