"""Fixtures shared by the port's CPU tests (tests/test_torch_*.py).

A test module takes one by importing it by name, e.g.
``from torch_port_fixtures import two_torch_threads  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The suite runs several workers on one machine; torch's default of
    one thread per core oversubscribes it and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
