"""One intra-op torch thread for a test module of the port, whose CPU
tests run many small ops one after another: the suite runs one test worker
per core, and with every worker's torch on every core each small op waits
on threads that are not running, so a module slows down tens of times.

A module takes it by importing the fixture:

    from tests.torch_threads import one_torch_thread  # noqa: F401

A module of whole-model training steps takes ``two_torch_threads`` the
same way instead.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads, for a module of whole-model training steps
    (with one test worker per core and every worker's torch on every core,
    the steps slow down a hundredfold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
