"""One intra-op torch thread for a test module of the port, whose CPU
tests run many small ops one after another: the suite runs one test worker
per core, and with every worker's torch on every core each small op waits
on threads that are not running, so a module slows down tens of times.

A module takes it by importing the fixture:

    from tests.torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
