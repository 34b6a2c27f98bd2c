"""The port's data-parallel plain step against JAX's
``make_train_step(cfg, vgg, tx, mesh=make_mesh(n))`` at n = 2 and 4 on the
CPU (setting and bounds: tests/torch_dp_jax.py)."""

import pytest

from tests import torch_dp_jax
from tests.torch_threads import two_torch_threads  # noqa: F401

NS = (2, 4)


@pytest.fixture(scope="module")
def plain():
    return torch_dp_jax.run("plain", NS)


@pytest.mark.parametrize("n", NS)
def test_plain_step_matches_jax_sharded(plain, n):
    torch_dp_jax.check(plain, n)
