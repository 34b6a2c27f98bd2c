"""The port's data-parallel meta step against JAX's
``make_meta_train_step(cfg, vgg, tx, mesh=make_mesh(2))`` on the CPU
(setting and bounds: tests/torch_dp_jax.py)."""

from tests import torch_dp_jax
from tests.torch_threads import two_torch_threads  # noqa: F401


def test_meta_step_matches_jax_sharded():
    torch_dp_jax.check(torch_dp_jax.run("meta", (2,)), 2)
