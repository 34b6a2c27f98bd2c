"""Test config: force CPU backend with 8 virtual devices so multi-chip
sharding tests (jax.sharding.Mesh over axis "data") run anywhere."""

import os

# Force CPU for unit tests; 8 virtual devices emulate a multi-chip mesh.
# NOTE: the session's TPU plugin overrides the JAX_PLATFORMS env var, so the
# jax.config update below (before any backend initialization) is what counts.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402  (import after env setup)

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
        "skips without one")
