"""The JAX package's Orbax train-state checkpoints and the port's, both
ways, in fast adaptation (the style encoder alone trains)
(tests/torch_orbax_cases.py): JAX's two steps read by the port's
``restore_checkpoint`` in both of Orbax's layouts bit for bit against
JAX's own ``restore_checkpoint`` (every leaf, Adam's and the schedule's
counts, the step); the port's checkpoint after two port steps read by
JAX bit for bit; one step of each from the same restored state within
the standing bounds."""

import pytest

from tests import torch_orbax_cases as cases
from tests.torch_orbax_cases import (  # noqa: F401  (the tests of a mode)
    test_jax_restores_port_checkpoint_bit_for_bit,
    test_one_step_from_the_restored_state_matches_jax,
    test_port_restores_jax_checkpoint_bit_for_bit,
)
from tests.torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return cases.run_mode("fast_adaptation",
                          str(tmp_path_factory.mktemp("fast_adaptation")))
