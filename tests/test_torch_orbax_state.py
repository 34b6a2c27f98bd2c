"""The JAX package's Orbax train-state checkpoints and the port's, both
ways, in plain training (the Swin frozen) (tests/torch_orbax_cases.py):
JAX's two steps read by the port's ``restore_checkpoint`` in both of
Orbax's layouts bit for bit against JAX's own ``restore_checkpoint``
(every leaf, Adam's and the schedule's counts, the step); the port's
checkpoint after two port steps read by JAX bit for bit; one step of
each from the same restored state within the standing bounds. Also the
errors of a checkpoint that is not the state's, on a port-written one."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.train import state as tstate
from mastermetastyletransfer_tpu_torch.utils import checkpoint as tckpt
from tests import torch_orbax_cases as cases
from tests.torch_orbax_cases import (  # noqa: F401  (the tests of a mode)
    test_jax_restores_port_checkpoint_bit_for_bit,
    test_one_step_from_the_restored_state_matches_jax,
    test_port_restores_jax_checkpoint_bit_for_bit,
)
from tests.torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return cases.run_mode("plain",
                          str(tmp_path_factory.mktemp("plain")))


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    """A plain-mode state of the port at step 2, written by the port."""
    ct = cases.port_config(cases.jax_config("plain"))
    state = tstate.create_train_state(init_master_model(
        ct.model, torch.Generator().manual_seed(0), device="cpu"), ct.train)
    state.step = state.opt.count = 2
    path = str(tmp_path_factory.mktemp("refuse"))
    tckpt.save_checkpoint(path, state, 2)
    return dict(ct=ct, path=path)


def _copy(plain_run, tmp_path) -> str:
    path = str(tmp_path / "ckpt")
    shutil.copytree(plain_run["path"], path)
    return path


def _state(plain_run, **train):
    ct = plain_run["ct"]
    if train:
        ct = ct.replace(train=ct.train.replace(**train))
    return tstate.create_train_state(init_master_model(
        ct.model, torch.Generator().manual_seed(1), device="cpu"), ct.train)


def test_counts_that_differ_are_refused(plain_run, tmp_path):
    path = _copy(plain_run, tmp_path)
    name = ".".join(map(str, cases.COUNTS[2]))
    with open(os.path.join(path, "2", name, "0"), "wb") as f:
        f.write(np.int32(5).tobytes())
    with pytest.raises(ValueError, match="Adam's count 2 and the "
                                         "schedule's count 5 differ"):
        tckpt.restore_checkpoint(path, _state(plain_run))


def test_another_modes_trainable_leaves_are_refused(plain_run, tmp_path):
    with pytest.raises(KeyError, match="trainable leaves"):
        tckpt.restore_checkpoint(_copy(plain_run, tmp_path),
                                 _state(plain_run, mode="fast_adaptation"))


def test_missing_leaves_are_refused(plain_run, tmp_path):
    path = _copy(plain_run, tmp_path)
    meta_path = os.path.join(path, "2", "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    gone = next(k for k in meta["tree_metadata"] if "conv0" in k)
    del meta["tree_metadata"][gone]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(KeyError, match="1 missing"):
        tckpt.restore_checkpoint(path, _state(plain_run))


def test_other_shapes_are_refused(plain_run, tmp_path):
    ct = plain_run["ct"]
    wide = ct.model.replace(decoder=ct.model.decoder.replace(channel_dim=64),
                            transformer=ct.model.transformer.replace(
                                encoder_dim=64, decoder_dim=64))
    state = tstate.create_train_state(init_master_model(
        wide, torch.Generator().manual_seed(1), device="cpu"), ct.train)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(_copy(plain_run, tmp_path), state)


def test_no_checkpoint_is_file_not_found(plain_run, tmp_path):
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), _state(plain_run))
    os.makedirs(tmp_path / "empty" / "3")
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "empty"), _state(plain_run))
