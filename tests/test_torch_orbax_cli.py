"""The port's entry points on an experiment directory the JAX package
wrote (its Orbax train-state checkpoints), on the CPU at the command
lines' model (swin_B, the ModelConfig defaults): the evaluation command
line's summary against JAX's on the same directory, within the standing
eval bounds (1e-5 relative, as tests/test_torch_eval.py holds the two
command lines on a .npz export); the parameters it takes from a
checkpoint of another training mode, as JAX's takes them; and the
trainer's ``--resume``, which starts at the step JAX wrote.

JAX writes the checkpoints with its own ``save_checkpoint`` from a train
state of the port's random weights (read into JAX's tree through its
``load_params_npz``), with its step and both of optax's counts set to 3.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.losses import vgg as jvgg
from mastermetastyletransfer_tpu.models import master as jmaster
from mastermetastyletransfer_tpu.train import state as jstate
from mastermetastyletransfer_tpu.utils import checkpoint as jckpt
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.eval import cli as tcli
from mastermetastyletransfer_tpu_torch.losses.vgg import init_vgg19_features
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.train import trainer
from mastermetastyletransfer_tpu_torch.utils import checkpoint as tckpt
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    flatten_params,
)
from tests.torch_threads import two_torch_threads  # noqa: F401

SIZE, STYLE_BATCH, STEP = 64, 2, 3
TOL_REL = 1e-5


def _jax_module(name):
    """A module of the JAX package imported with the persistent
    compilation cache it turns on at import kept off."""
    import importlib

    from mastermetastyletransfer_tpu.utils import cache

    enable = cache.enable_compilation_cache
    cache.enable_compilation_cache = lambda path=None: None
    try:
        return importlib.import_module(name)
    finally:
        cache.enable_compilation_cache = enable


def _zeros_like_init(init):
    def zeros(key, *static):
        shapes = jax.eval_shape(lambda key: init(key, *static), key)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                      shapes)
    return zeros


def _set_counts(opt_state, n: int):
    """optax's state with every count (Adam's, the schedule's) at n."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.asarray(n, v.dtype)
                         if getattr(path[-1], "name", None) == "count"
                         else v), opt_state)


def _jax_exp_dir(root: str, npz: str, mode: str) -> str:
    """An experiment directory as JAX's trainer leaves it: the state of
    the weights in ``npz`` at STEP, in ``mode``."""
    cfg = jcfg.ExperimentConfig(train=jcfg.TrainConfig(mode=mode))
    template = jax.eval_shape(lambda key: jmaster.init_master_model(
        key, cfg.model), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        jnp.asarray, jckpt.load_params_npz(npz, template))
    tx = jstate.make_optimizer(params, cfg.train)
    state, _ = jstate.create_train_state(params, cfg.train, tx)
    state = state.replace(step=jnp.int32(STEP),
                          opt_state=_set_counts(state.opt_state, STEP))
    exp = os.path.join(root, f"jax_{mode}")
    jckpt.save_checkpoint(os.path.join(exp, "checkpoints"), state, STEP,
                          config_json=cfg.to_json())
    return exp


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("orbax_cli"))
    rng = np.random.default_rng(0)
    dirs = {}
    for name, n in (("content", 2), ("style", 3)):
        d = os.path.join(root, name)
        os.makedirs(d)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (90 + 9 * i, 96 - 5 * i, 3),
                                         np.uint8)).save(
                os.path.join(d, f"{name}{i}.bmp"))
        dirs[name] = d
    params = init_master_model(tcfg.ModelConfig(),
                               torch.Generator().manual_seed(5), device="cpu")
    npz, vgg = os.path.join(root, "model.npz"), os.path.join(root, "vgg.npz")
    tckpt.save_params_npz(npz, params)
    tckpt.save_params_npz(vgg, init_vgg19_features(
        torch.Generator().manual_seed(6), device="cpu"))
    exps = {mode: _jax_exp_dir(root, npz, mode)
            for mode in ("plain", "fast_adaptation")}
    return dict(root=root, params=params, vgg=vgg, exps=exps, **dirs)


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _summary(text: str) -> dict:
    return json.loads(text[text.index("{"):])


def test_eval_cli_on_a_jax_exp_dir_matches_jax(setup):
    """Both command lines with ``--checkpoint <JAX exp_dir>/checkpoints``:
    the same grid, each loss statistic within TOL_REL, the weights named
    alike."""
    ckpt = os.path.join(setup["exps"]["plain"], "checkpoints")
    common = ["--content_dir", setup["content"], "--style_dir",
              setup["style"], "--vgg_weights", setup["vgg"],
              "--image_size", str(SIZE), "--style_batch", str(STYLE_BATCH),
              "--compute_similarity", "--checkpoint", ckpt]
    jcli = _jax_module("mastermetastyletransfer_tpu.eval.cli")
    jtrainer = _jax_module("mastermetastyletransfer_tpu.train.trainer")
    from mastermetastyletransfer_tpu import models as jmodels
    with pytest.MonkeyPatch.context() as mp:
        # the random weights are replaced by the checkpoint's: zeros of
        # their tree spare JAX's initialisers
        mp.setattr(jmodels, "init_master_model",
                   _zeros_like_init(jmaster.init_master_model))
        mp.setattr(jtrainer, "init_vgg19_features",
                   _zeros_like_init(jvgg.init_vgg19_features))
        want = _summary(_run(jcli.main, common))
    got = _summary(_run(tcli.main, common + ["--device", "cpu",
                                             "--use_pallas"]))
    assert got.keys() == want.keys()
    assert got["num_pairs"] == want["num_pairs"] == 6
    assert got["weights"] == want["weights"] == ckpt
    for key, w in want.items():
        if key not in ("num_pairs", "weights"):
            scale = abs(want[key.replace("_std", "_mean")])
            assert abs(got[key] - w) <= TOL_REL * max(abs(w), scale), key


def test_eval_takes_another_modes_checkpoint_as_jax_does(setup):
    """A fast-adaptation checkpoint: JAX's evaluation restores it into
    its plain-mode template and takes its parameters; so does the port's,
    bit for bit."""
    ckpt = os.path.join(setup["exps"]["fast_adaptation"], "checkpoints")
    cfg = jcfg.ExperimentConfig()
    template = jax.eval_shape(lambda key: jmaster.init_master_model(
        key, cfg.model), jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   template)
    tx = jstate.make_optimizer(zeros, cfg.train)
    state, _ = jstate.create_train_state(zeros, cfg.train, tx)
    want = flatten_params(jckpt.restore_checkpoint(ckpt, state).params)
    args = tcli.build_argparser().parse_args([
        "--content_dir", "c", "--style_dir", "s", "--checkpoint", ckpt])
    got = flatten_params(tcli.load_params(
        ckpt, tcli.config_from_args(args), torch.device("cpu")))
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.array_equal(v.numpy(), np.asarray(want[k])), k
    port = flatten_params(setup["params"])
    assert all(torch.equal(got[k], port[k]) for k in port)


def test_trainer_resumes_a_jax_exp_dir_at_its_step(setup):
    """``trainer.main --resume`` on the JAX experiment directory: resumed
    from JAX's step 3 (its log says so), one iteration to 4, its
    checkpoint 4 written beside JAX's 3 and read by JAX's
    ``restore_checkpoint``."""
    exp = setup["exps"]["plain"]
    out = _run(trainer.main, [
        "--content_dir", setup["content"], "--style_dir", setup["style"],
        "--exp_dir", exp, "--resume", "--device", "cpu", "--use_pallas",
        "--batch_size", "2", "--crop_to", str(SIZE), "--resize_to", "80",
        "--max_iterations", str(STEP + 1), "--log_every", "1",
        "--save_every", "1000", "--vgg_weights", setup["vgg"]])
    assert f"resumed from step {STEP}" in out
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [STEP + 1]
    ckpt = os.path.join(exp, "checkpoints")
    assert sorted(os.listdir(ckpt)) == [str(STEP), str(STEP + 1),
                                        "config.json"]
    cfg = jcfg.ExperimentConfig()
    template = jax.eval_shape(lambda key: jmaster.init_master_model(
        key, cfg.model), jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   template)
    tx = jstate.make_optimizer(zeros, cfg.train)
    state, _ = jstate.create_train_state(zeros, cfg.train, tx)
    back = jckpt.restore_checkpoint(ckpt, state)
    assert int(back.step) == STEP + 1
    counts = [int(v) for p, v in jax.tree_util.tree_flatten_with_path(
        back.opt_state)[0] if getattr(p[-1], "name", None) == "count"]
    assert counts == [STEP + 1, STEP + 1]
