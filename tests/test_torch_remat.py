"""Remat in the port's training step (``TrainConfig.remat``: the model's
forward under non-reentrant ``torch.utils.checkpoint``), float32 on the CPU
at the plain step's test shapes (tests/test_torch_train.py): 64^2, batch 2,
swin_B widths, k in [1, 2], every kernel on (their plain versions on the
CPU), stochastic depth on, the port's own weights from a seed.

Two steps with remat against two steps without, each from one generator:
equal bit for bit (losses, k, weights, Adam's moments) and the generators
in the same state after. The masks come from an explicit generator, which
``preserve_rng_state`` does not restore, so a recompute that drew from the
caller's generator would draw other masks in the backward and leave the
generator elsewhere: the second step would show it. The reentrant form
sees only tensor arguments, and the parameters come in a dict, so it would
give them no gradient: every trainable leaf gets one here.
"""

import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.losses.vgg import init_vgg19_features
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.train import state as tstate
from mastermetastyletransfer_tpu_torch.train import step as tstep
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    flatten_params, tree_map,
)
from tests.torch_threads import two_torch_threads  # noqa: F401

SIZE, BATCH, MAX_K, STEPS = 64, 2, 2, 2


def _cfg(remat: bool) -> tcfg.ExperimentConfig:
    return tcfg.ExperimentConfig(
        model=tcfg.ModelConfig().with_kernels(),
        train=tcfg.TrainConfig(max_layers=MAX_K, remat=remat))


@pytest.fixture(scope="module")
def remat_case():
    """Weights and images from seeds; two steps each way."""
    g = torch.Generator().manual_seed(0)
    params0 = init_master_model(_cfg(False).model, g, device="cpu")
    vgg = init_vgg19_features(g, device="cpu")
    rng = np.random.default_rng(0)
    content, style = (rng.random((STEPS, BATCH, SIZE, SIZE, 3),
                                 dtype=np.float32) for _ in range(2))
    runs = {}
    for remat in (False, True):
        cfg = _cfg(remat)
        state = tstate.create_train_state(
            tree_map(lambda t: t.detach().clone(), params0), cfg.train)
        step = tstep.make_train_step(cfg, vgg, device="cpu")
        gen = torch.Generator().manual_seed(5)
        metrics = []
        for i in range(STEPS):
            state, m = step(state, content[i], style[i], gen)
            metrics.append(m)
        runs[remat] = (state, metrics, gen)
    return dict(params0=params0, vgg=vgg, content=content, style=style,
                runs=runs)


def test_remat_matches_plain_bit_for_bit(remat_case):
    (sa, ma, ga), (sb, mb, gb) = (remat_case["runs"][r]
                                  for r in (False, True))
    assert ma == mb
    assert torch.equal(ga.get_state(), gb.get_state())
    for (key, a), b in zip(flatten_params(sa.params).items(),
                           flatten_params(sb.params).values()):
        assert torch.equal(a, b), key
    for a, b in zip(sa.opt.mu + sa.opt.nu, sb.opt.mu + sb.opt.nu):
        assert torch.equal(a, b)
    # the steps did train, and drew masks
    before = flatten_params(remat_case["params0"])
    assert not torch.equal(sb.params["decoder"]["conv8"]["kernel"],
                           before["decoder/conv8/kernel"])


def test_remat_gives_every_trainable_leaf_a_gradient(remat_case,
                                                     monkeypatch):
    """The forward runs under non-reentrant checkpointing, and again in
    the backward (two model calls for one step), and every trainable leaf
    gets a non-zero gradient through it."""
    calls, applies = [], []
    checkpoint, master_apply = tstep.checkpoint, tstep.master_apply

    def spy(fn, *args, **kwargs):
        calls.append(kwargs.get("use_reentrant"))
        return checkpoint(fn, *args, **kwargs)

    def count(*args, **kwargs):
        applies.append(torch.is_grad_enabled())
        return master_apply(*args, **kwargs)

    monkeypatch.setattr(tstep, "checkpoint", spy)
    monkeypatch.setattr(tstep, "master_apply", count)
    cfg = _cfg(True)
    params = tree_map(lambda t: t.detach().clone(), remat_case["params0"])
    state = tstate.create_train_state(params, cfg.train)
    _, _, grads = tstep.make_loss_and_grad(cfg, remat_case["vgg"])(
        state.params, torch.from_numpy(remat_case["content"][0]),
        torch.from_numpy(remat_case["style"][0]), 1,
        torch.Generator().manual_seed(0))
    assert calls == [False] and applies == [True, True]
    assert set(grads) == set(state.trainable()) and len(grads) > 50
    zero = [key for key, g in grads.items() if not bool(g.ne(0).any())]
    assert not zero, zero
