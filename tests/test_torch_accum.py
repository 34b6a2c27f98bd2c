"""Gradient accumulation in the port's training step against the JAX
package, float32 on the CPU at the plain step's test shapes
(tests/test_torch_train.py): 64^2, swin_B widths, every kernel on (their
plain versions on the CPU), ``grad_accum_steps`` = 2 on a batch of 4,
k = 2, stochastic depth off unless a test says otherwise.

Against JAX's ``_make_loss_and_grad`` with the same accumulation (jitted
once), at the plain step's bounds: the total and style losses within 1e-5
relative, each gradient leaf within 1e-4 relative max-abs or SPREAD_FACTOR
times its own spread (the port's gradient when the contents are scaled by
(1 + eps), eps in SPREAD_EPS). The content loss, a distance between two
nearby VGG feature maps, is not defined to 1e-5 in f32: JAX's own
accumulated and full-batch routes give it 1.9e-5 apart at this input (the
total 0 apart), so it is held within 1e-5 or that distance (a JAX forward
of the full batch, jitted once), whichever is larger.

Against the port's own full batch: the accumulated gradients are the mean
of the micro-batches' gradients run alone, bit for bit, and within the
plain step's bound of the full batch's. JAX's test of the same
(tests/test_train.py:test_grad_accum_matches_full_batch: rtol 2e-3, atol
2e-5, element by element) does not hold for the port on the CPU: its BLAS
is not batch-invariant (a (M, 1024) x (1024, 256) product differs in its
rows between M = 4 x 196 and 2 x 196 by up to 8e-5), and the step's f32
gradient moves by ~1e-3 relative under one ulp of its forward (the
plain test's spread), so a tenth of some leaves' elements fall outside
rtol 2e-3 while JAX's two routes, batch-invariant, agree to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.losses.loss import perceptual_loss
from mastermetastyletransfer_tpu.models.master import master_apply
from mastermetastyletransfer_tpu.train import step as jstep
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.train import state as tstate
from mastermetastyletransfer_tpu_torch.train import step as tstep
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    flatten_params, params_from_jax,
)
from tests.torch_jax_init import jax_weights, no_depth_drop
from tests.torch_threads import two_torch_threads  # noqa: F401

SIZE, BATCH, MAX_K, ACCUM, K = 64, 4, 2, 2, 2
SPREAD_FACTOR = 4
SPREAD_EPS = (2.0 ** -20, 2.0 ** -17)


def _jax_full_losses(cfg, pj, vj, content, style):
    """JAX's losses of the whole batch in one forward (no accumulation)."""
    def losses(params, c, s):
        mc, ms = jstep.prepare_batch_for_model(c, s, cfg.data)
        out = master_apply(params, mc, ms, cfg.model, k=K,
                           max_k=cfg.train.max_layers, deterministic=False,
                           rng=jax.random.PRNGKey(7))
        lc, ls, lo = jstep._loss_views(c, s, out, cfg.data)
        return perceptual_loss(vj, lc, ls, lo, cfg.loss,
                               lambda_value=cfg.train.lambda_style)

    out = jax.jit(losses)(pj, jnp.asarray(content), jnp.asarray(style))
    return {n: float(v) for n, v in out.items()}


@pytest.fixture(scope="module")
def accum_case():
    """JAX's accumulated loss and gradients and its full batch's losses;
    the port's accumulated step, on the scaled contents too, and its full
    batch."""
    cfg = jcfg.ExperimentConfig(
        model=no_depth_drop(jcfg.ModelConfig()),
        train=jcfg.TrainConfig(max_layers=MAX_K, grad_accum_steps=ACCUM))
    pj, vj = jax_weights(cfg.model)
    rng = np.random.default_rng(0)
    content, style = (rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
                      for _ in range(2))
    (loss, metrics), grads = jax.jit(jstep._make_loss_and_grad(cfg, vj))(
        pj, jnp.asarray(content), jnp.asarray(style), K,
        jax.random.PRNGKey(7))
    want = (float(loss), {n: float(v) for n, v in metrics.items()},
            flatten_params(jax.device_get(grads)))
    want_full = _jax_full_losses(cfg, pj, vj, content, style)
    ct = tcfg.ExperimentConfig.from_dict(cfg.to_dict())
    ct = ct.replace(model=ct.model.with_kernels())
    params = params_from_jax(pj)
    tstate.create_train_state(params, ct.train)
    vgg = params_from_jax(vj)

    def run(ct, c, s):
        loss, metrics, grads = tstep.make_loss_and_grad(ct, vgg)(
            params, torch.from_numpy(c), torch.from_numpy(s), K,
            torch.Generator().manual_seed(0))
        return float(loss), metrics, grads

    one = ct.replace(train=ct.train.replace(grad_accum_steps=1))
    mb = BATCH // ACCUM
    return dict(
        ct=ct, params=params, vgg=vgg, content=content, style=style,
        want=want, want_full=want_full,
        got=[run(ct, content * (1 + eps), style)
             for eps in (0.0,) + SPREAD_EPS],
        full=run(one, content, style),
        parts=[run(one, content[i * mb:(i + 1) * mb],
                   style[i * mb:(i + 1) * mb]) for i in range(ACCUM)])


def _within_spread(grads, want, moved):
    for key, g in grads.items():
        spread = max(float((m[2][key] - g).abs().max()) for m in moved)
        w = np.asarray(want[key])
        err = float(np.abs(g.numpy() - w).max())
        assert err <= max(1e-4 * float(np.abs(w).max()),
                          SPREAD_FACTOR * spread), (
            key, err / float(np.abs(w).max()), spread)


def test_accum_is_the_mean_of_its_micro_batches(accum_case):
    """What accumulation must compute, bit for bit: the mean of the
    micro-batches' losses and gradients, each run alone."""
    loss, metrics, grads = accum_case["got"][0]
    parts = accum_case["parts"]
    mean = {key: (parts[0][2][key] + parts[1][2][key]) / ACCUM
            for key in grads}
    for key, g in grads.items():
        assert torch.equal(g, mean[key]), key
    for name in ("total", "content", "style"):
        mean = (torch.tensor(parts[0][1][name])
                + torch.tensor(parts[1][1][name])) / ACCUM
        assert metrics[name] == float(mean), name
    assert loss == metrics["total"]


def test_accum_matches_full_batch(accum_case):
    (loss, metrics, grads), *moved = accum_case["got"]
    full_loss, full_metrics, full_grads = accum_case["full"]
    assert abs(loss - full_loss) <= 1e-5 * abs(full_loss)
    for name in ("content", "style"):
        assert abs(metrics[name] - full_metrics[name]) <= \
            1e-5 * abs(full_metrics[name]), name
    assert set(grads) == set(full_grads)
    _within_spread(grads, {k: v.numpy() for k, v in full_grads.items()},
                   moved)


def test_accum_matches_jax(accum_case):
    (loss, metrics, grads), *moved = accum_case["got"]
    want_loss, want_metrics, want_grads = accum_case["want"]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert abs(metrics["style"] - want_metrics["style"]) <= \
        1e-5 * abs(want_metrics["style"])
    w = want_metrics["content"]
    own = abs(accum_case["want_full"]["content"] - w)
    assert abs(metrics["content"] - w) <= max(1e-5 * abs(w), own), (
        abs(metrics["content"] - w) / abs(w), own / abs(w))
    assert set(grads) == {key for key in want_grads
                          if not key.startswith("swin/")}
    _within_spread(grads, want_grads, moved)


def test_accum_draws_masks_micro_batch_after_micro_batch(accum_case):
    """With stochastic depth on, the accumulated step is the mean of the
    micro-batches' steps run in turn on one generator, bit for bit in its
    losses, and leaves the generator where they leave it."""
    ct = accum_case["ct"].replace(model=tcfg.ModelConfig().with_kernels())
    c = torch.from_numpy(accum_case["content"])
    s = torch.from_numpy(accum_case["style"])
    params, vgg = accum_case["params"], accum_case["vgg"]
    g = torch.Generator().manual_seed(4)
    loss, metrics, _ = tstep.make_loss_and_grad(ct, vgg)(params, c, s, K, g)
    one = tstep.make_loss_and_grad(
        ct.replace(train=ct.train.replace(grad_accum_steps=1)), vgg)
    h = torch.Generator().manual_seed(4)
    mb = BATCH // ACCUM
    parts = [one(params, c[i * mb:(i + 1) * mb], s[i * mb:(i + 1) * mb], K,
                 h)[0] for i in range(ACCUM)]
    assert float(loss) == float((parts[0] + parts[1]) / ACCUM)
    assert metrics["total"] == float(loss)
    assert torch.equal(g.get_state(), h.get_state())
    # and the masks did move the loss (stochastic depth is on)
    assert float(loss) != accum_case["got"][0][0]


def test_accum_refuses_a_batch_that_does_not_divide(accum_case):
    c = torch.from_numpy(accum_case["content"][:3])
    with pytest.raises(ValueError, match="does not divide"):
        tstep.make_loss_and_grad(accum_case["ct"], accum_case["vgg"])(
            accum_case["params"], c, c, K, torch.Generator())
