"""Fast adaptation (``adapt.adapt_to_style``) and the device half of the
data pipeline (``data.device_preprocess_batch``,
``data.repeat_style_to_batch``, ``data.device_preprocess_pair``) in the
port, against the JAX package on the CPU.

``adapt_to_style`` at 64^2, swin_B widths, 2 steps of batch 2 from 4
contents, max_layers 1 (so that both sides run k = 1), stochastic depth
off, weights from JAX through ``params_from_jax``, the port's kernels on
(their plain versions on the CPU), JAX's step jitted once. The content
indices come from the shared numpy seed on both sides. Each side's
training step is wrapped, so that the test sees every step's metrics and
the last step's state.

Bounds, as tests/test_torch_meta.py holds the meta step: Adam's moments
(mu, nu) after the last step per leaf within 1e-4 relative max-abs, or
SPREAD_FACTOR times the leaf's own spread (how far the port's moments move
when the contents are scaled by (1 + eps), eps in SPREAD_EPS), whichever
is larger; mu is a linear mix of the steps' gradients, so a wrong, negated
or other batch's gradient shows there. Each step's losses within 1e-5
relative, or SPREAD_FACTOR times their own spread after the first step
(which runs at the given weights). Every leaf but the style transformer's
encoder's unchanged, bit for bit. The encoder's leaves within
2.5 * n * lr of JAX's is a sanity check only: n Adam updates move each
element by about lr either way, so no gradient can break it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.data import pipeline as jpipe
from mastermetastyletransfer_tpu.train import step as jstep
from mastermetastyletransfer_tpu_torch import adapt as tadapt
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.data import (
    device_preprocess_batch, device_preprocess_pair, repeat_style_to_batch,
)
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    flatten_params, params_from_jax,
)
from tests.torch_jax_init import jax_weights, no_depth_drop
from tests.torch_threads import two_torch_threads  # noqa: F401

SIZE, N_CONTENTS, STEPS, BATCH, LR = 64, 4, 2, 2, 1e-4
SPREAD_FACTOR = 4
SPREAD_EPS = (2.0 ** -20, 2.0 ** -17)
LOSSES = ("total", "content", "style")


def _jax_adapt_to_style():
    """JAX's ``adapt_to_style``, its module imported without the
    persistent compilation cache it turns on at import (which would write
    under the repository)."""
    from mastermetastyletransfer_tpu.utils import cache

    enable = cache.enable_compilation_cache
    cache.enable_compilation_cache = lambda path=None: None
    try:
        from mastermetastyletransfer_tpu.adapt import adapt_to_style as fn
    finally:
        cache.enable_compilation_cache = enable
    return fn


def _recording(make_step, seen):
    """``make_step`` whose steps append each (state, metrics) they return
    to ``seen``, the state only while it is the last."""
    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(*step_args):
            state, metrics = step(*step_args)
            seen.append([state, metrics])
            if len(seen) > 1:
                seen[-2][0] = None
            return state, metrics
        return run
    return make


@pytest.fixture(scope="module")
def adapt_case():
    """JAX's ``adapt_to_style`` (its step jitted once); the port's on the
    same inputs and on the contents scaled by (1 + eps); each side's
    metrics per step and its state after the last."""
    cfg = jcfg.ExperimentConfig(model=no_depth_drop(jcfg.ModelConfig()),
                                train=jcfg.TrainConfig(max_layers=1))
    pj, vj = jax_weights(cfg.model)
    rng = np.random.default_rng(0)
    style = rng.random((SIZE, SIZE, 3), dtype=np.float32)
    contents = rng.random((N_CONTENTS, SIZE, SIZE, 3), dtype=np.float32)
    adapt_jax, seen = _jax_adapt_to_style(), []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "make_train_step",
                   _recording(jstep.make_train_step, seen))
        want = flatten_params(adapt_jax(
            pj, vj, cfg, style, contents, steps=STEPS, lr=LR, batch=BATCH,
            seed=0, log=lambda s: None))
    adam = seen[-1][0].opt_state.inner_states["train"].inner_state[0]
    jax_run = dict(params=want,
                   metrics=[{n: float(m[n]) for n in LOSSES}
                            for _, m in seen],
                   mu=flatten_params(jax.device_get(adam.mu)),
                   nu=flatten_params(jax.device_get(adam.nu)),
                   count=int(adam.count))
    ct = tcfg.ExperimentConfig.from_dict(cfg.to_dict())
    ct = ct.replace(model=ct.model.with_kernels())
    params = params_from_jax(pj)
    runs = []
    for eps in (0.0,) + SPREAD_EPS:
        logged, steps, seen = [], [], []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tadapt, "make_train_step",
                       _recording(tadapt.make_train_step, seen))
            got = tadapt.adapt_to_style(
                params, params_from_jax(vj), ct, style, contents * (1 + eps),
                steps=STEPS, lr=LR, batch=BATCH, seed=0, log=logged.append,
                device="cpu", on_step=lambda i, m: steps.append((i, m)))
        state = seen[-1][0]
        keys = list(state.trainable())
        runs.append(dict(logged=logged, steps=steps, count=state.opt.count,
                         mu=dict(zip(keys, state.opt.mu)),
                         nu=dict(zip(keys, state.opt.nu))))
        if len(runs) == 1:
            runs[0]["params"] = flatten_params(got)
    return dict(pj=pj, params=params, want=want, got=runs[0]["params"],
                jax=jax_run, runs=runs, logged=runs[0]["logged"],
                steps=runs[0]["steps"])


def test_adapt_to_style_matches_jax(adapt_case):
    """Each step's losses; the adapted encoder (sanity bound, see the
    module's docstring), every leaf of it moved."""
    (got_run, *moved), want = adapt_case["runs"], adapt_case["jax"]
    assert len(want["metrics"]) == len(got_run["steps"]) == STEPS
    for i, (_, got) in enumerate(got_run["steps"]):
        for name in LOSSES:
            w = want["metrics"][i][name]
            spread = max(abs(r["steps"][i][1][name] - got[name])
                         for r in moved) if i else 0.0
            err = abs(got[name] - w)
            assert err <= max(1e-5 * abs(w), SPREAD_FACTOR * spread), (
                i, name, err / abs(w), spread / abs(w))
    before = flatten_params(adapt_case["pj"])
    want, got = adapt_case["want"], adapt_case["got"]
    assert set(got) == set(want) == set(before)
    encoder = [key for key in got
               if key.startswith("style_transformer/encoder/")]
    assert len(encoder) > 10
    for key in encoder:
        g = got[key].numpy()
        assert float(np.abs(g - np.asarray(want[key])).max()) <= \
            2.5 * STEPS * LR, key
        assert not np.array_equal(g, before[key]), key


@pytest.mark.parametrize("moment", ["mu", "nu"])
def test_adapt_adam_moments_match_jax(adapt_case, moment):
    """Adam's moments after the last step: the encoder's leaves alone (the
    leaves of JAX's "train" partition), the count, each leaf by the
    module's bound."""
    (got_run, *moved), want = adapt_case["runs"], adapt_case["jax"]
    assert got_run["count"] == want["count"] == STEPS
    got = got_run[moment]
    assert set(got) == set(want[moment])
    assert all(key.startswith("style_transformer/encoder/") for key in got)
    for key, v in got.items():
        spread = max(float((r[moment][key] - v).abs().max()) for r in moved)
        w = np.asarray(want[moment][key])
        err = float(np.abs(v.numpy() - w).max())
        assert err <= max(1e-4 * float(np.abs(w).max()),
                          SPREAD_FACTOR * spread), (
            key, err / float(np.abs(w).max()), spread)


def test_adapt_to_style_changes_only_the_style_encoder(adapt_case):
    before = flatten_params(adapt_case["pj"])
    for key, v in adapt_case["got"].items():
        if key.startswith("style_transformer/encoder/"):
            continue
        assert np.array_equal(v.numpy(), before[key]), key
        assert np.array_equal(np.asarray(adapt_case["want"][key]),
                              before[key]), key
    # the caller's tree is left as it was
    for key, v in flatten_params(adapt_case["params"]).items():
        assert np.array_equal(v.numpy(), before[key]), key


def test_adapt_to_style_logs_and_reports_each_step(adapt_case):
    assert [i for i, _ in adapt_case["steps"]] == list(range(STEPS))
    assert all(m["k"] == 1 and m["lr"] == LR for _, m in adapt_case["steps"])
    assert [line.split("]")[0] for line in adapt_case["logged"]] == [
        f"[adapt {i + 1}/{STEPS}" for i in range(STEPS)]
    last = adapt_case["steps"][-1][1]
    assert f"total={last['total']:.4f}" in adapt_case["logged"][-1]


def _coded_batch(b, h, w):
    """uint8 images whose pixel (y, x) of image i holds (y, x, i)."""
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([np.stack([y, x, np.full_like(y, i)], -1)
                     for i in range(b)]).astype(np.uint8)


@pytest.mark.parametrize("shape,crop", [((3, 20, 24, 3), 16),
                                        ((2, 16, 16, 3), 16),
                                        ((2, 17, 16, 3), 15)])
def test_centre_crop_matches_jax(shape, crop):
    batch = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    want = jpipe.device_preprocess_batch(jnp.asarray(batch), crop,
                                         random_crop=False)
    got = device_preprocess_batch(torch.from_numpy(batch), crop,
                                  random_crop=False)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_random_crop_in_bounds_and_per_image():
    b, h, w, crop = 16, 20, 24, 8
    batch = torch.from_numpy(_coded_batch(b, h, w))
    out = device_preprocess_batch(batch, crop, random_crop=True,
                                  generator=torch.Generator().manual_seed(0))
    assert out.shape == (b, crop, crop, 3)
    codes = (out * 255).round().long()
    oy, ox = codes[:, 0, 0, 0], codes[:, 0, 0, 1]
    assert bool((oy >= 0).all() and (oy <= h - crop).all())
    assert bool((ox >= 0).all() and (ox <= w - crop).all())
    span = torch.arange(crop)
    for i in range(b):
        assert torch.equal(codes[i, :, :, 0], (oy[i] + span)[:, None]
                           .expand(crop, crop))
        assert torch.equal(codes[i, :, :, 1], (ox[i] + span)[None, :]
                           .expand(crop, crop))
        assert bool((codes[i, :, :, 2] == i).all())
    assert len(set(zip(oy.tolist(), ox.tolist()))) > b // 2
    # the generator decides the crops
    again = device_preprocess_batch(batch, crop, random_crop=True,
                                    generator=torch.Generator().manual_seed(0))
    other = device_preprocess_batch(batch, crop, random_crop=True,
                                    generator=torch.Generator().manual_seed(1))
    assert torch.equal(again, out) and not torch.equal(other, out)


def test_device_preprocess_refusals():
    batch = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="larger than"):
        device_preprocess_batch(batch, 9, random_crop=False)
    with pytest.raises(ValueError, match="generator"):
        device_preprocess_batch(batch, 4, random_crop=True)


@pytest.mark.parametrize("mode", ["plain", "meta", "fast_adaptation"])
def test_device_preprocess_pair_follows_the_config(mode):
    """The step's two inputs by ``cfg.data``: without random crops, JAX's
    centre crops and style repeat bit for bit; with them, the contents'
    crops drawn first, the styles' next, but the styles centred in fast
    adaptation; the style repeated to ``batch_size_content``."""
    rng = np.random.default_rng(5)
    content = rng.integers(0, 256, (3, 20, 24, 3), dtype=np.uint8)
    style = _coded_batch(2, 20, 24)
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(crop_to=8, batch_size_content=3,
                             use_random_crop=False),
        train=tcfg.TrainConfig(mode=mode))
    c, s = device_preprocess_pair(cfg, torch.from_numpy(content),
                                  torch.from_numpy(style))
    assert np.array_equal(c.numpy(), np.asarray(jpipe.device_preprocess_batch(
        jnp.asarray(content), 8, random_crop=False)))
    assert np.array_equal(s.numpy(), np.asarray(jpipe.repeat_style_to_batch(
        jpipe.device_preprocess_batch(jnp.asarray(style), 8,
                                      random_crop=False), 3)))

    cfg = cfg.replace(data=cfg.data.replace(use_random_crop=True))
    g = torch.Generator().manual_seed(6)
    c, s = device_preprocess_pair(cfg, torch.from_numpy(content),
                                  torch.from_numpy(style), generator=g)
    g2 = torch.Generator().manual_seed(6)
    assert torch.equal(c, device_preprocess_batch(
        torch.from_numpy(content), 8, random_crop=True, generator=g2))
    random_style = mode != "fast_adaptation"
    assert torch.equal(s, repeat_style_to_batch(device_preprocess_batch(
        torch.from_numpy(style), 8, random_crop=random_style,
        generator=g2), 3))
    assert torch.equal(g.get_state(), g2.get_state())
    if not random_style:
        assert (s[:, 0, 0, :2] * 255).round().long().tolist() == [[6, 8]] * 3


@pytest.mark.parametrize("shape", [(6, 5, 3), (1, 6, 5, 3), (2, 6, 5, 3)])
def test_repeat_style_to_batch_matches_jax(shape):
    style = np.random.default_rng(2).random(shape, dtype=np.float32)
    want = jpipe.repeat_style_to_batch(jnp.asarray(style), 4)
    got = repeat_style_to_batch(torch.from_numpy(style), 4)
    assert got.shape == (4, 6, 5, 3)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(repeat_style_to_batch(style, 4).numpy(),
                          np.asarray(want))


@pytest.mark.parametrize("k", [1, 2])
def test_fast_adaptation_backward_passes(monkeypatch, k):
    """The backward passes one step runs, counted per autograd Function
    (chip_smoke.py's ``train_per_step`` and ``adapt_per_step`` launch
    tables): the plain step runs K8's backward 2k times (the encoder's Key
    block, the decoder's self block), K9's 2k, K10's 5k, K5's 5 and K7's 2;
    fast adaptation the same but for the first iteration's decoder self
    block (its K8 and its K10), whose input is the frozen Swin's features
    and whose weights are frozen, so nothing before it needs a gradient."""
    from mastermetastyletransfer_tpu_torch.losses.vgg import (
        init_vgg19_features,
    )
    from mastermetastyletransfer_tpu_torch.models.master import (
        init_master_model,
    )
    from mastermetastyletransfer_tpu_torch.ops import ln_mlp as lm
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa
    from mastermetastyletransfer_tpu_torch.train import state as tstate
    from mastermetastyletransfer_tpu_torch.train import step as tstep

    functions = {"K8": wa._WindowAttention, "K9": wa._WindowAttentionDual,
                 "K10": lm._LnMlpResidual, "K5": pc._StencilConv,
                 "K7": pc._PhaseAlign}
    calls = {name: 0 for name in functions}

    def counting(name, backward):
        def run(ctx, *grads):
            calls[name] += 1
            return backward(ctx, *grads)
        return staticmethod(run)

    for name, fn in functions.items():
        monkeypatch.setattr(fn, "backward", counting(name, fn.backward))
    g = torch.Generator().manual_seed(0)
    model = tcfg.ModelConfig().with_kernels()
    params0 = init_master_model(model, g, device="cpu")
    vgg = init_vgg19_features(g, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, SIZE, SIZE, 3), dtype=np.float32))
    counted = {}
    for mode in ("plain", "fast_adaptation"):
        cfg = tcfg.ExperimentConfig(model=model,
                                    train=tcfg.TrainConfig(mode=mode))
        state = tstate.create_train_state(params0, cfg.train)
        for name in calls:
            calls[name] = 0
        tstep.make_loss_and_grad(cfg, vgg)(state.params, x, x, k,
                                           torch.Generator().manual_seed(1))
        counted[mode] = dict(calls)
    assert counted["plain"] == {"K8": 2 * k, "K9": 2 * k, "K10": 5 * k,
                                "K5": 5, "K7": 2}
    assert counted["fast_adaptation"] == {
        **counted["plain"], "K8": 2 * k - 1, "K10": 5 * k - 1}
