"""The port's plain training step against the JAX package, float32 on the
CPU: the configuration, the VGG19 perceptual loss, the whole step's loss
and gradients, Adam and the learning-rate schedule, stochastic depth, and
the refusal of the evaluation kernels under autograd.

The whole step runs the port with every kernel on (here, on the CPU, the
plain versions through the autograd Functions of K5, K7, K8, K9 and K10)
against JAX's ``_make_loss_and_grad`` with its kernels off (its own
tests/test_pallas_vjp.py holds the JAX kernels to that route), from the
same weights and images, at fixed k in {1, 2} with the stochastic-depth
probabilities at 0 (the two frameworks draw different masks). Bounds: the
loss within 1e-5 relative; every gradient leaf within 1e-4 relative
max-abs (max|a - b| / max|b|), or within SPREAD_FACTOR times the leaf's
own spread, whichever is larger. The spread is how far the port's own
gradient moves when the content images are scaled by (1 + eps), eps in
{2^-20, 2^-17}, the size of the two frameworks' forward differences (the
models' outputs agree to ~2.5e-5 relative, tests/test_torch_models.py).
The loss is piecewise smooth (ReLUs, max pools), and at this input its f32
gradient is not defined to 1e-4: JAX's own two routes to it (the masked
scan of ``_make_loss_and_grad`` and an unrolled static k) differ by up to
5.3e-4 at k = 1 and 1.1e-4 at k = 2, and the port lies as close to the
scan as the unrolled route does (median leaf 1.7e-4 at k = 1, 3.5e-6 at
k = 2). The keys' biases have an exactly zero gradient (a softmax does not
see a shift of every key); both sides are rounding noise there.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.losses import loss as jloss
from mastermetastyletransfer_tpu.losses import vgg as jvgg
from mastermetastyletransfer_tpu.models import master as jmaster
from mastermetastyletransfer_tpu.train import schedule as jschedule
from mastermetastyletransfer_tpu.train import step as jstep
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.config import AttentionConfig
from mastermetastyletransfer_tpu_torch.losses import loss as tloss
from mastermetastyletransfer_tpu_torch.models import style_transformer as tst
from mastermetastyletransfer_tpu_torch.ops import block_pair as bpr
from mastermetastyletransfer_tpu_torch.ops import ln_mlp as lm
from mastermetastyletransfer_tpu_torch.ops import mlp as tmlp
from mastermetastyletransfer_tpu_torch.ops import patch_embed as tpe
from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc
from mastermetastyletransfer_tpu_torch.ops import style_block as sb
from mastermetastyletransfer_tpu_torch.ops import window_attention as wa
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from mastermetastyletransfer_tpu_torch.train import schedule as tschedule
from mastermetastyletransfer_tpu_torch.train import state as tstate
from mastermetastyletransfer_tpu_torch.train import step as tstep
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    flatten_params, params_from_jax,
)
from tests.torch_threads import two_torch_threads  # noqa: F401

SIZE, BATCH, MAX_K = 64, 2, 2
SPREAD_FACTOR = 4
SPREAD_EPS = (2.0 ** -20, 2.0 ** -17)


def _jax_cfg() -> jcfg.ExperimentConfig:
    m = jcfg.ModelConfig()
    m = m.replace(
        swin=m.swin.replace(stochastic_depth_probs=(0.0, 0.0, 0.0, 0.0)),
        transformer=m.transformer.replace(encoder_stochastic_depth_prob=0.0,
                                          decoder_stochastic_depth_prob=0.0))
    return jcfg.ExperimentConfig(model=m,
                                 train=jcfg.TrainConfig(max_layers=MAX_K))


def test_experiment_config_from_jax_json():
    cj = jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(compute_dtype="bfloat16"),
        loss=jcfg.LossConfig(replicate_similarity_bug=True),
        data=jcfg.DataConfig(crop_to=128,
                             use_imagenet_normalization_for_loss=False),
        train=jcfg.TrainConfig(max_layers=3, warmup_iterations=10))
    ct = tcfg.ExperimentConfig.from_json(cj.to_json())
    assert ct.model.compute_dtype == "bfloat16"
    assert ct.model.swin.stochastic_depth_probs == \
        cj.model.swin.stochastic_depth_probs
    assert ct.model.transformer.encoder_stochastic_depth_prob == 0.1
    assert ct.loss.replicate_similarity_bug
    assert ct.data.crop_to == 128
    assert not ct.data.use_imagenet_normalization_for_loss
    assert ct.train.max_layers == 3 and ct.train.warmup_iterations == 10
    assert ct.train.freeze_encoder


@pytest.fixture(scope="module")
def step_case():
    """Shared weights (model and VGG, carried from JAX), images, and JAX's
    loss and gradients at k = 1 and 2."""
    cfg = _jax_cfg()
    pj = jax.device_get(jmaster.init_master_model(jax.random.PRNGKey(0),
                                                  cfg.model))
    vj = jax.device_get(jvgg.init_vgg19_features(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    content, style = (rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
                      for _ in range(2))
    grad_fn = jax.jit(jstep._make_loss_and_grad(cfg, vj))
    want = {}
    for k in (1, 2):
        (loss, metrics), grads = grad_fn(pj, jnp.asarray(content),
                                         jnp.asarray(style), k,
                                         jax.random.PRNGKey(3))
        want[k] = (float(loss), jax.device_get(metrics),
                   flatten_params(jax.device_get(grads)))
    return cfg, pj, vj, content, style, want


def test_perceptual_loss_matches_jax(step_case):
    _, _, vj, content, style, _ = step_case
    out = np.random.default_rng(1).random(content.shape, dtype=np.float32)
    lcfg = jcfg.LossConfig()
    want = jloss.perceptual_loss(vj, *map(jnp.asarray, (content, style, out)),
                                 lcfg, lambda_value=10.0,
                                 compute_similarity=True)
    got = tloss.perceptual_loss(
        params_from_jax(vj), *map(torch.from_numpy, (content, style, out)),
        tcfg.LossConfig.from_dict(lcfg.to_dict()), lambda_value=10.0,
        compute_similarity=True)
    for name in ("content", "style", "total", "similarity"):
        w = float(want[name])
        assert abs(float(got[name]) - w) <= 1e-5 * abs(w), name


@pytest.mark.parametrize("k", [1, 2])
def test_train_step_matches_jax(step_case, k):
    """The whole step's loss and the gradient of every trainable leaf, the
    port with every kernel on against JAX's _make_loss_and_grad."""
    cfg, pj, vj, content, style, want = step_case
    ct = tcfg.ExperimentConfig.from_dict(cfg.to_dict())
    ct = ct.replace(model=ct.model.with_kernels())
    params = params_from_jax(pj)
    state = tstate.create_train_state(params, ct.train)
    loss_and_grad = tstep.make_loss_and_grad(ct, params_from_jax(vj))
    before = (dict(wa.LAUNCHES), dict(lm.LAUNCHES), dict(pc.LAUNCHES))
    loss, metrics, grads = loss_and_grad(
        state.params, torch.from_numpy(content), torch.from_numpy(style), k,
        torch.Generator().manual_seed(0))
    assert (dict(wa.LAUNCHES), dict(lm.LAUNCHES), dict(pc.LAUNCHES)) == \
        before   # the CPU runs the plain versions, and launches nothing
    want_loss, want_metrics, want_grads = want[k]
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    for name in ("content", "style"):
        w = float(want_metrics[name])
        assert abs(metrics[name] - w) <= 1e-5 * abs(w), name
    assert set(grads) == {key for key in want_grads
                          if not key.startswith("swin/")}
    # The gradient's own spread: the same step on the content scaled by
    # (1 + eps), |eps| up to the size of the two frameworks' forward
    # differences.
    spread = {key: 0.0 for key in grads}
    for eps in SPREAD_EPS:
        _, _, moved = loss_and_grad(
            state.params, torch.from_numpy(content) * (1 + eps),
            torch.from_numpy(style), k, torch.Generator().manual_seed(0))
        for key in grads:
            spread[key] = max(spread[key], float(
                (moved[key] - grads[key]).abs().max()))
    for key, got in grads.items():
        w = np.asarray(want_grads[key])
        err = float(np.abs(got.numpy() - w).max())
        assert err <= max(1e-4 * float(np.abs(w).max()),
                          SPREAD_FACTOR * spread[key]), (
            key, err / float(np.abs(w).max()), spread[key])


def test_bf16_train_step_within_jax_noise(step_case):
    """F7: the bf16 step, the port with every kernel on (their plain
    versions through the autograd Functions of K5, K7, K8, K9 and K10)
    against JAX's bf16 ``_make_loss_and_grad``, at k = 1 from the f32
    case's weights and images. Criterion: chip_smoke.py's bf16 noise ratio
    per gradient group (``chip_smoke.param_group``), mean |port bf16 - JAX
    f32| over mean |JAX bf16 - JAX f32|, at most TOL_BF16_NOISE (1.5): the
    two bf16 routes round independently through the whole model and the
    loss, so the port is held to JAX's own bf16 distance from f32, not to
    JAX's bf16 bits. The loss within the same ratio."""
    import chip_smoke

    cfg, pj, vj, content, style, want = step_case
    cb = cfg.replace(model=cfg.model.replace(compute_dtype="bfloat16"))
    (jax_loss, _), jax_grads = jax.jit(jstep._make_loss_and_grad(cb, vj))(
        pj, jnp.asarray(content), jnp.asarray(style), 1,
        jax.random.PRNGKey(3))
    jax_grads = flatten_params(jax.device_get(jax_grads))
    ct = tcfg.ExperimentConfig.from_dict(cb.to_dict())
    ct = ct.replace(model=ct.model.with_kernels())
    assert ct.model.compute_dtype == "bfloat16"
    params = params_from_jax(pj)
    state = tstate.create_train_state(params, ct.train)
    loss, _, grads = tstep.make_loss_and_grad(ct, params_from_jax(vj))(
        state.params, torch.from_numpy(content), torch.from_numpy(style), 1,
        torch.Generator().manual_seed(0))
    ref_loss, _, ref = want[1]
    ratios = {}
    for grp in sorted({chip_smoke.param_group(key) for key in grads}):
        keys = [key for key in grads if chip_smoke.param_group(key) == grp]
        port = sum(float(np.abs(grads[key].float().numpy()
                                - np.asarray(ref[key])).sum())
                   for key in keys)
        own = sum(float(np.abs(np.asarray(jax_grads[key], np.float32)
                               - np.asarray(ref[key])).sum())
                  for key in keys)
        ratios[grp] = port / own
    loss_ratio = abs(float(loss) - ref_loss) / abs(float(jax_loss) - ref_loss)
    print(f"bf16 step: loss {float(loss)} (JAX bf16 {float(jax_loss)}, f32 "
          f"{ref_loss}), loss ratio {loss_ratio:.4g}; group ratios "
          f"{ {g: round(r, 4) for g, r in ratios.items()} }")
    assert len(ratios) > 10
    assert max(ratios.values()) <= chip_smoke.TOL_BF16_NOISE, ratios
    assert loss_ratio <= chip_smoke.TOL_BF16_NOISE, loss_ratio


@pytest.mark.parametrize("mode", ["plain", "fast_adaptation"])
def test_training_after_a_served_call(step_case, mode):
    """The constants the port caches (shift masks, gather indices, a frozen
    decoder's composed kernels) that a served call first builds under
    inference_mode serve a later training step's autograd in the same
    process; fast adaptation freezes the decoder, whose composed kernels
    then come from the cache."""
    from mastermetastyletransfer_tpu_torch.models import master as tmaster
    from mastermetastyletransfer_tpu_torch.ops import attention as tattn
    from mastermetastyletransfer_tpu_torch.ops import conv as tconv

    cfg, pj, vj, content, style, _ = step_case
    ct = tcfg.ExperimentConfig.from_dict(cfg.to_dict())
    ct = ct.replace(model=ct.model.with_kernels(),
                    train=ct.train.replace(mode=mode))
    for cached in (tattn._shift_mask, tattn._valid_mask, tconv._edge_index,
                   pc._border_index):
        cached.cache_clear()
    params = params_from_jax(pj)
    tmaster.make_stylize_fn(ct.model, k=1, device="cpu")(params, content,
                                                         style)
    state = tstate.create_train_state(params, ct.train)
    loss, _, grads = tstep.make_loss_and_grad(ct, params_from_jax(vj))(
        state.params, torch.from_numpy(content), torch.from_numpy(style), 1,
        torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and grads
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_adam_and_schedule_match_optax():
    """Three Adam steps on identical gradients, with a warmup and a decay
    inside them, against optax.adam with the JAX package's schedule."""
    cfg = jcfg.TrainConfig(warmup_iterations=2, lr_decay_every=2,
                           lr_decay_rate=0.3, lr_decay_until=2e-5)
    sched_j = jschedule.make_lr_schedule(cfg)
    sched_t = tschedule.make_lr_schedule(
        tcfg.TrainConfig.from_dict(cfg.to_dict()))
    for s in range(12):
        assert abs(sched_t(s) - float(sched_j(s))) <= 1e-7 * cfg.inner_lr
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    tx = optax.adam(learning_rate=sched_j)
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    opt = tx.init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    adam = tstate.Adam([pt["a"], pt["b"]], sched_t)
    for g in grads:
        upd, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt, pj)
        pj = optax.apply_updates(pj, upd)
        adam.step([torch.from_numpy(g["a"]), torch.from_numpy(g["b"])])
        for k in p0:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=0, atol=1e-7)


def test_trainable_labels_freeze_the_swin():
    params = {"swin": {"w": torch.ones(2)}, "decoder": {"w": torch.ones(2)},
              "style_transformer": {"encoder": {"w": torch.ones(2)},
                                    "decoder": {"w": torch.ones(2)}}}
    state = tstate.create_train_state(params, tcfg.TrainConfig())
    assert set(state.trainable()) == {"decoder/w",
                                      "style_transformer/encoder/w",
                                      "style_transformer/decoder/w"}
    fast = tstate.create_train_state(
        params, tcfg.TrainConfig(mode="fast_adaptation"))
    assert set(fast.trainable()) == {"style_transformer/encoder/w"}


def test_stochastic_depth_keep_rate_and_scaling():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(20000, 3)
    y = tmlp.stochastic_depth(x, 0.25, deterministic=False, generator=g)
    kept = y[:, 0] != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert (y[~kept] == 0).all()
    assert torch.equal(y[:, 0], y[:, 2])          # one draw per sample
    assert tmlp.stochastic_depth(x, 0.25, deterministic=True) is x
    assert tmlp.stochastic_depth(x, 0.0, deterministic=False,
                                 generator=g) is x


def test_stochastic_depth_masks_same_with_kernels_on_and_off():
    """The same generator seed gives the same masks on the kernel route and
    the plain route: a style-transformer iteration at p = 0.5 agrees."""
    cfg = tcfg.StyleTransformerConfig(encoder_stochastic_depth_prob=0.5,
                                      decoder_stochastic_depth_prob=0.5)
    params = tst.init_style_transformer(torch.Generator().manual_seed(0),
                                        cfg)
    x = torch.randn((2, 9, 9, 256), generator=torch.Generator().manual_seed(1))
    outs = [tst.style_transformer_apply(
        params, x, x, cfg.replace(use_pallas=on), k=2, deterministic=False,
        generator=torch.Generator().manual_seed(7)) for on in (False, True)]
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-4
    # and a different seed gives different masks
    other = tst.style_transformer_apply(
        params, x, x, cfg.replace(use_pallas=True), k=2, deterministic=False,
        generator=torch.Generator().manual_seed(8))
    assert (other - outs[1]).abs().max().item() > 1e-2


class _StubLib:
    """Stands in for a kernel library: records each entry it is asked to
    launch and launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 1 if name.endswith("smem_bytes") else 0
        return entry


def _eval_cases():
    """A call of each evaluation-only kernel's wrapper on inputs of which
    one requires grad: K1, K2, K3, K4, K6 with pad columns, K11 and K13."""
    g = torch.Generator().manual_seed(0)
    acfg = AttentionConfig(dim=128, num_heads=4, window_size=(7, 7),
                           shift_size=(3, 3))
    block = tst.init_style_swin_block(g, acfg, use_norm=True,
                                      exclude_mlp=False, mlp_ratio=4.0)
    x = torch.randn((1, 7, 7, 128), requires_grad=True)
    xw = torch.randn((1, 1, 49, 128), requires_grad=True)
    w = wb.block_weights(block, (7, 7), torch.float32, True)
    mlp = {"fc1": block["mlp"]["fc1"], "fc2": block["mlp"]["fc2"]}
    ew = sb.encoder_weights(block["attn"], mlp, mlp, None, (7, 7),
                            torch.float32)
    dw = sb.decoder_tail_weights(
        {"wv_scale": block["attn"]["wv"], "wv_shift": block["attn"]["wv"],
         "proj": block["attn"]["proj"],
         "rel_bias_table": block["attn"]["rel_bias_table"]}, mlp, (7, 7),
        torch.float32)
    pp = torch.randn((1, 4, 5, 128), requires_grad=True)
    pk = torch.randn((2, 2, 128, 16 * 32))
    table = pc.GroupTable(((0, 0),) * 16, (1,) * 16, 1)
    return {
        "window_block_rows": lambda: wb.window_block_rows(
            x, w, heads=4, window=(7, 7), shift=(0, 0)),
        "window_block_windows": lambda: wb.window_block_windows(
            xw, w, heads=4),
        "encoder_scale_shift": lambda: sb.encoder_scale_shift(
            xw, xw, xw, ew, heads=4),
        "decoder_tail": lambda: sb.decoder_tail(xw, xw, xw, xw, xw, dw,
                                                heads=4),
        "stencil_phase2_conv_padcols": lambda: pc.stencil_phase2_conv_padcols(
            pp, pk, torch.zeros(16 * 32), table,
            (((0, 0),) * 4, ((2, 3),) * 4)),
        "window_block_pair_rows": lambda: bpr.window_block_pair_rows(
            torch.randn((1, 14, 14, 128), requires_grad=True), w, w,
            heads=4, window=(7, 7), shift=(3, 3)),
        "patch_embed": lambda: tpe.patch_embed(
            torch.randn((1, 8, 8, 3)),
            torch.randn((4, 4, 3, 128), requires_grad=True),
            torch.zeros(128)),
    }


@pytest.mark.parametrize("entry", ["window_block_rows", "window_block_windows",
                                   "encoder_scale_shift", "decoder_tail",
                                   "stencil_phase2_conv_padcols",
                                   "window_block_pair_rows", "patch_embed"])
def test_eval_kernels_refuse_autograd(monkeypatch, entry):
    """F4: an evaluation-only kernel's CUDA branch (its wrapper made to see a
    card, its library a stub) raises where autograd would record it, and
    launches nothing; under no_grad it launches."""
    lib = _StubLib()
    for mod in (wb, sb, pc, bpr, tpe):
        monkeypatch.setattr(mod, "_on_cuda", lambda t: True)
        monkeypatch.setattr(mod, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    call = _eval_cases()[entry]
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert not [c for c in lib.calls if not c.endswith("smem_bytes")]
    with torch.no_grad():
        call()
    assert f"mmst_{entry}" in lib.calls


@pytest.mark.parametrize("entry", ["stencil_phase_conv", "phase_align",
                                   "stencil_phase2_rgb",
                                   "stencil_phase2_rgb128"])
def test_decoder_kernels_carry_gradients_on_the_card_branch(monkeypatch,
                                                            entry):
    """F4: K5, K7 and K12 launch their kernel under autograd too (their
    wrapper made to see a card, the library a stub), and their output is in
    the graph: the gradient reaches the input, shaped as it."""
    lib = _StubLib()
    monkeypatch.setattr(pc, "_on_cuda", lambda t: True)
    monkeypatch.setattr(pc, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    if entry == "phase_align":
        x = torch.randn((1, 5, 6, 128), requires_grad=True)
        y = pc.phase_align(x, 32)
    elif entry.startswith("stencil_phase2_rgb"):
        x = torch.randn((1, 5, 6, 128), requires_grad=True)
        n = 48 if entry == "stencil_phase2_rgb" else 128
        y = getattr(pc, entry)(x, torch.randn((2, 2, 128, n)),
                               torch.zeros(n), (0, 1, 1, 1))
    else:
        x = torch.randn((1, 6, 7, 128), requires_grad=True)
        table = pc.GroupTable(((0, 0), (0, 1), (1, 0), (1, 1)), (15,) * 4, 1)
        y = pc.stencil_phase_conv(x, torch.randn((2, 2, 128, 128)),
                                  torch.zeros(128), table)
    assert f"mmst_{entry}" in lib.calls and y.grad_fn is not None
    (gx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert gx.shape == x.shape
