"""The port's Reptile meta step against the JAX package, float32 on the
CPU at the plain step's test shapes (tests/test_torch_train.py): 64^2,
batch 2, swin_B widths, k in [1, 2], 2 inner updates, outer_lr 0.5; and
the training fields of the configuration.

Weights come from JAX through ``params_from_jax``; images from numpy with a
seed. The port runs every kernel on (their plain versions on the CPU)
against JAX's ``make_meta_train_step``, jitted once, with the
stochastic-depth probabilities at 0 (the two frameworks draw different
masks) and JAX's k draws replayed as ``ks``.

Bounds. Adam's moments (mu, nu) per leaf as the plain step's gradients:
1e-4 relative max-abs, or SPREAD_FACTOR times the leaf's own spread,
whichever is larger; the spread is how far the port's own moments move
when the contents are scaled by (1 + eps), eps in SPREAD_EPS; they are
the check of the gradients. theta' per leaf within 2.5 * outer_lr * n *
lr (each Adam update is about lr per element, and a near-zero gradient
may take either sign: JAX's own
tests/test_train.py:test_remat_matches_plain bounds one update so) is a
sanity check only: no gradient moves either side further than that. The
last inner step's losses within 1e-5 relative, or SPREAD_FACTOR times
their own spread: that step runs on omega after one update, whose sign
choices at near-zero gradients move it by 2 lr per element, and the
losses of the second batch see them (the contents scaled by 1 + 2^-20
move the last total loss by 5.2e-5 relative, and JAX's omega gives the
port's forward a loss 1.1e-5 from the port's; JAX's loss at the port's
omega is 3.4e-7 from the port's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.train import state as jstate
from mastermetastyletransfer_tpu.train import step as jstep
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch import train as ttrain
from mastermetastyletransfer_tpu_torch.train import state as tstate
from mastermetastyletransfer_tpu_torch.train import step as tstep
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    flatten_params, params_from_jax, tree_map,
)
from tests.torch_jax_init import jax_weights, no_depth_drop
from tests.torch_threads import two_torch_threads  # noqa: F401

SIZE, BATCH, MAX_K, N_INNER, OUTER_LR = 64, 2, 2, 2, 0.5
SPREAD_FACTOR = 4
SPREAD_EPS = (2.0 ** -20, 2.0 ** -17)
LOSSES = ("total", "content", "style")


def _jax_cfg() -> jcfg.ExperimentConfig:
    return jcfg.ExperimentConfig(
        model=no_depth_drop(jcfg.ModelConfig()),
        train=jcfg.TrainConfig(mode="meta", max_layers=MAX_K,
                               num_inner_updates=N_INNER, outer_lr=OUTER_LR))


def _port_cfg(cfg: jcfg.ExperimentConfig) -> tcfg.ExperimentConfig:
    ct = tcfg.ExperimentConfig.from_dict(cfg.to_dict())
    return ct.replace(model=ct.model.with_kernels())


def _port_meta(ct, pj, vj, contents, style, seed=0, ks=None):
    state = tstate.create_train_state(params_from_jax(pj), ct.train)
    step = tstep.make_meta_train_step(ct, params_from_jax(vj), device="cpu")
    generator = torch.Generator().manual_seed(seed)
    state, metrics = step(state, contents, style, generator, ks=ks)
    return state, metrics, generator


@pytest.fixture(scope="module")
def meta_case():
    """JAX's meta step (one jit call) and its k draws; the port's step on
    the same inputs and on the contents scaled by (1 + eps)."""
    cfg = _jax_cfg()
    pj, vj = jax_weights(cfg.model)
    rng = np.random.default_rng(0)
    contents = rng.random((N_INNER, BATCH, SIZE, SIZE, 3), dtype=np.float32)
    style = rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    tx = jstate.make_optimizer(pj, cfg.train)
    state, tx = jstate.create_train_state(pj, cfg.train, tx)
    key = jax.random.PRNGKey(7)
    new, metrics = jstep.make_meta_train_step(cfg, vj, tx)(
        state, jnp.asarray(contents), jnp.asarray(style), key)
    # JAX's draws: fold_in(rng, step), split into the inner steps, each
    # split into (k, model), k = randint(1, max_layers + 1).
    ks = [int(jax.random.randint(jax.random.split(r)[0], (), 1, MAX_K + 1))
          for r in jax.random.split(jax.random.fold_in(key, 0), N_INNER)]
    adam = new.opt_state.inner_states["train"].inner_state[0]
    want = dict(params=flatten_params(jax.device_get(new.params)),
                mu=flatten_params(jax.device_get(adam.mu)),
                nu=flatten_params(jax.device_get(adam.nu)),
                count=int(adam.count), step=int(new.step),
                metrics={n: float(metrics[n]) for n in LOSSES})
    ct = _port_cfg(cfg)
    runs = [_port_meta(ct, pj, vj, contents * (1 + eps), style, ks=ks)
            for eps in (0.0,) + SPREAD_EPS]
    return dict(cfg=cfg, ct=ct, pj=pj, vj=vj, contents=contents,
                style=style, ks=ks, want=want, runs=runs)


def _moments(state):
    keys = list(state.trainable())
    return ({key: m for key, m in zip(keys, state.opt.mu)},
            {key: v for key, v in zip(keys, state.opt.nu)})


def test_meta_last_inner_losses_match_jax(meta_case):
    (_, got, _), *moved = meta_case["runs"]
    want = meta_case["want"]["metrics"]
    assert got["ks"] == meta_case["ks"] and got["k"] == meta_case["ks"][-1]
    for name in LOSSES:
        spread = max(abs(m[name] - got[name]) for _, m, _ in moved)
        err = abs(got[name] - want[name])
        assert err <= max(1e-5 * abs(want[name]), SPREAD_FACTOR * spread), (
            name, err / abs(want[name]), spread / abs(want[name]))


@pytest.mark.parametrize("moment", ["mu", "nu"])
def test_meta_adam_moments_match_jax(meta_case, moment):
    """Adam's moments after the task, the one state carried across it:
    the same leaves as JAX's "train" partition, and the count."""
    (state, _, _), *moved = meta_case["runs"]
    want = meta_case["want"]
    assert state.opt.count == want["count"] == N_INNER
    got = _moments(state)[moment == "nu"]
    assert set(got) == set(want[moment])
    spread = {key: 0.0 for key in got}
    for other, _, _ in moved:
        for key, v in _moments(other)[moment == "nu"].items():
            spread[key] = max(spread[key], float((v - got[key]).abs().max()))
    for key, v in got.items():
        w = np.asarray(want[moment][key])
        err = float(np.abs(v.numpy() - w).max())
        assert err <= max(1e-4 * float(np.abs(w).max()),
                          SPREAD_FACTOR * spread[key]), (
            key, err / float(np.abs(w).max()), spread[key])


def test_meta_theta_matches_jax(meta_case):
    """theta' per leaf within the Adam-update bound (a sanity check, see
    the module's docstring), every trainable leaf moved; the Swin (frozen)
    as it was, bit for bit; one step counted."""
    state, _, _ = meta_case["runs"][0]
    want = meta_case["want"]
    lr = meta_case["cfg"].train.inner_lr
    assert state.step == want["step"] == 1
    before = flatten_params(meta_case["pj"])
    moved = 0
    for key, v in flatten_params(state.params).items():
        got, w = v.detach().numpy(), np.asarray(want["params"][key])
        if key.startswith("swin/"):
            assert np.array_equal(got, before[key]), key
            assert not v.requires_grad
            continue
        assert float(np.abs(got - w).max()) <= 2.5 * OUTER_LR * N_INNER * lr, (
            key, float(np.abs(got - w).max()))
        moved += not np.array_equal(got, before[key])
    assert moved == len(state.trainable())


@pytest.mark.parametrize("eta", [0.5, 1e-4, 0.3])
def test_interp_matches_jax_exactly(eta):
    """theta += eta * (omega - theta) on the leaves labelled "train", bit
    for bit with JAX's ``_interp``; the frozen leaves untouched."""
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    theta = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    omega = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 1e-3)
             for k, v in theta.items()}
    labels = {"a": "train", "b": "freeze", "c": "train"}
    want = jax.device_get(jstep._interp(
        jax.tree_util.tree_map(jnp.asarray, theta),
        jax.tree_util.tree_map(jnp.asarray, omega), labels, eta))
    got = {k: torch.from_numpy(v.copy()) for k, v in theta.items()}
    out = tstep._interp(got, {k: torch.from_numpy(v) for k, v in
                              omega.items()}, labels, eta)
    assert out is got
    for k in shapes:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert np.array_equal(got["b"].numpy(), theta["b"])


def test_meta_step_equals_its_composition(meta_case, monkeypatch):
    """The meta step, bit for bit, against its parts run by hand: omega a
    copy of theta's trainable leaves, n plain steps on omega through
    theta's Adam state, the interpolation. With stochastic depth on and k
    drawn: the draws come in the same order. omega shares the frozen Swin
    with theta (one copy of it, its weight caches kept)."""
    ct = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig().with_kernels(),
        train=tcfg.TrainConfig(mode="meta", max_layers=MAX_K,
                               num_inner_updates=N_INNER,
                               outer_lr=OUTER_LR))
    pj, vj = meta_case["pj"], meta_case["vj"]
    contents, style = meta_case["contents"], meta_case["style"]
    seen = []
    apply = tstep.master_apply

    def spy(params, *args, **kwargs):
        seen.append(params)
        return apply(params, *args, **kwargs)

    monkeypatch.setattr(tstep, "master_apply", spy)
    state_a = tstate.create_train_state(params_from_jax(pj), ct.train)
    theta_a = flatten_params(state_a.params)
    ga = torch.Generator().manual_seed(11)
    state_a, ma = ttrain.make_meta_train_step(ct, params_from_jax(vj),
                                              device="cpu")(
        state_a, contents, style, ga)
    assert len(seen) == N_INNER
    for omega in seen:
        flat = flatten_params(omega)
        for key, leaf in flat.items():
            assert (leaf is theta_a[key]) == key.startswith("swin/"), key
    monkeypatch.setattr(tstep, "master_apply", apply)

    state_b = tstate.create_train_state(params_from_jax(pj), ct.train)
    gb = torch.Generator().manual_seed(11)
    omega = tree_map(lambda t: (t.detach().clone().requires_grad_()
                                if t.requires_grad else t), state_b.params)
    inner = tstate.TrainState(step=0, params=omega, opt=state_b.opt)
    plain = ttrain.make_train_step(ct, params_from_jax(vj), device="cpu")
    ks = []
    for j in range(N_INNER):
        inner, mb = plain(inner, contents[j], style, gb)
        ks.append(mb["k"])
    tstep._interp(state_b.params, omega,
                  tstate.trainable_labels(state_b.params, ct.train),
                  OUTER_LR)
    assert ma == dict(mb, ks=ks)
    assert torch.equal(ga.get_state(), gb.get_state())
    assert state_a.step == 1 and state_a.opt.count == state_b.opt.count
    for a, b in zip(flatten_params(state_a.params).values(),
                    flatten_params(state_b.params).values()):
        assert torch.equal(a, b)
    for a, b in zip(state_a.opt.mu + state_a.opt.nu,
                    state_b.opt.mu + state_b.opt.nu):
        assert torch.equal(a, b)


def test_meta_step_refuses_a_wrong_task_shape(meta_case):
    ct = meta_case["ct"]
    state = tstate.create_train_state(params_from_jax(meta_case["pj"]),
                                      ct.train)
    step = tstep.make_meta_train_step(ct, params_from_jax(meta_case["vj"]),
                                      device="cpu")
    with pytest.raises(ValueError, match="inner updates"):
        step(state, meta_case["contents"][:1], meta_case["style"],
             torch.Generator(), ks=[1])
    with pytest.raises(ValueError, match="inner updates"):
        step(state, meta_case["contents"], meta_case["style"],
             torch.Generator(), ks=[1])
    assert state.step == 0 and state.opt.count == 0


def test_training_config_from_jax_json():
    """The JAX JSON's meta, remat, accumulation and data fields reach the
    port's config; nothing of them is dropped."""
    cj = jcfg.ExperimentConfig(
        data=jcfg.DataConfig(use_random_crop=False, batch_size_content=6),
        train=jcfg.TrainConfig(mode="meta", remat=True, grad_accum_steps=4,
                               outer_lr=0.25, num_inner_updates=3))
    ct = tcfg.ExperimentConfig.from_json(cj.to_json())
    assert ct.train.mode == "meta" and ct.train.remat
    assert ct.train.grad_accum_steps == 4
    assert ct.train.outer_lr == 0.25 and ct.train.num_inner_updates == 3
    assert not ct.data.use_random_crop
    assert ct.data.batch_size_content == 6
    j_train, j_data = cj.train.to_dict(), cj.data.to_dict()
    for name, v in ct.train.to_dict().items():
        assert j_train[name] == v, name
    for name, v in ct.data.to_dict().items():
        assert j_data[name] == v, name
    # and the defaults are JAX's
    dt, dj = tcfg.TrainConfig(), jcfg.TrainConfig()
    for name in ("outer_lr", "num_inner_updates", "remat",
                 "grad_accum_steps"):
        assert getattr(dt, name) == getattr(dj, name), name
    dd, ddj = tcfg.DataConfig(), jcfg.DataConfig()
    for name in ("use_random_crop", "batch_size_content"):
        assert getattr(dd, name) == getattr(ddj, name), name


def test_adam_steps_the_leaves_it_is_given():
    """One Adam state stepping another list of leaves of the same shapes
    (the meta step's omega) moves them as it would move its own, and
    leaves its own untouched; the moments and the count are shared."""
    rng = np.random.default_rng(4)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    grads = [[torch.from_numpy(rng.standard_normal(p.shape)
                               .astype(np.float32)) for p in p0]
             for _ in range(3)]
    own = [torch.from_numpy(p.copy()) for p in p0]
    a = tstate.Adam(own, lambda n: 1e-3 * (n + 1))
    base = [torch.from_numpy(p.copy()) for p in p0]
    other = [torch.from_numpy(p.copy()) for p in p0]
    b = tstate.Adam(base, lambda n: 1e-3 * (n + 1))
    for g in grads:
        assert a.step(g) == b.step(g, other)
    assert b.count == 3
    for x, y, z, p in zip(own, other, base, p0):
        assert torch.equal(x, y)
        assert np.array_equal(z.numpy(), p)
    for x, y in zip(a.mu + a.nu, b.mu + b.nu):
        assert torch.equal(x, y)
