"""The port's training entry point (``train/trainer.py``), its train-state
checkpoints (``utils/checkpoint.py``) and the VGG19 conversion
(``utils/convert.py``) against the JAX package on the CPU.

``train()`` runs at 64^2 crops from 80^2 staging, batch 2, swin_B widths
(the port's other training tests' configuration), k in [1, 2], kernels on
(their plain versions on the CPU), ``device="cpu"``, on BMP folders
written here from numpy seeds. The command line, its configuration, the
metric keys, the checkpoints (the JAX package's Orbax layout, read by
JAX's ``restore_checkpoint``),
the VGG19 conversion, the PNG dump and the experiment-dir renaming are
held to JAX's; a checkpoint's round trip bit for bit; a resumed run's
draws to a continuous run's, its loaders restarting at their first batch
as JAX's do. chip_smoke.py's launch table of one dump is counted here
with the kernel wrappers made to see a card. With ``num_devices`` 2 the
trainer runs in 2 gloo ranks (tests/torch_dp_workers.py, no JAX) against
the one-device runs, and ``main --num_devices 2`` starts its own ranks.
"""

import contextlib
import json
import os
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.losses import vgg as jvgg
from mastermetastyletransfer_tpu.models import master as jmaster
from mastermetastyletransfer_tpu.train import state as jstate
from mastermetastyletransfer_tpu.train import step as jstep
from mastermetastyletransfer_tpu.utils import checkpoint as jckpt
from mastermetastyletransfer_tpu.utils import convert as jconvert
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.parallel.launch import spawn_ranks
from mastermetastyletransfer_tpu_torch.train import state as tstate
from mastermetastyletransfer_tpu_torch.train import trainer
from mastermetastyletransfer_tpu_torch.utils import checkpoint as tckpt
from mastermetastyletransfer_tpu_torch.utils import convert as tconvert
from mastermetastyletransfer_tpu_torch.utils.checkpoint import flatten_params
from mastermetastyletransfer_tpu_torch.utils.orbax import read_pytree
from mastermetastyletransfer_tpu_torch.utils.png import png_bytes, save_png
from tests import torch_dp_workers as dp_workers
from tests.torch_threads import two_torch_threads  # noqa: F401

SIZE, STAGE, BATCH, MAX_K = 64, 80, 2, 2
_ADAM = ("state", "opt_state", "inner_states", "train", "inner_state", 0)
# What the port logs beside JAX's metrics: the step's learning rate, and
# the meta step's depths (JAX's meta step logs no k).
PORT_EXTRA = {"plain": {"lr"}, "fast_adaptation": {"lr"},
              "meta": {"lr", "ks"}}


def _jax_trainer():
    """JAX's trainer module, imported without the persistent compilation
    cache it turns on at import (which would write under the
    repository)."""
    from mastermetastyletransfer_tpu.utils import cache

    enable = cache.enable_compilation_cache
    cache.enable_compilation_cache = lambda path=None: None
    try:
        from mastermetastyletransfer_tpu.train import trainer as jtrainer
    finally:
        cache.enable_compilation_cache = enable
    return jtrainer


def _folders(root):
    rng = np.random.default_rng(0)
    dirs = {}
    for name, n, hw in (("c", 6, (96, 120)), ("s", 3, (100, 90))):
        d = os.path.join(root, name)
        os.makedirs(d)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, hw + (3,), np.uint8)).save(
                os.path.join(d, f"{i}.bmp"))
        dirs[name] = d
    return dirs["c"], dirs["s"]


def _config(cdir, sdir, mode="plain", iters=2, **train):
    return tcfg.ExperimentConfig(
        model=tcfg.ModelConfig().with_kernels(),
        data=tcfg.DataConfig(content_dir=cdir, style_dir=sdir,
                             batch_size_content=BATCH, resize_to=STAGE,
                             crop_to=SIZE, num_workers=2, seed=0),
        train=tcfg.TrainConfig(**{**dict(
            mode=mode, max_iterations=iters, max_layers=MAX_K,
            num_inner_updates=2, save_every=1000, save_every_for_model=1000,
            seed=0), **train}))


@contextlib.contextmanager
def _recording(seen):
    """The trainer's step makers and its preprocessing wrapped: each
    iteration's staged content batch and generator state before its crops,
    and its state (step, count at the call; the state object) and
    metrics."""
    made = (trainer.make_train_step, trainer.make_meta_train_step,
            trainer.device_preprocess_pair)

    def wrap(make):
        def maker(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(state, *rest):
                seen[-1].update(step=state.step, count=state.opt.count)
                state, m = step(state, *rest)
                seen[-1].update(metrics=m, state=state)
                return state, m
            return run
        return maker

    def preprocess(cfg, content_u8, style_u8, *, generator, **kw):
        seen.append(dict(content_u8=content_u8.clone(),
                         gen=generator.get_state()))
        return made[2](cfg, content_u8, style_u8, generator=generator, **kw)

    (trainer.make_train_step, trainer.make_meta_train_step,
     trainer.device_preprocess_pair) = (wrap(made[0]), wrap(made[1]),
                                        preprocess)
    try:
        yield seen
    finally:
        (trainer.make_train_step, trainer.make_meta_train_step,
         trainer.device_preprocess_pair) = made


def _train(cfg, exp, seen=None, **kw):
    seen = [] if seen is None else seen
    with _recording(seen):
        metrics = trainer.train(cfg, exp_dir=exp, log_every=1, device="cpu",
                                **kw)
    return metrics, seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer"))
    cdir, sdir = _folders(root)
    out = {"root": root, "cdir": cdir, "sdir": sdir}
    for mode in ("plain", "meta", "fast_adaptation"):
        cfg = _config(cdir, sdir, mode, save_every=2)
        exp = os.path.join(root, mode)
        out[mode] = dict(cfg=cfg, exp=exp, result=_train(cfg, exp))
        # as the run left them (the resumed run rewrites plain's)
        for name in ("config.json", "metrics.jsonl"):
            with open(os.path.join(exp, name)) as f:
                out[mode][name] = f.read()
    exp = out["plain"]["exp"]
    out["after_2"] = tckpt.latest_step(os.path.join(exp, "checkpoints"))
    cfg4 = _config(cdir, sdir, iters=4, save_every=2)
    out["resume"] = _train(cfg4, exp, resume=True)
    out["continuous"] = _train(cfg4, os.path.join(root, "continuous"))
    return out


# ---------------------------------------------------------------------------
# the loop in its three modes
# ---------------------------------------------------------------------------

def _jax_metric_keys(mode: str) -> set:
    """The keys of JAX's step metrics in ``mode``, from an abstract
    evaluation of its step (no compilation, nothing computed)."""
    cfg = jcfg.ExperimentConfig(train=jcfg.TrainConfig(
        mode=mode, max_layers=MAX_K, num_inner_updates=2))
    meta = mode == "meta"
    content = jax.ShapeDtypeStruct(((2,) if meta else ()) + (
        BATCH, SIZE, SIZE, 3), np.float32)
    style = jax.ShapeDtypeStruct((BATCH, SIZE, SIZE, 3), np.float32)

    def metrics(content, style):
        params = jmaster.init_master_model(jax.random.PRNGKey(0), cfg.model)
        tx = jstate.make_optimizer(params, cfg.train)
        state, tx = jstate.create_train_state(params, cfg.train, tx)
        vgg = jvgg.init_vgg19_features(jax.random.PRNGKey(1))
        make = jstep.make_meta_train_step if meta else jstep.make_train_step
        return make(cfg, vgg, tx)(state, content, style,
                                  jax.random.PRNGKey(2))[1]

    return set(jax.eval_shape(metrics, content, style))


@pytest.mark.parametrize("mode", ["plain", "meta", "fast_adaptation"])
def test_train_runs_each_mode(runs, mode):
    """Two iterations: finite metrics, config.json (read by JAX's config
    too), one JSONL line per iteration with JAX's metric keys (and the
    port's extras), the final checkpoint, a dump at iteration 2."""
    run = runs[mode]
    metrics, seen = run["result"]
    assert len(seen) == 2
    assert all(np.isfinite(v) for k, v in metrics.items() if k != "ks")
    text = run["config.json"]
    assert text == run["cfg"].to_json()
    assert jcfg.ExperimentConfig.from_json(text).to_dict() == \
        run["cfg"].to_dict()
    rows = [json.loads(line) for line in run["metrics.jsonl"].splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    want = _jax_metric_keys(mode) | {"step", "imgs_per_sec"}
    for r in rows:
        assert set(r) == want | PORT_EXTRA[mode], set(r) ^ want
        assert all(np.isfinite(v) for k, v in r.items() if k != "ks")
    if mode == "meta":
        assert [r["ks"] for r in rows] == [s["metrics"]["ks"] for s in seen]
        assert all(len(r["ks"]) == 2 for r in rows)
    ckpt = os.path.join(run["exp"], "checkpoints")
    assert tckpt.latest_step(ckpt) == (4 if mode == "plain" else 2)
    files = os.listdir(os.path.join(ckpt, "2"))
    assert {"_METADATA", "_CHECKPOINT_METADATA", "state.step"} <= set(files)
    assert not {"opt.npz", "params.npz", "state.json"} & set(files)
    with Image.open(os.path.join(run["exp"], "stylized_2.png")) as im:
        dump = np.asarray(im)
    assert dump.shape == (SIZE, SIZE, 3) and dump.std() > 0


def test_meta_contents_are_flattened_crops(runs):
    """Meta mode crops the (num_inner_updates x B) staged batch as one
    flattened batch, then steps on (num_inner_updates, B, ...)."""
    seen = runs["meta"]["result"][1]
    assert seen[0]["content_u8"].shape == (2 * BATCH, STAGE, STAGE, 3)


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------

def _files(path):
    """A checkpoint's leaves as the port's Orbax reader gives them:
    (params by flat key, moments by "mu/<key>" and "nu/<key>", the step
    and both counts)."""
    leaves = read_pytree(path)
    params = {"/".join(map(str, k[2:])): v.numpy()
              for k, v in leaves.items() if k[:2] == ("state", "params")}
    opt = {f"{k[6]}/" + "/".join(map(str, k[7:])): v.numpy()
           for k, v in leaves.items()
           if k[:6] == _ADAM and k[6] in ("mu", "nu") and v is not None}
    counts = {"step": int(leaves[("state", "step")]),
              "count": int(leaves[_ADAM + ("count",)]),
              "schedule": int(leaves[_ADAM[:-1] + (1, "count")])}
    return params, opt, counts


def test_checkpoint_round_trip_is_exact(runs):
    """The checkpoint of step 2 holds the state after run 1's last step,
    bit for bit; restored into a fresh state, it gives back its params,
    mu, nu, count and step bit for bit."""
    assert runs["after_2"] == 2
    exp = runs["plain"]["exp"]
    ckpt = os.path.join(exp, "checkpoints")
    assert tckpt.latest_step(ckpt) == 4
    state = runs["plain"]["result"][1][-1]["state"]
    params, opt, meta = _files(os.path.join(ckpt, "2"))
    leaves, keys = flatten_params(state.params), list(state.trainable())
    assert set(params) == set(leaves)
    for k, v in leaves.items():
        assert np.array_equal(params[k], v.detach().numpy()), k
    assert set(opt) == {f"{m}/{k}" for m in ("mu", "nu") for k in keys}
    for m, moments in (("mu", state.opt.mu), ("nu", state.opt.nu)):
        for k, t in zip(keys, moments):
            assert np.array_equal(opt[f"{m}/{k}"], t.numpy()), (m, k)
    assert meta == {"step": 2, "count": 2, "schedule": 2}
    assert (state.step, state.opt.count) == (2, 2)
    cfg = runs["plain"]["cfg"]
    fresh = tstate.create_train_state(trainer.init_master_model(
        cfg.model, torch.Generator().manual_seed(9), device="cpu"),
        cfg.train)
    tckpt.restore_checkpoint(ckpt, fresh, step=2)
    assert (fresh.step, fresh.opt.count) == (2, 2)
    for k, v in flatten_params(fresh.params).items():
        assert np.array_equal(params[k], v.detach().numpy()), k
        assert v.requires_grad == leaves[k].requires_grad, k
    for m, moments in (("mu", fresh.opt.mu), ("nu", fresh.opt.nu)):
        for k, t in zip(keys, moments):
            assert np.array_equal(opt[f"{m}/{k}"], t.numpy()), (m, k)


def test_npz_layout_still_restores(runs, tmp_path):
    """A step directory in the port's earlier layout (params.npz, opt.npz
    with "mu/<key>" and "nu/<key>", state.json), as older experiment
    directories hold it, restores bit for bit; it is read, never
    written."""
    state = runs["plain"]["result"][1][-1]["state"]
    keys = list(state.trainable())
    path = tmp_path / "checkpoints" / "2"
    path.mkdir(parents=True)
    tckpt.save_params_npz(str(path / "params.npz"), state.params)
    np.savez(str(path / "opt.npz"),
             **{f"{m}/{k}": t.numpy() for m, moments in (
                 ("mu", state.opt.mu), ("nu", state.opt.nu))
                for k, t in zip(keys, moments)})
    (path / "state.json").write_text(json.dumps({"step": 2, "count": 2}))
    cfg = runs["plain"]["cfg"]
    fresh = tstate.create_train_state(trainer.init_master_model(
        cfg.model, torch.Generator().manual_seed(9), device="cpu"),
        cfg.train)
    tckpt.restore_checkpoint(str(tmp_path / "checkpoints"), fresh)
    assert (fresh.step, fresh.opt.count) == (2, 2)
    for k, v in flatten_params(state.params).items():
        assert torch.equal(flatten_params(fresh.params)[k], v.detach()), k
    for a, b in zip(fresh.opt.mu + fresh.opt.nu, state.opt.mu + state.opt.nu):
        assert torch.equal(a, b)


def test_restore_refuses_another_mode(runs):
    """A plain run's checkpoint does not restore into a fast-adaptation
    state (its trainable leaves differ)."""
    cfg = runs["fast_adaptation"]["cfg"]
    state = tstate.create_train_state(trainer.init_master_model(
        cfg.model, torch.Generator().manual_seed(9), device="cpu"),
        cfg.train)
    with pytest.raises(KeyError, match="trainable leaves"):
        tckpt.restore_checkpoint(
            os.path.join(runs["plain"]["exp"], "checkpoints"), state)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(os.path.join(runs["root"], "none"), state)


def test_resume_repeats_a_continuous_runs_draws(runs):
    """Resumed at step 2 (step and Adam's count 2 at its first call), the
    run's iteration 2 draws its crops and k from the generator state a
    continuous run has there; its loaders start over at batch 0, as JAX's
    do, so it crops the continuous run's first batch."""
    _, resumed = runs["resume"]
    _, cont = runs["continuous"]
    assert len(resumed) == 2 and len(cont) == 4
    assert (resumed[0]["step"], resumed[0]["count"]) == (2, 2)
    for r, c in zip(resumed, cont[2:]):
        assert torch.equal(r["gen"], c["gen"])
        assert r["metrics"]["k"] == c["metrics"]["k"]
    assert torch.equal(resumed[0]["content_u8"], cont[0]["content_u8"])
    assert not torch.equal(resumed[0]["content_u8"], cont[2]["content_u8"])
    with open(os.path.join(runs["plain"]["exp"], "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 4]


def test_checkpoint_params_load_in_jax(runs):
    """A port checkpoint restores through JAX's ``restore_checkpoint``
    into JAX's train state at the run's configuration, its parameters
    equal to the port's leaves, its step and counts the port's."""
    cfg = jcfg.ExperimentConfig.from_json(runs["plain"]["cfg"].to_json())
    template = jax.eval_shape(lambda key: jmaster.init_master_model(
        key, cfg.model), jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   template)
    tx = jstate.make_optimizer(zeros, cfg.train)
    target, _ = jstate.create_train_state(zeros, cfg.train, tx)
    back = jckpt.restore_checkpoint(
        os.path.join(runs["plain"]["exp"], "checkpoints"), target, step=2)
    assert int(back.step) == 2
    state = runs["plain"]["result"][1][-1]["state"]
    got = flatten_params(back.params)
    assert set(got) == set(flatten_params(state.params))
    for k, v in flatten_params(state.params).items():
        assert np.array_equal(np.asarray(got[k]), v.detach().numpy()), k


def test_iteration_generators_differ_and_repeat():
    a = trainer.iteration_generator(0, 3).get_state()
    assert torch.equal(a, trainer.iteration_generator(0, 3).get_state())
    for seed, it in ((0, 4), (1, 3)):
        assert not torch.equal(
            a, trainer.iteration_generator(seed, it).get_state())


# ---------------------------------------------------------------------------
# the command line and its configuration
# ---------------------------------------------------------------------------

def test_argparser_defaults_match_jax():
    got = vars(trainer.build_argparser().parse_args([]))
    want = vars(_jax_trainer().build_argparser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


ARGVS = [
    [],
    ["--mode", "meta", "--num_inner_updates", "4", "--outer_lr", "0.5",
     "--batch_size", "8", "--use_pallas", "--compute_dtype", "bfloat16"],
    ["--mode", "fast_adaptation", "--swin_variant", "swin_T",
     "--unfreeze_swin", "--lambda_style", "3", "--seed", "7",
     "--exp_dir", "runs/x", "--crop_to", "128", "--resize_to", "160"],
    ["--swin_variant", "swin_S", "--warmup_iterations", "5",
     "--lr_decay_rate", "0.5", "--lr_decay_every", "9", "--max_layers", "2",
     "--max_iterations", "33", "--save_every", "4",
     "--save_every_for_model", "8", "--inner_lr", "0.01",
     "--matmul_precision", "highest"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_config_from_args_matches_jax(argv):
    jtrainer = _jax_trainer()
    got = trainer.config_from_args(trainer.build_argparser().parse_args(argv))
    want = jtrainer.config_from_args(
        jtrainer.build_argparser().parse_args(argv))
    assert got == tcfg.ExperimentConfig.from_dict(want.to_dict())
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_main_passes_jax_configuration(monkeypatch, argv):
    """``main`` hands ``train`` the configuration JAX's ``main`` hands its
    own (``--matmul_precision`` recorded in it) and the same options."""
    jtrainer = _jax_trainer()
    got, want = {}, {}
    monkeypatch.setattr(trainer, "train",
                        lambda cfg, **kw: got.update(cfg=cfg, **kw))
    monkeypatch.setattr(jtrainer, "train",
                        lambda cfg, **kw: want.update(cfg=cfg, **kw))
    trainer.main(argv + ["--device", "cpu"])
    jtrainer.main(argv)
    assert got.pop("cfg").to_dict() == want.pop("cfg").to_dict()
    assert got.pop("device") == "cpu"
    assert got == want


def test_matmul_precision_high_with_kernels_refused(runs, capsys):
    with pytest.raises(SystemExit):
        trainer.main(["--matmul_precision", "high", "--use_pallas"])
    assert "--matmul_precision high" in capsys.readouterr().err
    cfg = _config(runs["cdir"], runs["sdir"], matmul_precision="high")
    with pytest.raises(ValueError, match="matmul_precision='high'"):
        trainer.train(cfg, exp_dir=os.path.join(runs["root"], "high"),
                      device="cpu")


# ---------------------------------------------------------------------------
# data parallelism: num_devices = 2 over gloo ranks on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_runs(runs):
    """``train`` with ``num_devices=2`` in 2 gloo ranks, spawned once:
    plain and meta for 2 iterations (as ``runs``), and 1 plain iteration
    into an experiment dir that exists."""
    root = runs["root"]
    os.makedirs(os.path.join(root, "dp_taken"))
    cfgs = {
        "plain": (_config(runs["cdir"], runs["sdir"], num_devices=2),
                  os.path.join(root, "dp_plain")),
        "meta": (_config(runs["cdir"], runs["sdir"], "meta", num_devices=2),
                 os.path.join(root, "dp_meta")),
        "taken": (_config(runs["cdir"], runs["sdir"], iters=1,
                          num_devices=2), os.path.join(root, "dp_taken"))}
    return cfgs, spawn_ranks(dp_workers.dp_train, 2, backend="gloo",
                             device="cpu", args=(cfgs,))


@pytest.mark.parametrize("mode", ["plain", "meta"])
def test_data_parallel_trainer_matches_one_device(runs, dp_runs, mode):
    """Two ranks train as the one-device trainer does: one experiment dir
    (config, one metrics line per step, one checkpoint), the final weights
    within 2.5 lr per update (each Adam update is about lr per element,
    and a near-zero gradient may take either sign; JAX's own bound,
    tests/test_train.py), the first logged losses the one-device run's
    within 1e-5 relative. The second step's within 1e-4: its weights have
    taken updates whose near-zero gradients may take the other sign on
    the ranks, and such a 2 lr move of the weights moves the losses by up
    to 5.2e-5 relative (tests/test_torch_meta.py); the meta run's content
    loss moves 1.2e-5 here."""
    cfgs, ranks = dp_runs
    cfg, exp = cfgs[mode]
    assert [r[mode]["exp_dir"] for r in ranks] == [exp, exp]
    assert sorted(os.listdir(exp)) == ["checkpoints", "config.json",
                                       "metrics.jsonl"]
    assert json.loads(open(os.path.join(exp, "config.json")).read())[
        "train"]["num_devices"] == 2
    rows = [json.loads(line) for line in open(
        os.path.join(exp, "metrics.jsonl"))]
    want = [json.loads(line)
            for line in runs[mode]["metrics.jsonl"].splitlines()]
    assert [r["step"] for r in rows] == [w["step"] for w in want] == [1, 2]
    assert ranks[0][mode]["result"] == {k: v for k, v in rows[-1].items()
                                        if k != "step"}
    for r, w in zip(rows, want):
        assert set(r) == set(w)
        assert r.get("ks", r.get("k")) == w.get("ks", w.get("k"))
        tol = 1e-5 if r["step"] == 1 else 1e-4
        for name in ("total", "content", "style"):
            assert abs(r[name] - w[name]) <= tol * abs(w[name]), (
                r["step"], name, r[name], w[name])
    ckpt = os.path.join(exp, "checkpoints")
    assert tckpt.latest_step(ckpt) == 2
    assert sorted(os.listdir(ckpt)) == ["2", "config.json"]
    state = runs[mode]["result"][1][-1]["state"]
    got = _files(os.path.join(ckpt, "2"))[0]
    leaves = flatten_params(state.params)
    assert set(got) == set(leaves)
    lr = cfg.train.inner_lr
    updates = 2 * (cfg.train.num_inner_updates if mode == "meta" else 1)
    for key, leaf in leaves.items():
        err = float(np.abs(got[key] - leaf.detach().numpy()).max())
        assert err <= 2.5 * lr * updates, (key, err)


def test_data_parallel_trainer_shares_a_renamed_exp_dir(runs, dp_runs):
    """An experiment dir that exists: rank 0 resolves dp_taken_2 once and
    every rank takes it; nothing else is made."""
    cfgs, ranks = dp_runs
    exp = cfgs["taken"][1]
    assert [r["taken"]["exp_dir"] for r in ranks] == [exp + "_2"] * 2
    assert os.listdir(exp) == []
    assert not os.path.exists(exp + "_3")
    assert sorted(os.listdir(exp + "_2")) == ["checkpoints", "config.json",
                                              "metrics.jsonl"]
    assert tckpt.latest_step(os.path.join(exp + "_2", "checkpoints")) == 1


def test_main_trains_over_num_devices_ranks(runs, monkeypatch):
    """``main --num_devices 2 --device cpu`` starts 2 gloo ranks and
    returns rank 0's logged metrics."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    exp = os.path.join(runs["root"], "dp_main")
    metrics = trainer.main([
        "--num_devices", "2", "--device", "cpu", "--content_dir",
        runs["cdir"], "--style_dir", runs["sdir"], "--exp_dir", exp,
        "--batch_size", str(BATCH), "--crop_to", str(SIZE), "--resize_to",
        str(STAGE), "--max_layers", str(MAX_K), "--max_iterations", "1",
        "--use_pallas", "--log_every", "1"])
    assert np.isfinite(metrics["total"]) and metrics["k"] in (1, 2)
    assert [json.loads(line)["step"] for line in open(
        os.path.join(exp, "metrics.jsonl"))] == [1]
    assert tckpt.latest_step(os.path.join(exp, "checkpoints")) == 1


def test_num_devices_above_one_needs_a_process_group(runs):
    """No fallback to one device: ``train`` with num_devices 2 outside a
    process group of 2 raises (make_mesh's RuntimeError)."""
    cfg = _config(runs["cdir"], runs["sdir"], num_devices=2)
    with pytest.raises(RuntimeError, match="initialised process group"):
        trainer.train(cfg, exp_dir=os.path.join(runs["root"], "dp"),
                      device="cpu")
    assert not os.path.exists(os.path.join(runs["root"], "dp"))


def test_cuda_without_a_card_raises(runs):
    """No fallback to the CPU: a cuda run where torch sees no card
    raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train(_config(runs["cdir"], runs["sdir"]),
                      exp_dir=os.path.join(runs["root"], "cuda"))


# ---------------------------------------------------------------------------
# VGG weights, dumps, experiment dirs
# ---------------------------------------------------------------------------

def _vgg_state_dict(bn: bool, prefix: str) -> dict:
    """A torchvision-style vgg19(_bn).features state dict, random."""
    g = torch.Generator().manual_seed(int(bn))
    idxs = (tconvert._VGG19_BN_CONV_IDX if bn
            else tconvert._VGG19_CONV_IDX)
    chans = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
             (256, 256), (256, 256), (256, 256), (256, 512), (512, 512),
             (512, 512), (512, 512), (512, 512)]
    sd = {}
    for i, (cin, cout) in zip(idxs, chans):
        sd[f"{prefix}{i}.weight"] = torch.randn((cout, cin, 3, 3),
                                                generator=g) * 0.05
        sd[f"{prefix}{i}.bias"] = torch.randn(cout, generator=g) * 0.1
        if bn:
            sd[f"{prefix}{i + 1}.weight"] = torch.rand(cout, generator=g) + .5
            sd[f"{prefix}{i + 1}.bias"] = torch.randn(cout, generator=g)
            sd[f"{prefix}{i + 1}.running_mean"] = torch.randn(cout,
                                                              generator=g)
            sd[f"{prefix}{i + 1}.running_var"] = torch.rand(
                cout, generator=g) + 0.1
            sd[f"{prefix}{i + 1}.num_batches_tracked"] = torch.tensor(3)
    return sd


@pytest.mark.parametrize("bn,prefix", [(False, "features."), (True, ""),
                                       (False, ""), (True, "features.")])
def test_convert_vgg19_matches_jax(tmp_path, bn, prefix):
    path = str(tmp_path / "vgg.pt")
    torch.save(_vgg_state_dict(bn, prefix), path)
    sd = tconvert.load_torch_state_dict(path)
    jsd = jconvert.load_torch_state_dict(path)
    assert sd.keys() == jsd.keys()
    got = flatten_params(tconvert.convert_vgg19(sd, use_batchnorm=bn))
    want = flatten_params(jconvert.convert_vgg19(jsd, use_batchnorm=bn))
    assert set(got) == set(want) and len(got) == 26
    for k, v in got.items():
        assert v.dtype == torch.float32
        assert np.array_equal(v.numpy(), np.asarray(want[k])), k
    if not bn:          # the trainer's --vgg_weights reads a plain .pt
        loaded = flatten_params(trainer.load_vgg_params(path, "cpu"))
        assert all(torch.equal(loaded[k], v) for k, v in got.items())


def test_load_vgg_params_npz_and_default(tmp_path):
    default = trainer.load_vgg_params(None, "cpu")
    again = trainer.load_vgg_params(None, "cpu")
    for k, v in flatten_params(default).items():
        assert torch.equal(v, flatten_params(again)[k])
    changed = {k: {n: t + 1 for n, t in v.items()} for k, v in
               default.items()}
    path = str(tmp_path / "vgg.npz")
    tckpt.save_params_npz(path, changed)
    loaded = flatten_params(trainer.load_vgg_params(path, "cpu"))
    for k, v in flatten_params(changed).items():
        assert torch.equal(loaded[k], v), k


def test_dump_image_matches_jax(tmp_path):
    img = np.random.default_rng(3).uniform(-0.2, 1.2, (33, 47, 3)).astype(
        np.float32)
    save_png(str(tmp_path / "port.png"), img)
    _jax_trainer()._dump_image(str(tmp_path / "jax.png"), img)
    with Image.open(tmp_path / "port.png") as a, \
            Image.open(tmp_path / "jax.png") as b:
        assert a.mode == b.mode == "RGB" and a.size == (47, 33)
        assert np.array_equal(np.asarray(a), np.asarray(b))


# The writer's bytes as the trainer wrote its dumps before the writer moved
# to utils/png.py: a 3x2 image, and the sha256 of the dump of the float
# image of test_dump_image_matches_jax.
PNG_3X2 = bytes.fromhex(
    "89504e470d0a1a0a0000000d49484452000000030000000208020000001216f14d0000"
    "001c49444154789c6360e095523771f48bce60286dea9fb372dbe10b7701331d07c63d"
    "5e59a10000000049454e44ae426082")
DUMP_SHA256 = ("7a2bf417b39b747db643ed7869abd5e2"
               "89e72c245772b3aea4e1cd541f7e4d82")


def test_dump_bytes_are_pinned(tmp_path):
    """The PNG writer's bytes; the trainer dumps through that writer."""
    import hashlib

    img = (np.arange(18, dtype=np.uint8) * 13).reshape(2, 3, 3)
    assert png_bytes(img) == PNG_3X2
    assert trainer.save_png is save_png
    f32 = np.random.default_rng(3).uniform(-0.2, 1.2, (33, 47, 3)).astype(
        np.float32)
    save_png(str(tmp_path / "dump.png"), f32)
    digest = hashlib.sha256((tmp_path / "dump.png").read_bytes()).hexdigest()
    assert digest == DUMP_SHA256


@pytest.mark.parametrize("existing,resume", [
    ((), False), (("run",), False), (("run", "run_2"), False),
    (("run", "run_3"), False), (("run",), True), ((), True)])
def test_resolve_exp_dir_matches_jax(tmp_path, existing, resume):
    for name in existing:
        (tmp_path / name).mkdir()
    exp = str(tmp_path / "run")
    assert trainer._resolve_exp_dir(exp, resume) == \
        _jax_trainer()._resolve_exp_dir(exp, resume)


# ---------------------------------------------------------------------------
# chip_smoke.py's launch table of one dump
# ---------------------------------------------------------------------------

class _StubLib:
    """Stands in for a kernel library: launches nothing."""

    def __getattr__(self, name):
        return lambda *args: 1 if name.endswith("smem_bytes") else 0


def test_dump_launch_table(monkeypatch):
    """One dump, ``master_apply`` on a 256^2 pair at bf16, k=1, kernels on,
    with every wrapper made to see a card and its library a stub: its
    launches are chip_smoke.py's ``DUMP_PER_CALL``."""
    import chip_smoke
    from mastermetastyletransfer_tpu_torch.models.master import (
        init_master_model, master_apply,
    )
    from mastermetastyletransfer_tpu_torch.ops import block_pair as bpr
    from mastermetastyletransfer_tpu_torch.ops import ln_mlp as lm
    from mastermetastyletransfer_tpu_torch.ops import patch_embed as tpe
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc
    from mastermetastyletransfer_tpu_torch.ops import style_block as sb
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa
    from mastermetastyletransfer_tpu_torch.ops import window_block as wb

    lib = _StubLib()
    for mod in (wb, sb, pc, bpr, tpe, wa, lm):
        monkeypatch.setattr(mod, "_on_cuda", lambda t: True)
        monkeypatch.setattr(mod, "_lib", lambda: lib)
        for entry in mod.LAUNCHES:
            monkeypatch.setitem(mod.LAUNCHES, entry, 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    cfg = tcfg.ModelConfig(compute_dtype="bfloat16").with_kernels()
    params = init_master_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    x = torch.rand((1, 256, 256, 3), generator=torch.Generator()
                   .manual_seed(1))
    with torch.no_grad():
        master_apply(params, x, x, cfg, k=1, deterministic=True)
    assert chip_smoke.all_launches() == chip_smoke.DUMP_PER_CALL
