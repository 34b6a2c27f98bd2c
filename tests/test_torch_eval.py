"""The evaluation grid in the port (``eval/harness.py``, ``eval/cli.py``)
against the JAX package on the CPU.

The harness at a narrow configuration (Swin 32 wide with 2 and 4 heads,
the style transformer 64 wide with 4 heads, the decoder 64 channels) on 2
contents x 3 styles at 64^2 with ``style_batch`` 2, so that the last style
chunk is padded; k = 1 and 2, with the similarity loss. The port runs its
kernels (their plain versions on the CPU), JAX its plain route. The
weights are the port's draws (its initializers draw JAX's distributions;
JAX's jitted initializer takes 13 s to compile on the CPU), shared as numpy
arrays, which ``params_from_jax`` carries into the port. The inputs are
BMP files written here, so that both decoders see the same pixels. Bounds: each
pair's losses and the summary within 1e-5 relative, each stylized image
within per-pixel MAE 1e-5 (the port's f32 bar against JAX,
tests/test_torch_locked.py); the dumps are the port's outputs quantised,
exactly; ``load_eval_images`` bit for bit.

Both command lines on the same folders at swin_B widths, with the same
.npz checkpoint and VGG19 .npz. JAX's initializers make the templates the
checkpoint is read into; they are replaced here by zeros of the same tree
(``jax.eval_shape``), which the checkpoint overwrites, since JAX draws them
op by op in 20 s.
"""

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
from mastermetastyletransfer_tpu.eval import harness as jharness
from mastermetastyletransfer_tpu.losses import vgg as jvgg
from mastermetastyletransfer_tpu.models import master as jmaster
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.eval import cli as tcli
from mastermetastyletransfer_tpu_torch.eval import harness as tharness
from mastermetastyletransfer_tpu_torch.losses.vgg import init_vgg19_features
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.train.state import create_train_state
from mastermetastyletransfer_tpu_torch.utils import checkpoint as tckpt
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE, STYLE_BATCH = 64, 2
TOL_REL, TOL_MAE = 1e-5, 1e-5
LOSSES = ("total", "content", "style", "similarity")


def _narrow(m: jcfg.ModelConfig) -> jcfg.ModelConfig:
    return m.replace(
        swin=jcfg.SwinConfig(variant="swin_custom", embed_dim=32,
                             num_heads=(2, 4)),
        transformer=m.transformer.replace(
            encoder_dim=64, decoder_dim=64, encoder_num_heads=4,
            decoder_num_heads=4),
        decoder=m.decoder.replace(channel_dim=64))


def _jax_module(name):
    """A module of the JAX package that turns on the persistent compilation
    cache at import (which would write under the repository), imported
    with that cache kept off."""
    import importlib

    from mastermetastyletransfer_tpu.utils import cache

    enable = cache.enable_compilation_cache
    cache.enable_compilation_cache = lambda path=None: None
    try:
        return importlib.import_module(name)
    finally:
        cache.enable_compilation_cache = enable


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """2 content and 3 style BMPs of other sizes than 64^2."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    dirs = []
    for name, n in (("content", 2), ("style", 3)):
        d = root / name
        d.mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (70 + 9 * i, 90 - 7 * i, 3),
                                         np.uint8)).save(d / f"{name}{i}.bmp")
        dirs.append(str(d))
    return dict(root=root, content=dirs[0], style=dirs[1])


def _numpy(tree):
    """A tree of CPU tensors as numpy arrays."""
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _recording(module, seen):
    """``module._save_image`` wrapped: each image kept by its file's stem
    (the pair) before the original writes it."""
    original = module._save_image

    def save(img01, path):
        seen[os.path.splitext(os.path.basename(path))[0]] = np.array(img01)
        original(img01, path)
    return save


@pytest.fixture(scope="module")
def grids(folders):
    """JAX's and the port's grids at k = 1 and 2, with similarity and
    dumps; each side's report and stylized images."""
    content, cnames = jharness.load_eval_images(folders["content"], SIZE)
    styles, snames = jharness.load_eval_images(folders["style"], SIZE)
    cfg = jcfg.ExperimentConfig(model=_narrow(jcfg.ModelConfig()))
    ct = tcfg.ExperimentConfig.from_dict(cfg.to_dict())
    ct = ct.replace(model=ct.model.with_kernels())
    gen = torch.Generator().manual_seed(0)
    pj = _numpy(init_master_model(ct.model, gen, device="cpu"))
    vj = _numpy(init_vgg19_features(gen, device="cpu"))
    pt, vt = params_from_jax(pj), params_from_jax(vj)
    out = {}
    for k in (1, 2):
        for side, module, params, vgg, c in (
                ("jax", jharness, pj, vj, cfg),
                ("port", tharness, pt, vt, ct)):
            seen = {}
            dump = folders["root"] / f"{side}_k{k}"
            kw = dict(device="cpu") if side == "port" else {}
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(module, "_save_image", _recording(module, seen))
                report = module.evaluate_grid(
                    params, vgg, c, content_images=content,
                    style_images=styles, content_names=cnames,
                    style_names=snames, k=k, style_batch=STYLE_BATCH,
                    compute_similarity=True, save_images_to=str(dump), **kw)
            out[side, k] = dict(report=report, images=seen, dump=dump)
    return out


def test_load_eval_images_matches_jax(folders):
    for d in (folders["content"], folders["style"]):
        want, wnames = jharness.load_eval_images(d, SIZE)
        got, gnames = tharness.load_eval_images(d, SIZE)
        assert gnames == wnames and got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


def _close(got, want, tol=TOL_REL):
    return abs(got - want) <= tol * abs(want)


@pytest.mark.parametrize("k", [1, 2])
def test_grid_matches_jax(grids, k):
    """The pairs in JAX's order, no padded style among them; each pair's
    four losses; the summary; each stylized image."""
    want, got = grids["jax", k], grids["port", k]
    wr, gr = want["report"], got["report"]
    assert gr.pairs == wr.pairs and len(gr.pairs) == 6
    assert [s for _, s in gr.pairs[:3]] == [s for _, s in gr.pairs[3:]]
    for name in LOSSES:
        g, w = getattr(gr, name), getattr(wr, name)
        assert len(g) == len(w) == 6
        for i, (a, b) in enumerate(zip(g, w)):
            assert _close(a, b), (name, i, a, b)
    ws, gs = wr.summary(), gr.summary()
    assert gs.keys() == ws.keys() and gs["num_pairs"] == ws["num_pairs"] == 6
    for key, w in ws.items():
        assert _close(gs[key], w) or abs(gs[key] - w) <= TOL_REL * abs(
            ws[key.replace("_std", "_mean")]), (key, gs[key], w)
    assert got["images"].keys() == want["images"].keys()
    for pair, w in want["images"].items():
        g = got["images"][pair]
        assert g.shape == w.shape == (SIZE, SIZE, 3)
        assert np.abs(g - w).mean() <= TOL_MAE, pair


def _pil_jpeg95(img01):
    """What the JAX harness's _save_image writes: PIL's quality-95 JPEG of
    the output quantised."""
    buf = io.BytesIO()
    Image.fromarray(np.clip(img01 * 255, 0, 255).astype(np.uint8)).save(
        buf, "JPEG", quality=95)
    return buf.getvalue()


@pytest.mark.parametrize("k", [1, 2])
def test_grid_dumps_are_outputs_quantised(grids, k):
    """{content}__{style}.jpg as JAX names them, each the bytes PIL writes
    for the output quantised at quality 95."""
    got = grids["port", k]
    files = sorted(os.listdir(got["dump"]))
    assert files == sorted(f"{p}.jpg" for p in got["images"])
    assert len(files) == 6
    for pair, img in got["images"].items():
        data = (got["dump"] / f"{pair}.jpg").read_bytes()
        assert data == _pil_jpeg95(img), pair
        with Image.open(io.BytesIO(data)) as im:
            assert im.format == "JPEG" and im.mode == "RGB"


# ---------------------------------------------------------------------------
# The command lines
# ---------------------------------------------------------------------------

def _zeros_like_init(init):
    """``init`` as zeros of its tree, shapes from ``jax.eval_shape``."""
    def zeros(key, *static):
        shapes = jax.eval_shape(lambda key: init(key, *static), key)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                      shapes)
    return zeros


def _summary(text: str) -> dict:
    """The JSON summary a command line printed last."""
    return json.loads(text[text.index("{"):])


@pytest.fixture(scope="module")
def cli_runs(folders):
    """The two command lines with one checkpoint and one VGG19 .npz (the
    port's random draws, written by the port); the port's also from a
    train-state checkpoint directory of the same weights."""
    root = folders["root"]
    cfg = tcfg.ModelConfig()
    params = init_master_model(cfg, torch.Generator().manual_seed(5),
                               device="cpu")
    npz, vgg = str(root / "model.npz"), str(root / "vgg.npz")
    tckpt.save_params_npz(npz, params)
    tckpt.save_params_npz(vgg, init_vgg19_features(
        torch.Generator().manual_seed(6), device="cpu"))
    ckpt_dir = str(root / "ckpts")
    tckpt.save_checkpoint(ckpt_dir, create_train_state(
        params, tcfg.TrainConfig()), 7)
    common = ["--content_dir", folders["content"], "--style_dir",
              folders["style"], "--vgg_weights", vgg, "--image_size",
              str(SIZE), "--style_batch", str(STYLE_BATCH),
              "--compute_similarity"]

    import io
    from contextlib import redirect_stdout

    def run(main, argv):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(argv)
        return buf.getvalue()

    jcli = _jax_module("mastermetastyletransfer_tpu.eval.cli")
    jtrainer = _jax_module("mastermetastyletransfer_tpu.train.trainer")
    from mastermetastyletransfer_tpu import models as jmodels
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodels, "init_master_model",
                   _zeros_like_init(jmaster.init_master_model))
        mp.setattr(jtrainer, "init_vgg19_features",
                   _zeros_like_init(jvgg.init_vgg19_features))
        jax_out = run(jcli.main, common + ["--checkpoint", npz])
    port = ["--device", "cpu", "--use_pallas"]
    return dict(
        jax=jax_out,
        npz=run(tcli.main, common + port + ["--checkpoint", npz]),
        dir=run(tcli.main, common + port + ["--checkpoint", ckpt_dir]),
        npz_path=npz)


def test_cli_summary_matches_jax(cli_runs):
    want, got = _summary(cli_runs["jax"]), _summary(cli_runs["npz"])
    assert cli_runs["npz"].splitlines()[0] == cli_runs["jax"].splitlines()[0]
    assert got.keys() == want.keys()
    assert got["num_pairs"] == want["num_pairs"] == 6
    assert got["weights"] == want["weights"] == cli_runs["npz_path"]
    for key, w in want.items():
        if key not in ("num_pairs", "weights"):
            scale = abs(want[key.replace("_std", "_mean")])
            assert abs(got[key] - w) <= TOL_REL * max(abs(w), scale), key


def test_cli_train_state_checkpoint_gives_the_npz_summary(cli_runs):
    a, b = _summary(cli_runs["dir"]), _summary(cli_runs["npz"])
    assert a.pop("weights") != b.pop("weights")
    assert a == b


def test_cli_split3_needs_use_pallas(folders):
    with pytest.raises(SystemExit, match="requires --use_pallas"):
        tcli.main(["--content_dir", folders["content"], "--style_dir",
                   folders["style"], "--matmul_mode", "split3",
                   "--device", "cpu"])


def test_cli_config_matches_jax():
    """The command line's model configuration, split3 included, is JAX's
    (but for the fields JAX's own split3 route sets alone)."""
    jcli = _jax_module("mastermetastyletransfer_tpu.eval.cli")
    for argv in ([], ["--use_pallas", "--matmul_mode", "split3",
                      "--swin_variant", "swin_T", "--lambda_style", "4",
                      "--compute_dtype", "bfloat16"]):
        args = tcli.build_argparser().parse_args(
            ["--content_dir", "c", "--style_dir", "s"] + argv)
        got = tcli.config_from_args(args)
        assert got.train.lambda_style == got.loss.default_lambda_value
        want = _jax_config(jcli, argv)
        assert got.model.to_dict() == tcfg.ModelConfig.from_dict(
            want.model.to_dict()).to_dict()
        assert got.loss.to_dict() == want.loss.to_dict()


def _jax_config(jcli, argv):
    """The ExperimentConfig JAX's eval CLI builds from ``argv``: its main
    run up to its initializer, which raises here with the config."""
    from mastermetastyletransfer_tpu import models as jmodels

    class Seen(Exception):
        pass

    def init(key, cfg):
        raise Seen(cfg)

    # JAX's split3 route sets the default matmul precision for the process
    before = jax.config.jax_default_matmul_precision
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodels, "init_master_model", init)
        try:
            jcli.main(["--content_dir", "c", "--style_dir", "s"] + argv)
        except Seen as e:
            model = e.args[0]
        finally:
            jax.config.update("jax_default_matmul_precision", before)
    lam = float(argv[argv.index("--lambda_style") + 1]) if (
        "--lambda_style" in argv) else 10.0
    return jcfg.ExperimentConfig(
        model=model, loss=jcfg.LossConfig(default_lambda_value=lam))


def test_cli_cuda_without_a_card_raises(folders):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--content_dir", folders["content"], "--style_dir",
                   folders["style"]])
