"""The loss calibration of the port (``losses/calibrate.py``) against the
JAX package's on the CPU: one BMP triplet at 48^2, plain and BN VGG19
state dicts as torchvision initializes them, converted by each package.

The rows have JAX's keys and order. Each value is held to a float64
evaluation of the same loss (``_sweep64``: the port's VGG19 on float64
weights, the losses in numpy): within 1e-5 relative of it; and to JAX's
within 1e-5 relative plus JAX's own distance from it. JAX's float32 content
loss lands about 1e-5 from the float64 value on these weights (up to
1.1e-5; with tests/test_torch_trainer.py's random biases and BN statistics,
1.8e-5), the port's within 2.1e-7 (up to 9.2e-6 on those), so the two
float32 losses can differ by a little over 1e-5. ``--render`` writes a PNG
where matplotlib imports, and exits before any work, naming matplotlib,
where it does not.
"""

import io
import itertools
import json
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from PIL import Image

from mastermetastyletransfer_tpu.utils import convert as jconvert
from mastermetastyletransfer_tpu_torch.losses import calibrate as tcal
from mastermetastyletransfer_tpu_torch.losses.vgg import vgg19_features_apply
from mastermetastyletransfer_tpu_torch.models.master import imagenet_normalize
from mastermetastyletransfer_tpu_torch.utils import checkpoint as tckpt
from mastermetastyletransfer_tpu_torch.utils import convert as tconvert
from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE, TOL_REL = 48, 1e-5


def _jax_calibrate():
    """JAX's calibrate module, imported with its persistent compilation
    cache kept off (it would write under the repository)."""
    from mastermetastyletransfer_tpu.utils import cache

    enable = cache.enable_compilation_cache
    cache.enable_compilation_cache = lambda path=None: None
    try:
        from mastermetastyletransfer_tpu.losses import calibrate
    finally:
        cache.enable_compilation_cache = enable
    return calibrate


def _tv_vgg_state_dict(bn: bool) -> dict:
    """A vgg19(_bn).features state dict as torchvision initializes it:
    kaiming-normal convs (fan_out, relu), zero biases; batch norm with
    weight 1, bias 0 and fresh running statistics (mean 0, var 1)."""
    g = torch.Generator().manual_seed(10 + int(bn))
    idxs = (tconvert._VGG19_BN_CONV_IDX if bn
            else tconvert._VGG19_CONV_IDX)
    chans = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
             (256, 256), (256, 256), (256, 256), (256, 512), (512, 512),
             (512, 512), (512, 512), (512, 512)]
    sd = {}
    for i, (cin, cout) in zip(idxs, chans):
        sd[f"features.{i}.weight"] = torch.randn(
            (cout, cin, 3, 3), generator=g) * (2.0 / (cout * 9)) ** 0.5
        sd[f"features.{i}.bias"] = torch.zeros(cout)
        if bn:
            sd[f"features.{i + 1}.weight"] = torch.ones(cout)
            sd[f"features.{i + 1}.bias"] = torch.zeros(cout)
            sd[f"features.{i + 1}.running_mean"] = torch.zeros(cout)
            sd[f"features.{i + 1}.running_var"] = torch.ones(cout)
            sd[f"features.{i + 1}.num_batches_tracked"] = torch.tensor(0)
    return sd


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A content/style/output BMP triplet, the two VGGs as torchvision .pt
    files and as the port's .npz exports."""
    root = tmp_path_factory.mktemp("calibrate")
    rng = np.random.default_rng(0)
    out = {}
    for i, name in enumerate(("content", "style", "output")):
        out[name] = str(root / f"{name}.bmp")
        Image.fromarray(rng.integers(0, 256, (60 + 4 * i, 50, 3),
                                     np.uint8)).save(out[name])
    for bn in (False, True):
        tag = "bn" if bn else "plain"
        pt = str(root / f"vgg_{tag}.pt")
        torch.save(_tv_vgg_state_dict(bn), pt)
        npz = str(root / f"vgg_{tag}.npz")
        tckpt.save_params_npz(npz, tconvert.convert_vgg19(
            tconvert.load_torch_state_dict(pt), use_batchnorm=bn))
        out[f"{tag}_pt"], out[f"{tag}_npz"] = pt, npz
    out["root"] = root
    return out


def _sweep64(imgs, vggs, *, lambda_value, compute_similarity):
    """The sweep's rows in float64: the port's VGG19 on float64 weights and
    images, then the losses in numpy (reference: codes/loss.py:284-334)."""
    def inorm(f):
        m = f.mean((1, 2), keepdims=True)
        return (f - m) / np.sqrt(((f - m) ** 2).mean((1, 2), keepdims=True)
                                 + 1e-5)

    def mean_std(f):
        ff = f.reshape(f.shape[0], -1, f.shape[-1])
        return ff.mean(1), ff.std(1, ddof=1)

    def self_cos(f):
        x = f.reshape(f.shape[0], -1, f.shape[-1])
        n = np.maximum(np.linalg.norm(x, axis=-1), 1e-8)
        sim = x @ x.transpose(0, 2, 1) / (n[:, :, None] * n[:, None, :])
        sim = sim / (sim.sum(1, keepdims=True) + 1e-6)
        return np.tril(sim, -1)

    rows = []
    for (kind, vgg), norm in itertools.product(vggs.items(), [False, True]):
        v64 = tree_map(lambda t: t.double(), vgg)
        x = torch.from_numpy(np.stack(imgs).astype(np.float64))
        if norm:
            x = imagenet_normalize(x)
        with torch.no_grad():
            fc, fs, fo = zip(*[(f[0], f[1], f[2]) for f in (
                f.numpy() for f in vgg19_features_apply(v64, x))])
        for dist in ("euclidian", "euclidian_squared"):
            d = ((lambda a: (a * a).mean()) if dist == "euclidian_squared"
                 else (lambda a: np.abs(a).mean()))
            content = sum(d(inorm(c[None]) - inorm(o[None]))
                          for c, o in zip(fc, fo))
            style = 0.0
            for a, b in zip(fs, fo):
                (ma, sa), (mb, sb) = mean_std(a[None]), mean_std(b[None])
                style += d(ma - mb) + d(sa - sb)
            row = {"vgg": kind, "distance": dist, "imagenet_norm": norm,
                   "content": content, "style": style,
                   "total": content + lambda_value * style}
            if compute_similarity:
                row["similarity"] = sum(d(self_cos(fc[i][None])
                                          - self_cos(fo[i][None]))
                                        for i in (1, 2))
            rows.append(row)
    # the sweep's order: kind, then distance, then normalization
    return sorted(rows, key=lambda r: (list(vggs).index(r["vgg"]),
                                       r["distance"], r["imagenet_norm"]))


def _rows_close(got, want, ref):
    """The port's rows against JAX's and the float64 rows."""
    assert len(got) == len(want) == len(ref)
    for g, w, r in zip(got, want, ref):
        assert list(g) == list(w)
        for key, v in w.items():
            if isinstance(v, float):
                assert abs(g[key] - r[key]) <= TOL_REL * abs(r[key]), (
                    w, key, abs(g[key] - r[key]) / abs(r[key]))
                err = abs(g[key] - v)
                assert err <= TOL_REL * abs(v) + abs(v - r[key]), (
                    w, key, err / abs(v), abs(v - r[key]) / abs(v))
            else:
                assert g[key] == v, key


KW = dict(lambda_value=4.0, compute_similarity=True)


@pytest.fixture(scope="module")
def reference(files):
    """The triplet as the command line reads it, the port's VGG trees and
    the float64 rows."""
    imgs = [tcal._load_images(files[n], SIZE)[0]
            for n in ("content", "style", "output")]
    vggs = {kind: tconvert.convert_vgg19(tconvert.load_torch_state_dict(
        files[f"{kind}_pt"]), use_batchnorm=kind == "bn")
        for kind in ("plain", "bn")}
    return dict(imgs=imgs, vggs=vggs, rows=_sweep64(imgs, vggs, **KW))


def test_run_sweep_matches_jax(files, reference):
    jcal = _jax_calibrate()
    imgs, vggs_t = reference["imgs"], reference["vggs"]
    vggs_j = {kind: jconvert.convert_vgg19(tconvert.load_torch_state_dict(
        files[f"{kind}_pt"]), use_batchnorm=kind == "bn")
        for kind in ("plain", "bn")}
    got = tcal.run_sweep(*imgs, vgg_params_by_kind=vggs_t, **KW)
    want = jcal.run_sweep(*imgs, vgg_params_by_kind=vggs_j, **KW)
    assert [(r["vgg"], r["distance"], r["imagenet_norm"]) for r in got] == [
        (v, d, n) for v in ("plain", "bn")
        for d in ("euclidian", "euclidian_squared") for n in (False, True)]
    _rows_close(got, want, reference["rows"])


def _main(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue()[:buf.getvalue().rindex("]") + 1])


def _argv(files, plain, bn):
    return ["--content", files["content"], "--style", files["style"],
            "--output", files["output"], "--image_size", str(SIZE),
            "--vgg_weights", files[plain], "--vgg_bn_weights", files[bn],
            "--compute_similarity", "--lambda_value", "4"]


def test_main_matches_jax(files, reference):
    """The command lines on the same files (.npz weights: JAX's reads a
    vgg19_bn .pt as a plain VGG19 and fails on its keys); the port's from
    the torchvision .pt files gives the same rows exactly."""
    want = _main(_jax_calibrate().main, _argv(files, "plain_npz", "bn_npz"))
    got = _main(tcal.main, _argv(files, "plain_npz", "bn_npz")
                + ["--device", "cpu"])
    assert len(got) == 8 and all(r.pop("triplet") == 0 for r in got)
    assert all(r.pop("triplet") == 0 for r in want)
    _rows_close(got, want, reference["rows"])
    from_pt = _main(tcal.main, _argv(files, "plain_pt", "bn_pt")
                    + ["--device", "cpu"])
    assert [dict(r, triplet=0) for r in got] == from_pt


def test_render_writes_a_png(files):
    pytest.importorskip("matplotlib")
    path = str(files["root"] / "grid.png")
    _main(tcal.main, _argv(files, "plain_npz", "bn_npz")
          + ["--device", "cpu", "--render", path])
    with Image.open(path) as im:
        assert im.format == "PNG" and im.size[0] > 100


def test_render_without_matplotlib_exits_first(files, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)

    def no_work(*args, **kwargs):
        raise AssertionError("the sweep started")

    monkeypatch.setattr(tcal, "load_vgg_params", no_work)
    with pytest.raises(SystemExit, match="matplotlib"):
        tcal.main(_argv(files, "plain_npz", "bn_npz")
                  + ["--device", "cpu", "--render", "grid.png"])


def test_cuda_without_a_card_raises(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcal.main(_argv(files, "plain_npz", "bn_npz"))
