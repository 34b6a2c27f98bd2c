"""The host half of the port's data pipeline (``data/pipeline.py``,
``data/native_loader.py``) against the JAX package's on the CPU.

Images are written by PIL into ``tmp_path`` from numpy seeds. Pixels,
index streams and batch streams are held bit for bit: the port's
``_resize_bilinear`` to Pillow's BILINEAR resample, its ``_decode_resize``
(its own BMP, PNG and JPEG readers, no PIL; progressive JPEG too) to JAX's
(PIL for every file), its native loader (the port's own JPEG decoder in
place of libjpeg, the same DCT-domain prescale and resize, built with the
same flags on the same machine) to JAX's at every scale n/8 that JAX's
loop picks, baseline and progressive files of every chroma sampling, its
sampler and prefetching loader to JAX's for the same folder and seed.
"""

import os
import re
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
from PIL import Image

from mastermetastyletransfer_tpu.config import DataConfig as JDataConfig
from mastermetastyletransfer_tpu.data import native_loader as jnative
from mastermetastyletransfer_tpu.data import pipeline as jpipe
from mastermetastyletransfer_tpu_torch.config import DataConfig
from mastermetastyletransfer_tpu_torch.data import native_loader as tnative
from mastermetastyletransfer_tpu_torch.data import pipeline as tpipe
from mastermetastyletransfer_tpu_torch.utils import bmp as tbmp
from scripts import make_jpeg_fixtures
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (in H, in W) -> out, downscales, odd sizes, thin strips and upscales
RESIZE_CASES = [((96, 120), 64), ((300, 400), 128), ((517, 383), 256),
                ((33, 700), 96), ((1024, 768), 512), ((40, 40), 64),
                ((200, 200), 512), ((480, 640), 512), ((1500, 2000), 512)]


def _smooth(rng, h, w):
    """A smooth uint8 image: low-resolution noise upsampled by PIL."""
    base = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3),
                        np.uint8)
    return np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR))


def _write_bmp_topdown(path, rgb):
    """A 24-bit BMP with a negative height: rows stored top to bottom."""
    h, w, _ = rgb.shape
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = rgb[:, :, ::-1].reshape(h, w * 3)
    header = (b"BM" + np.array([54 + rows.size, 0, 54], "<u4").tobytes()
              + np.array([40, w, -h], "<i4").tobytes()
              + np.array([1, 24], "<u2").tobytes()
              + np.array([0, rows.size, 2835, 2835, 0, 0], "<u4").tobytes())
    with open(path, "wb") as f:
        f.write(header + rows.tobytes())


def _write(path, kind, rgb):
    if kind == "bmp24_topdown":
        _write_bmp_topdown(path, rgb)
    elif kind == "bmp32":
        alpha = np.full(rgb.shape[:2] + (1,), 200, np.uint8)
        Image.fromarray(np.concatenate([rgb, alpha], 2), "RGBA").save(path)
    elif kind == "jpeg":
        Image.fromarray(rgb).save(path, quality=92)
    else:
        Image.fromarray(rgb).save(path)


FORMATS = {"bmp24": ".bmp", "bmp24_topdown": ".bmp", "bmp32": ".bmp",
           "png": ".png", "jpeg": ".jpg"}


def _folder(root, n, seed, kind="bmp24", hw=(90, 110)):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        _write(os.path.join(root, f"img_{i:02d}{FORMATS[kind]}"), kind,
               _smooth(rng, *hw))
    return root


# ---------------------------------------------------------------------------
# files and index streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recursive", [False, True])
def test_list_images_matches_jax(tmp_path, recursive):
    names = ["a.JPG", "b.jpeg", "c.Png", "d.bmp", "e.WEBP", "f.txt",
             "g.gif", "h", "sub/i.jpg", "sub/deeper/j.PNG", "sub/k.tiff"]
    for name in names:
        p = tmp_path / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    got = tpipe.list_images(str(tmp_path), recursive=recursive)
    assert got == jpipe.list_images(str(tmp_path), recursive=recursive)
    want = {"a.JPG", "b.jpeg", "c.Png", "d.bmp", "e.WEBP"}
    if recursive:
        want |= {"sub/i.jpg", "sub/deeper/j.PNG"}
    assert {os.path.relpath(f, tmp_path) for f in got} == want


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 3), (40, 11)])
def test_sampler_matches_jax(n, seed):
    got, want = (iter(s.InfiniteIndexSampler(n, seed)) for s in (tpipe, jpipe))
    a = [next(got) for _ in range(3 * n)]
    assert a == [next(want) for _ in range(3 * n)]
    for epoch in range(3):
        assert sorted(a[epoch * n:(epoch + 1) * n]) == list(range(n))
    with pytest.raises(ValueError):
        tpipe.InfiniteIndexSampler(0)


# ---------------------------------------------------------------------------
# decode and resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,size", RESIZE_CASES,
                         ids=[f"{h}x{w}-{s}" for (h, w), s in RESIZE_CASES])
def test_resize_bilinear_equals_pillow(shape, size):
    rng = np.random.default_rng(shape[0] * 7 + size)
    img = rng.integers(0, 256, shape + (3,), np.uint8)
    got = tpipe._resize_bilinear(img, size)
    want = np.asarray(Image.fromarray(img).resize((size, size),
                                                  Image.BILINEAR))
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    assert np.array_equal(got, want)


def test_resize_bilinear_keeps_an_unchanged_side():
    """A side that keeps its size is not resampled (Pillow skips the pass),
    so the image comes back as it was."""
    img = np.random.default_rng(1).integers(0, 256, (64, 64, 3), np.uint8)
    assert np.array_equal(tpipe._resize_bilinear(img, 64), img)
    tall = np.random.default_rng(2).integers(0, 256, (80, 64, 3), np.uint8)
    want = np.asarray(Image.fromarray(tall).resize((64, 64), Image.BILINEAR))
    assert np.array_equal(tpipe._resize_bilinear(tall, 64), want)


@pytest.mark.parametrize("kind", list(FORMATS))
def test_decode_resize_matches_jax(tmp_path, kind):
    rgb = _smooth(np.random.default_rng(5), 75, 97)
    path = str(tmp_path / f"x{FORMATS[kind]}")
    _write(path, kind, rgb)
    for size in (48, 128):
        got = tpipe._decode_resize(path, size)
        assert got.shape == (size, size, 3) and got.dtype == np.uint8
        assert np.array_equal(got, jpipe._decode_resize(path, size))


def test_read_bmp_takes_only_uncompressed_rgb(tmp_path):
    """Uncompressed 24- and 32-bit files read to their pixels, and what
    once was refused reads to PIL's: PIL's 8-bit palette BMP, PIL's 1-bit
    and grey ones, through ``utils/bmp.read_bmp`` and ``decode_image``.
    A file that is not a BMP is refused by ``read_bmp`` (``decode_image``
    reads it as what it is); a BMP header the reader does not take (none
    at all) raises, and PIL refuses it too."""
    rgb = _smooth(np.random.default_rng(6), 21, 13)
    for kind in ("bmp24", "bmp24_topdown", "bmp32"):
        path = tmp_path / f"{kind}.bmp"
        _write(str(path), kind, rgb)
        assert np.array_equal(tbmp.read_bmp(path.read_bytes()), rgb)
        assert np.array_equal(tpipe.decode_image(path.read_bytes()), rgb)
    for mode in ("P", "1", "L"):
        path = tmp_path / f"{mode}.bmp"
        Image.fromarray(rgb).convert(mode).save(path)
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        assert np.array_equal(tbmp.read_bmp(path.read_bytes()), want)
        assert np.array_equal(tpipe.decode_image(path.read_bytes()), want)
    Image.fromarray(rgb).save(tmp_path / "x.png")
    with pytest.raises(ValueError, match="not a BMP"):
        tbmp.read_bmp((tmp_path / "x.png").read_bytes())
    assert np.array_equal(
        tpipe.decode_image((tmp_path / "x.png").read_bytes()), rgb)
    for read in (tbmp.read_bmp, tpipe.decode_image):
        with pytest.raises(ValueError, match="BMP"):
            read(b"BM" + bytes(20))


_NO_PIL = textwrap.dedent(r"""
    import importlib.abc, sys
    import numpy as np

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("PIL", "jax", "jaxlib",
                                      "mastermetastyletransfer_tpu"):
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    from mastermetastyletransfer_tpu_torch.data import pipeline
    folder, size = sys.argv[1], int(sys.argv[2])
    for name in ("a24.bmp", "b32.bmp", "c24_topdown.bmp", "d.png", "e.jpg",
                 "f.webp", "g.jpg", "i.gif", "j.tif", "k.ppm", "l.ico"):
        np.save(f"{folder}/{name}.npy",
                pipeline._decode_resize(f"{folder}/{name}", size))
    for name in ("h.pcx",):
        try:
            pipeline._decode_resize(f"{folder}/{name}", size)
        except ValueError as e:
            print("ERROR", name, e)
""")


def test_decode_resize_without_pil(tmp_path):
    """With PIL (and JAX) refused, BMP, PNG, JPEG, WebP, GIF, TIFF (LZW),
    PPM and ICO files, a progressive JPEG among them, give JAX's arrays; a
    PCX file (a kind the port does not read) raises ValueError naming the
    file and what is read."""
    rng = np.random.default_rng(7)
    files = {"a24.bmp": "bmp24", "b32.bmp": "bmp32",
             "c24_topdown.bmp": "bmp24_topdown", "d.png": "png",
             "e.jpg": "jpeg"}
    for name, kind in files.items():
        _write(str(tmp_path / name), kind, _smooth(rng, 70, 90))
    Image.fromarray(_smooth(rng, 30, 40)).save(tmp_path / "f.webp")
    files["f.webp"] = "webp"
    Image.fromarray(_smooth(rng, 30, 40)).save(tmp_path / "g.jpg",
                                               progressive=True)
    files["g.jpg"] = "progressive jpeg"
    Image.fromarray(_smooth(rng, 30, 40)).save(tmp_path / "h.pcx")
    for name, kw in (("i.gif", {}), ("j.tif", {"compression": "tiff_lzw"}),
                     ("k.ppm", {}), ("l.ico", {"sizes": [(16, 16), (24, 24)]})):
        Image.fromarray(_smooth(rng, 30, 40)).save(tmp_path / name, **kw)
        files[name] = name[2:]
    proc = subprocess.run(
        [sys.executable, "-c", _NO_PIL, str(tmp_path), "64"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for name in files:
        got = np.load(tmp_path / f"{name}.npy")
        assert np.array_equal(got, jpipe._decode_resize(
            str(tmp_path / name), 64)), name
    errors = [line for line in proc.stdout.splitlines()
              if line.startswith("ERROR")]
    assert len(errors) == 1, proc.stdout
    assert str(tmp_path / "h.pcx") in errors[0]
    assert "baseline JPEG" in errors[0] and "progressive JPEG" in errors[0]
    assert "WebP" in errors[0]


# ---------------------------------------------------------------------------
# the native loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def native_built():
    """The port's library, built here with JAX's flags less libjpeg, into
    build/ and not under either package (JAX's links libjpeg)."""
    assert tnative.native_available(), "the native loader did not build"
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR and path.exists()
    assert "mastermetastyletransfer_tpu" not in path.parent.name
    assert jnative.native_available()
    return path


def test_native_loader_matches_jax(tmp_path, native_built):
    """Bit for bit with JAX's loader at a size it decodes at full size
    (288: over 7/8 of the 300-pixel side) and at 96 and 256, where it
    prescales (to 3/8 and 7/8)."""
    folder = _folder(str(tmp_path), 5, seed=8, kind="jpeg", hw=(300, 400))
    paths = tpipe.list_images(folder)
    for size in (288, 96, 256):
        got = tnative.decode_resize_batch(paths, size, n_threads=3)
        assert got.shape == (5, size, size, 3)
        assert np.array_equal(got, jnative.decode_resize_batch(paths, size))


def _sampled(rgb, sub, progressive):
    """PIL's JPEG of ``rgb`` at one chroma sampling: 0, 1, 2 (4:4:4,
    4:2:2, 4:2:0), "440" (the transposed 4:2:2 file with its frame header
    rewritten, scripts/make_jpeg_fixtures.py) or "gray"."""
    kw = dict(quality=90, progressive=progressive)
    if sub == "gray":
        return make_jpeg_fixtures.jpeg(
            np.asarray(Image.fromarray(rgb).convert("L")), **kw)
    if sub == "440":
        return make_jpeg_fixtures.as_440(make_jpeg_fixtures.jpeg(
            np.ascontiguousarray(rgb.transpose(1, 0, 2)), subsampling=1,
            **kw))
    return make_jpeg_fixtures.jpeg(rgb, subsampling=sub, **kw)


@pytest.mark.parametrize("sub", [0, 1, 2, "440", "gray"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_native_loader_matches_jax_at_every_scale(tmp_path, native_built,
                                                  sub, progressive):
    """At targets that make JAX's loader decode at each n/8, n = 1..8,
    bit for bit with it, for two odd-sized files of one sampling."""
    rng = np.random.default_rng(30 + (sub if isinstance(sub, int) else 5))
    paths = []
    for i, hw in enumerate(((203, 157), (150, 232))):
        path = str(tmp_path / f"x{i}.jpg")
        with open(path, "wb") as f:
            f.write(_sampled(_smooth(rng, *hw), sub, progressive))
        paths.append(path)
    for h, w in ((203, 157), (150, 232)):
        for t in make_jpeg_fixtures.prescale_targets(w, h):
            got = tnative.decode_resize_batch(paths, t, n_threads=2)
            want = jnative.decode_resize_batch(paths, t)
            assert np.array_equal(got, want), (sub, progressive, t)


_NO_SIMD = textwrap.dedent(r"""
    import sys
    import numpy as np
    from mastermetastyletransfer_tpu.data import native_loader as jnative
    from mastermetastyletransfer_tpu_torch.data import native_loader as tn
    from scripts import make_jpeg_fixtures
    paths = sys.argv[1:]
    differ = 0
    for t in make_jpeg_fixtures.prescale_targets(157, 150):
        differ += int(np.count_nonzero(tn.decode_resize_batch(paths, t)
                                       != jnative.decode_resize_batch(
                                           paths, t)))
    print("DIFFER", differ)
""")


def test_native_loader_matches_jax_without_simd(tmp_path, native_built):
    """libjpeg-turbo's SIMD IDCTs off (``JSIMD_FORCENONE=1``, its C
    routines: jidctred.c's 2 x 2 and 4 x 4 among them) the JAX loader
    still gives the port's batches at every n, for every sampling."""
    rng = np.random.default_rng(40)
    paths = []
    for i, (sub, prog) in enumerate(((0, True), (1, False), (2, True),
                                     ("440", True), ("gray", False))):
        paths.append(str(tmp_path / f"x{i}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(_sampled(_smooth(rng, 150, 157), sub, prog))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_SIMD, *paths], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "JSIMD_FORCENONE": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "DIFFER 0" in proc.stdout, proc.stdout


def test_native_loader_sends_other_files_through_decode_resize(
        tmp_path, native_built):
    folder = _folder(str(tmp_path), 2, seed=9, kind="jpeg")
    png = str(tmp_path / "z.png")
    bmp = str(tmp_path / "z.bmp")
    rgb = _smooth(np.random.default_rng(10), 50, 60)
    _write(png, "png", rgb)
    _write(bmp, "bmp24", rgb)
    paths = tpipe.list_images(folder, recursive=False)[:2] + [png, bmp]
    got = tnative.decode_resize_batch(paths, 64)
    assert np.array_equal(got[2], tpipe._decode_resize(png, 64))
    assert np.array_equal(got[3], tpipe._decode_resize(bmp, 64))
    assert np.array_equal(got[2:], jnative.decode_resize_batch(paths,
                                                               64)[2:])
    # the JPEGs as JAX's at 64 (where its loader decodes at 6/8) and at 100
    # (over 7/8 of the 90-pixel side: at full size)
    assert np.array_equal(got[:2], jnative.decode_resize_batch(paths,
                                                               64)[:2])
    assert np.array_equal(tnative.decode_resize_batch(paths, 100),
                          jnative.decode_resize_batch(paths, 100))


def test_native_loader_unavailable_decodes_every_file(tmp_path, monkeypatch):
    """Where the library does not build, every file goes through
    ``_decode_resize``, and the dataset's batches still equal JAX's."""
    folder = _folder(str(tmp_path), 3, seed=12, kind="png")
    monkeypatch.setattr(tnative, "_load_library", lambda: None)
    paths = tpipe.list_images(folder)
    want = np.stack([jpipe._decode_resize(p, 40) for p in paths])
    assert np.array_equal(tnative.decode_resize_batch(paths, 40), want)
    ds = tpipe.ImageFolderDataset(folder, resize_to=40)
    assert np.array_equal(ds.get_batch([0, 1, 2]), want)


# ---------------------------------------------------------------------------
# datasets and the prefetching loader
# ---------------------------------------------------------------------------

def _take(loader, n):
    try:
        return [next(loader).copy() for _ in range(n)]
    finally:
        loader.close()


@pytest.mark.parametrize("workers", [1, 4])
def test_prefetch_loader_matches_jax(tmp_path, workers):
    """The first 5 batches for the same folder and seed, BMP files (the
    port's numpy route against JAX's PIL one), with 1 worker and with 4."""
    folder = _folder(str(tmp_path), 7, seed=13)
    got = _take(tpipe.PrefetchLoader(
        tpipe.ImageFolderDataset(folder, resize_to=48), batch_size=3,
        num_workers=workers, seed=5), 5)
    want = _take(jpipe.PrefetchLoader(
        jpipe.ImageFolderDataset(folder, resize_to=48), batch_size=3,
        num_workers=1, seed=5), 5)
    for a, b in zip(got, want):
        assert a.shape == (3, 48, 48, 3)
        assert np.array_equal(a, b)


def test_make_train_iterators_match_jax(tmp_path):
    """The content (flat) and style (recursive) streams of one DataConfig,
    and their sizes and seeds, as JAX's."""
    cdir = _folder(str(tmp_path / "c"), 5, seed=14)
    _folder(str(tmp_path / "c" / "nested"), 2, seed=15)    # not listed
    sdir = _folder(str(tmp_path / "s"), 2, seed=16)
    _folder(str(tmp_path / "s" / "artist"), 2, seed=17)
    fields = dict(content_dir=cdir, style_dir=sdir, batch_size_content=2,
                  batch_size_style=1, resize_to=40, num_workers=2, seed=3)
    got = tpipe.make_train_iterators(DataConfig(**fields))
    want = jpipe.make_train_iterators(JDataConfig(**fields))
    assert len(got[0].dataset) == 5 and len(got[1].dataset) == 4
    for g, w in zip(got, want):
        for a, b in zip(_take(g, 4), _take(w, 4)):
            assert np.array_equal(a, b)


def test_prefetch_loader_surfaces_a_failing_file(tmp_path):
    """A file that fails to decode raises at the consumer, naming the
    batch's indices, instead of ending its worker and hanging the loader."""
    folder = _folder(str(tmp_path), 4, seed=18)
    ds = tpipe.ImageFolderDataset(folder, resize_to=32, use_native=False)
    with open(ds.files[2], "wb") as f:
        f.write(b"BM not an image")
    loader = tpipe.PrefetchLoader(ds, batch_size=2, num_workers=2, seed=0)
    try:
        with pytest.raises(RuntimeError, match=r"dataset indices \[.*2"):
            for _ in range(8):      # index 2 comes within the first epoch
                next(loader)
    finally:
        loader.close()


def test_prefetch_loader_bounded_when_consumer_stalls(tmp_path):
    """With the consumer stalled, the producer and workers stop at
    prefetch + num_workers batches ahead (plus the task queue in
    flight)."""
    folder = _folder(str(tmp_path), 10, seed=19)
    ds = tpipe.ImageFolderDataset(folder, resize_to=32)
    loader = tpipe.PrefetchLoader(ds, batch_size=2, num_workers=3, seed=0,
                                  prefetch=2)
    try:
        next(loader)
        time.sleep(2.0)
        with loader._cond:
            backlog = len(loader._results)
        assert backlog <= 2 + 3 + 2, backlog
    finally:
        loader.close()
    for t in loader._threads:
        t.join(timeout=5)
        assert not t.is_alive()


@pytest.mark.parametrize("empty", ["content", "style"])
def test_empty_folders_raise(tmp_path, empty):
    cdir = str(tmp_path / "c")
    sdir = str(tmp_path / "s")
    os.makedirs(cdir)
    os.makedirs(sdir)
    _folder(sdir if empty == "content" else cdir, 2, seed=20)
    cfg = DataConfig(content_dir=cdir, style_dir=sdir)
    with pytest.raises(FileNotFoundError, match=re.escape(
            cdir if empty == "content" else sdir)):
        tpipe.make_train_iterators(cfg)
