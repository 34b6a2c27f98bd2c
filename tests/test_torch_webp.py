"""The port's WebP decoder (``native/webp.cpp`` through
``data/native_loader.decode_webp`` and ``data/pipeline.decode_image``)
against PIL and the JAX package's readers on the CPU. Pillow opens every
WebP through libwebp's animation decoder and takes its first canvas; the
port must give its ``convert("RGB")`` with 0 values differing.

* every fixture of tests/data/webp/ (scripts/make_webp_fixtures.py: lossy
  at each quality and method, lossy with alpha, lossless with each
  transform and bundling width, the simple and normal loop filters,
  sharpness, one segment, 8 token partitions, near-lossless, each ALPH
  filter and compression, animations, one with its first frame at an
  offset) to the stored pixels and to PIL's;
* a seeded sweep of PIL-encoded files: odd sizes (1x1, 1x17, 17x1, 33x47,
  257x131) at qualities 0-100 and methods 0 and 6, with and without alpha;
  lossless photos and 2, 4, 16 and 256 colours, ``exact`` on and off;
  animations;
* the port's ``_decode_resize``, ``ImageFolderDataset`` batches (WebP
  beside JPEG) and ``serve._decode_to`` to the JAX package's arrays; a
  folder of WebP contents and styles through the port's trainer; a WebP
  ``/stylize`` body answered 200 by the port's server with the reply of
  the same pixels sent as PNG;
* refusals: a bomb (a VP8X canvas, a VP8L header) refused before anything
  of its size is allocated, named refusals that PIL refuses too, and
  truncations and byte flips of every fixture, decoded in a subprocess (a
  crash fails the test and spares the test worker): each either refused by
  ``ValueError`` where PIL refuses it, or decoded to PIL's pixels.
"""

import glob
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import tracemalloc
import urllib.error
import urllib.request
import warnings
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from mastermetastyletransfer_tpu import serve as jserve
from mastermetastyletransfer_tpu.data import pipeline as jpipe
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch import serve as tserve
from mastermetastyletransfer_tpu_torch.data import native_loader as tnative
from mastermetastyletransfer_tpu_torch.data import pipeline as tpipe
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from scripts import make_webp_fixtures as fx
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "webp")
NAMES = sorted(os.path.basename(p)[:-5]
               for p in glob.glob(os.path.join(DATA, "*.webp")))
SIZES = [(1, 1), (1, 17), (17, 1), (33, 47), (257, 131)]


def _read(name: str) -> bytes:
    with open(os.path.join(DATA, f"{name}.webp"), "rb") as f:
        return f.read()


def _pil(data: bytes):
    """PIL's convert("RGB") of the bytes, or None where PIL refuses them."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(io.BytesIO(data)) as im:
                return np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 - any refusal of PIL's
        return None


def _assert_pil_pixels(data: bytes, label) -> None:
    want = _pil(data)
    assert want is not None, label
    got = tpipe.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, label
    assert np.count_nonzero(got != want) == 0, label


def test_every_fixture_is_in_pixels():
    stored = np.load(os.path.join(DATA, "pixels.npz"))
    assert sorted(stored.files) == NAMES and len(NAMES) >= 30


@pytest.mark.parametrize("name", NAMES)
def test_fixture_matches_pil(name):
    data = _read(name)
    want = np.load(os.path.join(DATA, "pixels.npz"))[name]
    assert np.array_equal(_pil(data), want)    # PIL still decodes it so
    got = tnative.decode_webp(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.count_nonzero(got != want) == 0
    assert np.array_equal(tpipe.decode_image(data), got)


def test_fixtures_cover_the_kinds():
    """The chunk layout each fixture name promises (ALPH's filter and
    compression bits, an animation's first frame offset)."""
    def alph(data):
        return data[data.find(b"ALPH") + 8]
    assert alph(_read("alpha_raw")) & 3 == 0
    for name, filt in (("none", 0), ("horizontal", 1), ("vertical", 2),
                       ("gradient", 3)):
        header = alph(_read(f"alpha_lossless_{name}"))
        assert header & 3 == 1 and (header >> 2) & 3 == filt, name
    data = _read("anim_offset")
    anmf = data.find(b"ANMF") + 8
    assert (int.from_bytes(data[anmf:anmf + 3], "little") * 2,
            int.from_bytes(data[anmf + 3:anmf + 6], "little") * 2) == (12, 20)
    assert _read("trainer_lossless")[12:16] == b"VP8L"
    assert alph(_read("trainer_lossy_alpha")) & 3 == 1
    for name in ("lossless_2c", "lossless_4c", "lossless_16c",
                 "lossless_256c"):
        assert _read(name)[12:16] == b"VP8L"


@pytest.mark.parametrize("hw", SIZES)
def test_lossy_sweep_matches_pil(hw):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    for quality in (0, 50, 75, 95, 100):
        for method in (0, 6):
            img = fx.smooth(rng, *hw)
            _assert_pil_pixels(fx.pil_webp(img, quality=quality,
                                           method=method),
                               (hw, quality, method))
            rgba = fx.with_alpha(rng, img)
            _assert_pil_pixels(fx.pil_webp(rgba, quality=quality,
                                           method=method, exact=method == 6),
                               (hw, quality, method, "alpha"))


@pytest.mark.parametrize("colors", [2, 4, 16, 256, None])
def test_lossless_sweep_matches_pil(colors):
    """None: photo-like (the predictor and cross-colour transforms)."""
    rng = np.random.default_rng(colors or 1)
    for hw in SIZES:
        for channels in (3, 4):
            for exact in (False, True):
                if colors is None:
                    img = fx.smooth(rng, *hw, c=channels, noise=20)
                else:
                    img = fx.paletted(rng, *hw, colors, channels)
                _assert_pil_pixels(fx.pil_webp(img, lossless=True,
                                               exact=exact),
                                   (hw, colors, channels, exact))
    img = (fx.smooth(rng, 64, 96, noise=20) if colors is None
           else fx.paletted(rng, 64, 96, colors, 3))
    for method in (0, 6):
        _assert_pil_pixels(fx.pil_webp(img, lossless=True, method=method,
                                       quality=100), (colors, method))


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha"])
def test_animation_sweep_matches_pil(kind):
    rng = np.random.default_rng(len(kind))
    for n in (2, 4):
        frames = [fx.smooth(rng, 31, 45) for _ in range(n)]
        if kind == "alpha":
            frames = [fx.with_alpha(rng, f) for f in frames]
        kw = {"lossless": True} if kind == "lossless" else {"quality": 60}
        _assert_pil_pixels(fx.pil_animation(frames, **kw), (kind, n))


# ---------------------------------------------------------------------------
# the entry points against the JAX package's
# ---------------------------------------------------------------------------

RESIZED = ["lossy_q75_m0", "lossless_photo", "lossy_alpha", "anim_offset",
           "lossless_16c", "trainer_lossless"]


@pytest.mark.parametrize("name", RESIZED)
def test_decode_resize_matches_jax(name):
    path = os.path.join(DATA, f"{name}.webp")
    for size in (32, 100):
        assert np.array_equal(tpipe._decode_resize(path, size),
                              jpipe._decode_resize(path, size)), size


@pytest.mark.parametrize("size", [64, 128])
def test_decode_to_matches_jax(size):
    for name in RESIZED:
        data = _read(name)
        got = tserve._decode_to(size, data)
        assert got.dtype == np.float32 and got.shape == (size, size, 3)
        assert np.array_equal(got, jserve._decode_to(size, data)), name


def _mixed_folder(root: str) -> str:
    """WebP fixtures beside two JPEGs (PIL's) and a PNG."""
    os.makedirs(root)
    for name in ("lossy_q50_m6", "lossless_photo", "lossy_alpha",
                 "animated", "trainer_lossy_alpha"):
        shutil.copy(os.path.join(DATA, f"{name}.webp"), root)
    rng = np.random.default_rng(3)
    for i, hw in enumerate(((70, 90), (300, 400))):
        Image.fromarray(fx.smooth(rng, *hw)).save(
            os.path.join(root, f"j{i}.jpg"), quality=90)
    Image.fromarray(fx.smooth(rng, 50, 40)).save(os.path.join(root, "p.png"))
    return root


def test_dataset_batch_matches_jax(tmp_path):
    folder = _mixed_folder(str(tmp_path / "mixed"))
    t = tpipe.ImageFolderDataset(folder, resize_to=48)
    j = jpipe.ImageFolderDataset(folder, resize_to=48)
    assert t.files == j.files and len(t.files) == 8
    idx = list(range(len(t.files)))
    want = j.get_batch(idx)
    assert np.array_equal(t.get_batch(idx), want)
    assert np.array_equal(tnative.decode_resize_batch(t.files, 48), want)
    # each file alone as JAX reads it alone (a JPEG's batch is prescaled)
    for i in idx:
        assert np.array_equal(t[i], j[i]), t.files[i]
        if not t.files[i].endswith(".jpg"):
            assert np.array_equal(t[i], want[i]), t.files[i]


def _narrow_cfg() -> tcfg.ModelConfig:
    m = tcfg.ModelConfig()
    return m.replace(
        swin=tcfg.SwinConfig(variant="swin_custom", embed_dim=32,
                             num_heads=(2, 4)),
        transformer=m.transformer.replace(
            encoder_dim=64, decoder_dim=64, encoder_num_heads=4,
            decoder_num_heads=4),
        decoder=m.decoder.replace(channel_dim=64))


def test_trainer_trains_on_webp_folders(tmp_path):
    """The trainer's plain mode on content and style folders of WebP files
    (a JPEG and a PNG among the contents): the steps run and their losses
    are finite."""
    from mastermetastyletransfer_tpu_torch.train import trainer

    cdir = _mixed_folder(str(tmp_path / "c"))
    sdir = str(tmp_path / "s")
    os.makedirs(sdir)
    for name in ("lossless_256c", "anim_offset_lossless", "near_lossless"):
        shutil.copy(os.path.join(DATA, f"{name}.webp"), sdir)
    cfg = tcfg.ExperimentConfig(
        model=_narrow_cfg().with_kernels(),
        data=tcfg.DataConfig(content_dir=cdir, style_dir=sdir,
                             batch_size_content=2, resize_to=40, crop_to=32,
                             num_workers=2, seed=0),
        train=tcfg.TrainConfig(mode="plain", max_iterations=2, max_layers=1,
                               save_every=1000, save_every_for_model=1000,
                               seed=0))
    metrics = trainer.train(cfg, exp_dir=str(tmp_path / "exp"), log_every=1,
                            device="cpu", dump_images=False)
    with open(os.path.join(tmp_path, "exp", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert len(logged) == 2
    assert all(np.isfinite(m["total"]) for m in logged), logged
    assert np.isfinite(metrics["total"])


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------

def _multipart(fields: dict) -> bytes:
    body = b"".join(
        b"--XB\r\nContent-Disposition: form-data; name=\"%s\"; "
        b"filename=\"x\"\r\n\r\n" % name.encode() + data + b"\r\n"
        for name, data in fields.items())
    return body + b"--XB--\r\n"


def _post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "multipart/form-data; boundary=XB"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _png(pixels: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "PNG")
    return buf.getvalue()


def test_stylize_webp_body_is_served():
    """WebP bodies (lossy with alpha, lossless, an animation) get 200 from
    the port's server, each reply equal to the reply for the same pixels
    sent as PNG; a truncated WebP body gets 400 naming the reason."""
    cfg = _narrow_cfg()
    params = init_master_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    svc = tserve.StylizeService(params, cfg, size=64, k=1, max_batch=1,
                                device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                tserve.make_handler({1: svc}, default_k=1))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/stylize"
    try:
        style = _read("lossless_photo")
        for name in ("lossy_alpha", "trainer_lossless", "anim_offset"):
            content = _read(name)
            code, ctype, webp_reply = _post(url, _multipart(
                {"content": content, "style": style}))
            assert code == 200 and ctype == "image/jpeg", webp_reply[:200]
            code, _, png_reply = _post(url, _multipart(
                {"content": _png(_pil(content)), "style": _png(_pil(style))}))
            assert code == 200 and png_reply == webp_reply, name
        truncated = _read("lossy_q95_m6")[:-40]
        code, ctype, data = _post(url, _multipart({"content": truncated,
                                                   "style": style}))
        assert code == 400 and ctype == "text/plain"
        assert "WebP" in data.decode() and "truncated" in data.decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        svc.close()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _chunk(tag: bytes, payload: bytes) -> bytes:
    pad = b"\0" if len(payload) & 1 else b""
    return tag + len(payload).to_bytes(4, "little") + payload + pad


def _riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + len(body).to_bytes(4, "little") + body


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0])
                  + (w - 1).to_bytes(3, "little")
                  + (h - 1).to_bytes(3, "little"))


def _payload(name: str, tag: bytes) -> bytes:
    data = _read(name)
    i = data.find(tag)
    n = int.from_bytes(data[i + 4:i + 8], "little")
    return data[i + 8:i + 8 + n]


def _vp8x_bomb() -> bytes:
    """An animation on a 16384 x 16384 canvas whose one frame is 8 x 8: a
    valid container, its canvas above the limit."""
    frame = _payload("lossy_q0_m0", b"VP8 ")
    w = int.from_bytes(frame[6:8], "little") & 0x3fff
    h = int.from_bytes(frame[8:10], "little") & 0x3fff
    anmf = (bytes(6) + (w - 1).to_bytes(3, "little")
            + (h - 1).to_bytes(3, "little") + bytes([100, 0, 0, 0]))
    return _riff(_vp8x(0x02, 16384, 16384), _chunk(b"ANIM", bytes(6)),
                 _chunk(b"ANMF", anmf + _chunk(b"VP8 ", frame)))


def _vp8l_bomb() -> bytes:
    """A VP8L header of 16384 x 16384, then a few bytes."""
    bits = 0x2f | (16383 << 8) | (16383 << 22)
    return _riff(_chunk(b"VP8L", bits.to_bytes(5, "little") + bytes(32)))


@pytest.mark.parametrize("make", [_vp8x_bomb, _vp8l_bomb])
def test_bomb_refused_before_allocation(make):
    data = make()
    assert _pil(data) is None      # PIL: DecompressionBombError
    tnative.decode_webp(_read("lossy_q0_m0"))   # the library built first
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match="decompression bomb"):
            tpipe.decode_image(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20, peak
    # and in a process that cannot map the canvas
    code = ("import resource, sys\n"
            "from mastermetastyletransfer_tpu_torch.data import pipeline, "
            "native_loader\n"
            "native_loader._library()\n"
            "with open('/proc/self/status') as f:\n"
            "    vm = [int(l.split()[1]) for l in f if l.startswith('VmSize')]"
            "[0] * 1024\n"
            "resource.setrlimit(resource.RLIMIT_AS, (vm + (256 << 20),) * 2)\n"
            "try:\n"
            "    pipeline.decode_image(sys.stdin.buffer.read())\n"
            "except ValueError as e:\n"
            "    print('REFUSED', e)\n")
    proc = subprocess.run([sys.executable, "-c", code], input=data,
                          cwd=ROOT, capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert b"REFUSED" in proc.stdout and b"bomb" in proc.stdout


def _flip(data: bytes, i: int, mask: int) -> bytes:
    b = bytearray(data)
    b[i] ^= mask
    return bytes(b)


def _named_refusals() -> dict:
    lossy, lossless = _read("lossy_q75_m0"), _read("lossless_photo")
    alpha = _read("lossy_alpha")
    vp8 = lossy.find(b"VP8 ") + 8
    vp8x = alpha.find(b"VP8X") + 8
    alph = alpha.find(b"ALPH") + 8
    return {
        "not a key frame": _flip(lossy, vp8, 0x01),
        "frame not shown": _flip(lossy, vp8, 0x10),
        "bad start code": _flip(lossy, vp8 + 3, 0xff),
        "not the canvas": _flip(alpha, vp8x + 4, 0x01),
        "VP8L: bad signature": _flip(lossless, lossless.find(b"VP8L") + 8, 1),
        "ALPH: bad header": _flip(alpha, alph, 0x40),
        "truncated": lossy[:len(lossy) - 9],
        "not a RIFF WEBP": b"RIFF" + lossy[4:8] + b"WEBQ" + lossy[12:],
        "bad VP8X flags": _flip(alpha, vp8x, 0x01),
    }


@pytest.mark.parametrize("why", list(_named_refusals()))
def test_named_refusals(why):
    data = _named_refusals()[why]
    assert _pil(data) is None
    with pytest.raises(ValueError, match=why):
        tnative.decode_webp(data)


_FUZZ = """
import hashlib, os, sys
from mastermetastyletransfer_tpu_torch.data.pipeline import decode_image
folder = sys.argv[1]
for name in sorted(os.listdir(folder), key=int):
    with open(os.path.join(folder, name), "rb") as f:
        data = f.read()
    try:
        px = decode_image(data)
        print(name, "OK", px.shape, hashlib.sha256(px.tobytes()).hexdigest())
    except ValueError as e:
        print(name, "REFUSED", str(e).replace(chr(10), " "))
"""

FUZZ_GROUPS = 4


@pytest.mark.parametrize("group", range(FUZZ_GROUPS))
def test_truncations_and_flips_match_pil(tmp_path, group):
    names = [n for n in NAMES if not n.startswith("trainer")][group::
                                                             FUZZ_GROUPS]
    rng = np.random.default_rng(100 + group)
    cases = []
    for name in names:
        data = _read(name)
        for cut in sorted(set(rng.integers(1, len(data), 6).tolist())):
            cases.append(data[:cut])
        for _ in range(30):
            cases.append(_flip(data, int(rng.integers(0, len(data))),
                               int(rng.integers(1, 256))))
    for i, data in enumerate(cases):
        with open(tmp_path / str(i), "wb") as f:
            f.write(data)
    proc = subprocess.run([sys.executable, "-c", _FUZZ, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == len(cases)
    refused = 0
    for line in lines:
        i, verdict, rest = line.split(" ", 2)
        want = _pil(cases[int(i)])
        if verdict == "REFUSED":
            refused += 1
            assert want is None, (i, rest)
        else:
            assert want is not None, i
            digest = hashlib.sha256(want.tobytes()).hexdigest()
            assert rest == f"{want.shape} {digest}", i
    assert 0 < refused < len(cases)


def test_chip_smoke_reads_the_webp_inputs():
    """chip_smoke.py's codecs phase counts every fixture here, and its
    trainer and http phases' WebP inputs (tests/data/webp/trainer_*.webp)
    decode at COCO's 640x480."""
    import chip_smoke as cs

    assert cs.N_KIND_FIXTURES["webp"] == len(NAMES)
    assert {k: v[1].shape for k, v in cs.kind_fixtures().items()
            if k.startswith("webp/")} == {
        f"webp/{n}": np.load(os.path.join(DATA, "pixels.npz"))[n].shape
        for n in NAMES}
    bodies = cs.kind_bodies(np.random.default_rng(0))
    assert tuple(bodies) == cs.TRAINER_KINDS
    inputs = cs.http_inputs()["contents"]
    assert len(inputs) == len(cs.HTTP_CONTENT_KINDS)
    for name, data in [(n, bodies[n]) for n in cs.TRAINER_KINDS
                       if n.endswith(".webp")] + [
            (cs.HTTP_CONTENT_KINDS[i], inputs[i]) for i in (5, 6)]:
        assert data[:4] == b"RIFF" and data[8:12] == b"WEBP", name
        assert tpipe.decode_image(data).shape == cs.TRAINER_CONTENT_HW + (
            3,), name
