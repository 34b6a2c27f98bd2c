"""The port's Netpbm, GIF, ICO and headerless BMP (DIB) readers
(``utils/pnm.py``, ``native/gif.cpp`` through ``native_loader.decode_gif``,
``utils/ico.py``, ``utils/bmp.read_dib``) and ``data/pipeline.decode_image``'s
choice of reader, against PIL and the JAX package's readers on the CPU.
Each must give PIL's ``Image.open(...).convert("RGB")`` with 0 values
differing:

* every fixture of tests/data/{pnm,gif,ico,dib}/
  (scripts/make_image_format_fixtures.py) to its stored pixels and to
  PIL's;
* seeded sweeps of PIL-written files at odd sizes (1x1, 1x17, 17x1, 33x47,
  257x131) over modes and options;
* the port's ``_decode_resize`` and ``serve._decode_to`` to the JAX
  package's arrays; a ``/stylize`` request with a GIF body and one with a
  TIFF body answered 200 by the port's server, with the reply of the same
  pixels sent as PNG;
* the choice of reader: each kind's test on a file's first bytes equal to
  its Pillow plugin's ``_accept``, in the order ``Image.open`` tries them;
* refusals: bombs (a GIF screen, a PNM header) refused before anything of
  their size is allocated, and truncations and byte flips of every
  fixture, decoded in a subprocess, each refused where PIL refuses it and
  PIL's pixels where PIL decodes it.
"""

import io
import os
import subprocess
import sys
import threading
import tracemalloc
import urllib.error
import urllib.request
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
from mastermetastyletransfer_tpu_torch.utils import bmp as tbmp
from mastermetastyletransfer_tpu_torch.utils import ico as tico
from mastermetastyletransfer_tpu_torch.utils import plugins as tplugins
from mastermetastyletransfer_tpu_torch.utils import pnm as tpnm
from scripts import make_image_format_fixtures as fx
from tests import torch_image_formats as tf
from tests.torch_threads import one_torch_thread  # noqa: F401

KINDS = ("pnm", "gif", "ico", "dib")
READERS = {"pnm": tpnm.read_pnm, "gif": tnative.decode_gif,
           "ico": tico.read_ico, "dib": tbmp.read_dib}
FIXTURES = [(k, n) for k in KINDS for n in tf.names(k)]


@pytest.mark.parametrize("kind", KINDS)
def test_every_fixture_is_stored(kind):
    names = tf.names(kind)
    pixels = np.load(os.path.join(tf.DATA, kind, "pixels.npz")).files
    assert sorted(pixels) == [n for n in names if not n.startswith("coco")]
    assert len(names) >= 10


@pytest.mark.parametrize("kind,name", FIXTURES)
def test_fixture_matches_pil(kind, name):
    data = tf.read(kind, name)
    want = tf.stored(kind, name)
    pixels, _ = tf.pil(data)
    got = READERS[kind](data)
    assert got.dtype == np.uint8
    if isinstance(want, tuple):   # a timing input: its shape and digest
        assert (pixels.shape, tf.digest(pixels)) == want
        assert (got.shape, tf.digest(got)) == want
    else:
        assert np.array_equal(pixels, want)    # PIL still decodes it so
        assert got.shape == want.shape
        assert np.count_nonzero(got != want) == 0
    assert np.array_equal(tpipe.decode_image(data), got)


def _descriptor(gif: bytes) -> int:
    """Where a GIF's first image descriptor starts: past the screen, its
    colour table and the extensions."""
    pos = 13 + ((3 << ((gif[10] & 7) + 1)) if gif[10] & 0x80 else 0)
    while gif[pos] == 0x21:
        pos += 2
        while gif[pos]:
            pos += gif[pos] + 1
        pos += 1
    assert gif[pos] == 0x2C
    return pos


def test_fixtures_cover_the_kinds():
    """The headers each fixture name promises."""
    assert {tf.read("pnm", n)[:2] for n in tf.names("pnm")} >= {
        b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf", b"P0", b"Py"}
    gif = tf.read("gif", "interlaced")
    assert gif[_descriptor(gif) + 9] & 0x40
    assert tf.read("gif", "no_colour_table")[10] & 0x80 == 0
    gif = tf.read("gif", "local_palette")
    assert gif[_descriptor(gif) + 9] & 0x80
    for size in range(2, 9):
        gif = tf.read("gif", f"code_size_{size}")
        assert gif[_descriptor(gif) + 10] == size
    bpp = {int.from_bytes(tf.read("ico", f"bitmap_{b}bit")[12:14], "little")
           for b in (1, 4, 8, 24, 32)}
    assert bpp == {1, 4, 8, 24, 32}
    assert tf.read("ico", "png_256_beside_bitmaps")[6 + 16 * 3] == 0
    assert {int.from_bytes(tf.read("dib", n)[:4], "little")
            for n in tf.names("dib")} == {12, 40, 52, 56, 64, 108, 124}


# ---------------------------------------------------------------------------
# seeded sweeps of PIL-written files
# ---------------------------------------------------------------------------

def _saved(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("hw", tf.SIZES)
def test_pnm_sweep_matches_pil(hw):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    img = fx.smooth(rng, *hw)
    for mode in ("1", "L", "RGB", "I;16", "F", "I"):
        src = img if mode == "RGB" else img[..., 0]
        tf.assert_pil_pixels(tpnm.read_pnm,
                             _saved(fx._pil_image(src, mode), "PPM"),
                             (hw, mode))
    grey = img[..., 0].astype(np.int64)
    for magic, maxval in ((b"P2", 7), (b"P3", 300), (b"P5", 999),
                          (b"P6", 4000), (b"P1", None)):
        src = img.astype(np.int64) if magic in (b"P3", b"P6") else grey
        vals = (src > 100) if magic == b"P1" else src * maxval // 255
        tf.assert_pil_pixels(tpnm.read_pnm, fx.pnm_file(magic, vals, maxval),
                             (hw, magic))


def _plain_body(rng, n: int, maxval: int, comments: bool) -> bytes:
    """n decimal samples up to maxval, each followed by random whitespace
    (and, with ``comments``, now and then a comment), over 64 KiB blocks."""
    vals = rng.integers(0, maxval + 1, n)
    seps = [b" ", b"\n", b"\t", b"  \r\n", b"\x0b", b"\x0c"]
    out = []
    for v, k in zip(vals.tolist(), rng.integers(0, len(seps), n).tolist()):
        out.append(b"%d" % v + seps[k])
        if comments and v % 97 == 0:
            out.append(b"#" + b"c" * int(v % 300) + b"\n")
    return b"".join(out)


@pytest.mark.parametrize("case", ["digits", "comments", "signs", "junk",
                                  "long_needed", "long_unneeded",
                                  "long_half"])
def test_plain_pnm_blocks_match_pil(case):
    """Plain P2/P3 bodies over several of Pillow's 64 KiB blocks, read a
    block at a time where it holds only digits and whitespace: tokens and
    comments across block ends, signs and underscores (which int()
    reads), junk, and tokens over 10 digits where they are needed, past
    the samples needed, and cut at a block's end; each refused where PIL
    refuses it and PIL's pixels where PIL decodes it."""
    rng = np.random.default_rng(sum(map(ord, case)))
    w, h = 211, 97
    body = _plain_body(rng, w * h * 3, 255, case == "comments")
    if case == "signs":
        body = body.replace(b" 1", b" +1", 50).replace(b"12 ", b"1_2 ", 50)
    elif case == "junk":
        body = body[:90000] + b" 7x " + body[90000:]
    elif case == "long_needed":
        body = body[:70000] + b" 00000000001 " + body[70000:]
    elif case == "long_unneeded":
        body = body + b" 123456789012345\n"
    elif case == "long_half":   # the last block ends inside a long token
        body = body + b" 123456789012345"
    data = b"P3\n%d %d\n255\n" % (w, h) + body
    want = tf.pil(data)[0]
    if want is None:
        with pytest.raises(ValueError):
            tpnm.read_pnm(data)
    else:
        tf.assert_pil_pixels(tpnm.read_pnm, data, case)
    assert (want is None) == (case in ("junk", "long_needed", "long_half"))


@pytest.mark.parametrize("hw", tf.SIZES)
def test_gif_sweep_matches_pil(hw):
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    img = fx.smooth(rng, *hw)
    for colors in (2, 16, 256):
        q = Image.fromarray(img).quantize(colors)
        for kw in ({}, {"interlace": True}, {"transparency": 1}):
            tf.assert_pil_pixels(tnative.decode_gif, _saved(q, "GIF", **kw),
                                 (hw, colors, kw))
    tf.assert_pil_pixels(tnative.decode_gif,
                         _saved(Image.fromarray(img[..., 1]), "GIF"),
                         (hw, "L"))
    pal = rng.integers(0, 256, (256, 3))
    for size in (2, 5, 8):
        idx = rng.integers(0, 1 << size, hw).astype(np.uint8)
        for kw in ({"clear_every": 7}, {"defer": True}, {"eoi": False}):
            tf.assert_pil_pixels(tnative.decode_gif, fx.gif_file(
                idx, global_pal=pal[:1 << size], min_size=size, **kw),
                (hw, size, kw))


@pytest.mark.parametrize("fmt", ["bmp", "png"])
def test_ico_sweep_matches_pil(fmt):
    rng = np.random.default_rng(len(fmt))
    for side in (1, 17, 64, 256):
        img = fx.smooth(rng, side, side, c=4)
        for mode in ("RGBA", "RGB", "P", "L"):
            im = fx._pil_image(img[..., :3], mode) if mode != "RGBA" else \
                Image.fromarray(img, "RGBA")
            sizes = [(s, s) for s in (1, 16, 48, 256) if s <= side]
            tf.assert_pil_pixels(tico.read_ico, _saved(
                im, "ICO", sizes=sizes, bitmap_format=fmt), (side, mode))


@pytest.mark.parametrize("hw", tf.SIZES)
def test_dib_sweep_matches_pil(hw):
    rng = np.random.default_rng(hw[0] + 31 * hw[1])
    img = fx.smooth(rng, *hw)
    for mode in ("1", "L", "P", "RGB"):
        tf.assert_pil_pixels(tbmp.read_dib,
                             _saved(fx._pil_image(img, mode), "DIB"),
                             (hw, mode))
    tf.assert_pil_pixels(tbmp.read_dib, _saved(Image.fromarray(
        np.dstack([img, img[..., :1]]), "RGBA"), "DIB"), (hw, "RGBA"))


# ---------------------------------------------------------------------------
# the choice of reader
# ---------------------------------------------------------------------------

def test_reader_order_is_pillows():
    """A fresh Pillow tries its plugins in this order, every one of them
    (decode_image's _ORDER); the port's kinds come in it, and each plugin
    that the port does not read is one utils/plugins decides for: by its
    _accept, or, where it has none (IM, IMT, IPTC, PCD, SPIDER), by the
    checks of its _open."""
    code = ("from PIL import Image\nImage.preinit()\nImage.init()\n"
            "print(' '.join(Image.ID))")
    ids = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert tuple(ids) == tpipe._ORDER
    order = [i for i in ids if i in {k[0] for k in tpipe._KINDS}]
    assert order == [k[0] for k in tpipe._KINDS]
    Image.init()
    for name in ids:
        if name in {k[0] for k in tpipe._KINDS}:
            continue
        if Image.OPEN[name][1] is None:
            assert name in ("IM", "IMT", "IPTC", "PCD", "SPIDER"), name
            assert name in tplugins._OPEN, name
        else:
            assert name in tplugins.ACCEPT, name


def _plugin_prefixes() -> list:
    """First bytes each _accept of utils/plugins takes, and near misses."""
    out = [b"BLP1", b"BLP2", b"BUFR", b"ZCZC", b"\0\0\2\0", b"\x0a\x05",
           b"\x0a\x01", b"\xb1\x68\xde\x3a", b"DDS ", b"%!PS",
           b"\xc5\xd0\xd3\xc6", b"SIMPLE", b"FTEX",
           b"\0\0\0\x1c\0\0\0\x01", b"\0\0\0\x10\0\0\0\x03", b"GRIB\0\0\0\x01",
           b"GRIB\0\0\0\x02", b"\x89HDF\r\n\x1a\n", b"\xff\x4f\xff\x51",
           b"\0\0\0\x0cjP  \r\n\x87\n", b"icns", b"\0" * 7 + b"\x04",
           b"\0\0\1\xb3", b"DanM", b"LinS", b"\x80\xe8\0\0", b"8BPS",
           b"qoif", b"\x01\xda", b"\x59\xa6\x6a\x95", b"\xd7\xcd\xc6\x9a\0\0",
           b"\x01\0\0\0", b"#define", b" \n #define", b"/* XPM */",
           b"P7 332", b"\0\0\0\x18ftypavif", b"\0\0\0\x18ftypmif1",
           b"\0\0\0\x18ftypheic"]
    fli = bytearray(16)
    fli[4:6], fli[14:16] = b"\x11\xaf", b"\x03\0"
    out.append(bytes(fli))
    return [p.ljust(16, b"\0") for p in out] + out


def _prefixes(rng) -> list:
    out = [tf.read(k, n)[:16] for k in ("pnm", "gif", "tiff", "ico", "dib")
           for n in tf.names(k)]
    out += [b"BM" + bytes(14), b"\xff\xd8\xff\xe0" + bytes(12),
            b"\x89PNG\r\n\x1a\n" + bytes(8), b"RIFF\0\0\0\0WEBPVP8 ",
            b"RIFF\0\0\0\0WEBPVP8X", b"RIFF\0\0\0\0WEBPVP9 ",
            b"\0\0\2\0" + bytes(12), b"P7 1 1", b"P", b"", b"GIF8",
            b"II*", b"(\0\0\0", b"PF\n", b"Py"]
    out += [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) for _ in
            range(200)]
    out += [tf.flip(p, int(rng.integers(0, len(p))), 1) for p in out
            if p][:400]
    return out


def test_each_kind_accepts_as_its_plugin():
    """Each kind's test on the first bytes is its Pillow plugin's _accept
    (a plugin whose _accept fails on short bytes takes nothing; TGA has
    none, so its plugin takes any bytes to its _open); so is each
    _accept kept for a plugin the port does not read
    (utils/plugins.ACCEPT)."""
    Image.init()
    rng = np.random.default_rng(5)
    kinds = [(name, accept) for name, accept, _ in tpipe._KINDS]
    kinds += sorted(tplugins.ACCEPT.items())
    for prefix in _prefixes(rng) + _plugin_prefixes():
        for name, accept in kinds:
            pil_accept = Image.OPEN[name][1]
            try:
                want = pil_accept is None or pil_accept(prefix)
                want = want is True   # a str is a warning, not a yes
            except Exception:  # noqa: BLE001 - struct.error on short bytes
                want = False
            assert bool(accept(prefix)) == want, (name, prefix)


def test_refused_bodies_are_refused_as_pil_refuses():
    """Bodies one kind accepts and refuses: PIL refuses them too, or opens
    them with a plugin the port does not have (here TGA, which takes an
    ICO whose directory Pillow's ICO plugin refuses); the port refuses
    each, naming the kind."""
    ico = tf.read("ico", "bitmap_8bit")
    cases = {
        "PNM: not a PPM file": b"P6x 4 4 255\n" + bytes(48),
        "PNM: token too long": b"P5 123456789012 1 255\n",
        "GIF: image not found": b"GIF89a\x01\x00\x01\x00\x00\x00\x00!\xfe"
                                b"\x01x\x00",
        "BMP: 2-bit pixels": tf.read("dib", "palette_4bit")[:14]
        + b"\x02" + tf.read("dib", "palette_4bit")[15:],
        "ICO: truncated directory": ico[:20],
        "TIFF: no more images": b"II*\x00\x00\x00\x00\x00",
    }
    for why, data in cases.items():
        want, fmt = tf.pil(data)
        assert want is None or fmt not in tf.PORT_FORMATS, why
        with pytest.raises(ValueError, match=why.split(":")[0]):
            tpipe.decode_image(data)


# ---------------------------------------------------------------------------
# the entry points against the JAX package's
# ---------------------------------------------------------------------------

RESIZED = [("pnm", "p6_maxval_1000"), ("pnm", "pf_little_endian"),
           ("pnm", "p1_plain_comments"), ("gif", "offset_frame"),
           ("gif", "coco"), ("ico", "png_256_beside_bitmaps"),
           ("ico", "bitmap_4bit"), ("dib", "rle4"),
           ("tiff", "coco_lzw_pred2"), ("tiff", "pil_cmyk_jpeg")]


@pytest.mark.parametrize("kind,name", RESIZED)
def test_decode_resize_matches_jax(kind, name):
    path = os.path.join(tf.DATA, kind, f"{name}.{tf.EXT[kind]}")
    for size in (32, 100):
        assert np.array_equal(tpipe._decode_resize(path, size),
                              jpipe._decode_resize(path, size)), size


@pytest.mark.parametrize("size", [64, 128])
def test_decode_to_matches_jax(size):
    for kind, name in RESIZED:
        data = tf.read(kind, name)
        got = tserve._decode_to(size, data)
        assert got.dtype == np.float32 and got.shape == (size, size, 3)
        assert np.array_equal(got, jserve._decode_to(size, data)), name


def _narrow_cfg() -> tcfg.ModelConfig:
    m = tcfg.ModelConfig()
    return m.replace(
        swin=tcfg.SwinConfig(variant="swin_custom", embed_dim=32,
                             num_heads=(2, 4)),
        transformer=m.transformer.replace(
            encoder_dim=64, decoder_dim=64, encoder_num_heads=4,
            decoder_num_heads=4),
        decoder=m.decoder.replace(channel_dim=64))


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


def test_stylize_gif_and_tiff_bodies_are_served():
    """A GIF body and a TIFF body (LZW, predictor 2) get 200 from the
    port's server, each reply equal to the reply for the same pixels sent
    as PNG; an SGI body (a kind the port does not read) gets 400 naming
    it."""
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
        style = tf.read("gif", "pil_palette")
        for kind, name in (("gif", "offset_frame"),
                           ("tiff", "lzw_predictor2_8bit")):
            content = tf.read(kind, name)
            code, ctype, reply = _post(url, _multipart(
                {"content": content, "style": style}))
            assert code == 200 and ctype == "image/jpeg", reply[:200]
            png = {k: _saved(Image.fromarray(tf.pil(v)[0]), "PNG")
                   for k, v in (("content", content), ("style", style))}
            code, _, png_reply = _post(url, _multipart(png))
            assert code == 200 and png_reply == reply, name
        sgi = _saved(Image.fromarray(tf.pil(content)[0]), "SGI")
        assert tf.pil(sgi)[0] is not None
        code, ctype, data = _post(url, _multipart({"content": sgi,
                                                   "style": style}))
        assert code == 400 and ctype == "text/plain"
        assert "SGI" in data.decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        svc.close()


def test_hostile_tiff_bodies_get_400():
    """TIFF bodies whose strips or tiles reach far past their data
    (tests/torch_image_formats.hostile_tiffs) get 400 from the port's
    server, naming the refusal, with nothing of the strips' or tiles'
    number or size built on the way."""
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
        style = tf.read("gif", "pil_palette")
        for name, (content, why) in sorted(tf.hostile_tiffs().items()):
            body = _multipart({"content": content, "style": style})
            tracemalloc.start()
            try:
                code, ctype, reply = _post(url, body)
                peak = tracemalloc.get_traced_memory()[1]
            finally:
                tracemalloc.stop()
            assert code == 400 and ctype == "text/plain", name
            assert why in reply.decode(), (name, reply[:200])
            assert peak < (1 << 20) + 4 * len(body), (name, peak)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        svc.close()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _gif_bomb() -> bytes:
    """A GIF whose screen is 65535 x 65535 and whose one frame is 1 x 1."""
    return (b"GIF89a" + (65535).to_bytes(2, "little") * 2 + b"\x00\x00\x00"
            + b",\x00\x00\x00\x00\x01\x00\x01\x00\x00\x02\x02\x44\x01\x00;")


def _gif_frame_bomb() -> bytes:
    """A 1 x 1 screen whose frame, at (65000, 65000), grows the canvas."""
    return (b"GIF89a\x01\x00\x01\x00\x00\x00\x00,"
            + (65000).to_bytes(2, "little") * 2
            + b"\x01\x00\x01\x00\x00\x02\x02\x44\x01\x00;")


def _pnm_bomb() -> bytes:
    return b"P6\n20000 20000\n255\n" + bytes(64)


@pytest.mark.parametrize("make", [_gif_bomb, _gif_frame_bomb, _pnm_bomb])
def test_bomb_refused_before_allocation(make):
    data = make()
    assert tf.pil(data)[0] is None     # PIL: DecompressionBombError
    tnative.decode_gif(tf.read("gif", "code_size_2"))   # the library built
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match="decompression bomb"):
            tpipe.decode_image(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20, peak


def test_short_pnm_refused_before_allocation():
    """A PNM header under the bomb limit whose file is too short to hold
    its samples is refused before the image is allocated (PIL reads on
    and refuses it at the end of the data)."""
    data = b"P5\n12000 12000\n1000\n" + bytes(100)
    assert tf.pil(data)[0] is None
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match="not enough image data"):
            tpnm.read_pnm(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20, peak


FUZZ_GROUPS = 4


@pytest.mark.parametrize("group", range(FUZZ_GROUPS))
def test_truncations_and_flips_match_pil(tmp_path, group):
    rng = np.random.default_rng(200 + group)
    cases = []
    for kind, name in [f for f in FIXTURES if not f[1].startswith("coco")][
            group::FUZZ_GROUPS]:
        cases += tf.damaged(tf.read(kind, name), rng, cuts=4, flips=12)
    counts = tf.verdicts_match_pil(cases, tmp_path)
    assert counts["refused"] and counts["decoded"], counts


def test_chip_smoke_reads_the_new_fixtures():
    """chip_smoke.py's codecs phase holds every fixture of the kinds read
    with PIL's plugins (Netpbm, GIF, TIFF, ICO, DIB, CCITT TIFF, TGA) to
    its stored pixels and times the 640x480 inputs; its http phase sends
    an LZW and a Zstandard TIFF and an RLE TGA content and locks a style
    from a Deflate TIFF."""
    import chip_smoke as cs

    kinds = ("pnm", "gif", "tiff", "ico", "dib", "tiff_ccitt", "tga")
    for kind in kinds:
        assert cs.N_KIND_FIXTURES[kind] == len(tf.names(kind)), kind
    fixtures = cs.kind_fixtures()
    for kind in kinds:
        for name in tf.names(kind):
            data, want = fixtures[f"{kind}/{name}"]
            got = tpipe.decode_image(data)
            if isinstance(want, tuple):
                assert (got.shape, tf.digest(got)) == want, name
            else:
                assert np.array_equal(got, want), name
    for name in ("tiff g4", "tiff lzma", "tiff zstd", "tga rle"):
        rel = cs.FORMAT_TIMING[name]
        with open(os.path.join(tf.DATA, rel), "rb") as f:
            assert tpipe.decode_image(f.read()).shape == (480, 640, 3), name
    accept = {name: test for name, test, _ in tpipe._KINDS}
    inputs = cs.http_inputs()
    contents = dict(zip(cs.HTTP_CONTENT_KINDS, inputs["contents"]))
    assert len(contents) == 8
    assert accept["TIFF"](contents["tiff lzw predictor 2"])
    assert accept["TIFF"](contents["tiff zstd"])
    assert ttiff_code(contents["tiff zstd"]) == 50000
    assert tf.pil(contents["tga rle"])[1] == "TGA"
    assert accept["TIFF"](inputs["locked_tiff"])
    for body in (contents["tiff lzw predictor 2"], contents["tiff zstd"],
                 contents["tga rle"], inputs["locked_tiff"]):
        assert tpipe.decode_image(body).shape == (480, 640, 3)


def ttiff_code(data: bytes) -> int:
    from mastermetastyletransfer_tpu_torch.utils import tiff as ttiff

    return ttiff._Ifd(data).get(259)
