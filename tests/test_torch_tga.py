"""The port's TGA reader (``utils/tga.py`` with the run-length decoder of
``native/tga.cpp``) and ``decode_image``'s walk through Pillow's plugins
(``utils/plugins.py``) against PIL and the JAX package on the CPU:

* every fixture of tests/data/tga/ (scripts/make_image_format_fixtures.py:
  PIL's save in modes 1, L, LA, P, RGB and RGBA, raw and RLE, bottom-up
  and top-down; the byte-level writer's 16- and 32-bit true colour, colour
  maps of 16 and 24 bits from an offset entry, a grey image with a map,
  an id section, each horizontal flip, literals across rows) to its
  stored pixels and PIL's, with 0 values differing;
* a seeded sweep of type x depth x colour-map depth x orientation x RLE,
  every verdict and pixel PIL's;
* Pillow's plugin order: bytes each plugin before TGA (that the port does
  not read) opens are refused by that plugin's name; bytes their _open
  passes on reach TGA, an ICO Pillow's ICO plugin refuses at open among
  them; a DIB refused at open never reaches TGA;
* 2,000 seeded bodies (random bytes, TGA files and ICO headers with
  mutated fields, damaged), decoded in a subprocess, each PIL's verdict
  and pixels;
* hostile TGAs refused before anything of their size is allocated;
* the entry points against JAX's, and /stylize answering 200 with a TGA
  and a T.6 TIFF body.
"""

import io
import os
import struct
import threading
import tracemalloc
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
from mastermetastyletransfer_tpu_torch.data import pipeline as tpipe
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.utils import plugins as tplugins
from mastermetastyletransfer_tpu_torch.utils import tga as ttga
from scripts import fuzz_image_formats as fuzz
from scripts import make_image_format_fixtures as fx
from tests import torch_image_formats as tf
from tests.torch_threads import one_torch_thread  # noqa: F401

NAMES = tf.names("tga")


def _saved(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def test_every_fixture_is_stored():
    stored = np.load(os.path.join(tf.DATA, "tga", "pixels.npz")).files
    assert sorted(stored) == [n for n in NAMES if not n.startswith("coco")]
    assert len(NAMES) >= 30


@pytest.mark.parametrize("name", NAMES)
def test_fixture_matches_pil(name):
    data = tf.read("tga", name)
    want = tf.stored("tga", name)
    pixels, fmt = tf.pil(data)
    assert fmt == "TGA"
    got = ttga.read_tga(data)
    if isinstance(want, tuple):   # the timing input: its shape and digest
        assert (pixels.shape, tf.digest(pixels)) == want
        assert (got.shape, tf.digest(got)) == want
    else:
        assert np.array_equal(pixels, want)
        assert got.shape == want.shape and np.count_nonzero(got != want) == 0
    assert np.array_equal(tpipe.decode_image(data), got)


def test_fixtures_cover_the_kinds():
    """The header each fixture name promises."""
    def head(name):
        d = tf.read("tga", name)
        return d[1], d[2], d[16], d[17], d[7]
    kinds = {head(n)[1:3] for n in NAMES}
    assert kinds >= {(1, 8), (2, 16), (2, 24), (2, 32), (3, 8), (3, 16),
                     (9, 8), (10, 16), (10, 24), (10, 32), (11, 8), (3, 1)}
    assert head("colormap_16bit_rle")[4] == 16
    assert head("colormap_24bit_start4")[4] == 24
    assert head("rle_hflip_top")[3] & 0x30 == 0x30
    assert head("id_section_hflip")[3] & 0x30 == 0x10
    assert tf.read("tga", "id_section_hflip")[0] > 0


def _tga(itype: int, depth: int, w: int, h: int, body: bytes, *, cmt=0,
         start=0, size=0, mdepth=0, flags=0, id_len=0) -> bytes:
    return (bytes([id_len, cmt, itype]) + struct.pack(
        "<HHBHHHHBB", start, size, mdepth, 0, 0, w, h, depth, flags)
        + bytes(id_len) + body)


def _sweep_cases(itype: int, rng) -> list:
    cases = []
    for depth in (1, 8, 15, 16, 24, 32):
        for cmt, mdepth in ((0, 0), (1, 16), (1, 24), (1, 32), (1, 15)):
            for flags in (0, 0x10, 0x20, 0x30):
                w, h = int(rng.integers(1, 140)), int(rng.integers(1, 12))
                size = int(rng.integers(0, 300)) if cmt else 0
                start = int(rng.integers(0, 40)) if cmt else 0
                pal = bytes(rng.integers(0, 256, size * max(mdepth // 8, 1),
                                         dtype=np.uint8)) if cmt else b""
                k = max(depth // 8, 1)
                if itype & 8:
                    rows = [bytes(rng.integers(0, 4, w * k, dtype=np.uint8))
                            for _ in range(h)]
                    body = fx.tga_rle(rows, k, cross=bool(rng.random() < .5))
                else:
                    body = bytes(rng.integers(0, 256, (depth * w + 7) // 8
                                              * h, dtype=np.uint8))
                if rng.random() < 0.2:   # cut short
                    body = body[:int(rng.integers(0, len(body) + 1))]
                cases.append(_tga(itype, depth, w, h, pal + body, cmt=cmt,
                                  start=start, size=size, mdepth=mdepth,
                                  flags=flags))
    return cases


@pytest.mark.parametrize("itype", [1, 2, 3, 9, 10, 11])
def test_sweep_matches_pil(itype):
    """Each image type at every depth, with and without a colour map of
    each depth, each orientation, raw or run-length (literals across rows
    or not), some cut short: PIL's verdict and pixels."""
    rng = np.random.default_rng(itype)
    for data in _sweep_cases(itype, rng):
        want, fmt = tf.pil(data)
        try:
            got = tpipe.decode_image(data)
        except ValueError:
            got = None
        assert (want is None) == (got is None), data[:18].hex()
        if want is not None:
            assert fmt == "TGA" and np.array_equal(got, want), data[:18].hex()


# ---------------------------------------------------------------------------
# Pillow's plugin order
# ---------------------------------------------------------------------------

def _iptc() -> bytes:
    def field(rec, tag, value: bytes):
        return bytes([0x1C, rec, tag]) + struct.pack(">H", len(value)) + value
    return (field(3, 60, b"\x01\x00") + field(3, 20, b"\x00\x04")
            + field(3, 30, b"\x00\x04") + field(3, 120, b"\x00\x01")
            + field(8, 10, bytes(16)))


def _plugin_bodies() -> dict:
    """name -> bytes Pillow's plugin of that name opens (or stops at)."""
    rng = np.random.default_rng(3)
    rgb = Image.fromarray(fx.smooth(rng, 8, 8))
    out = {
        "PCX": _saved(rgb, "PCX"),
        "SGI": _saved(rgb, "SGI"),
        "IM": _saved(rgb, "IM"),
        "SPIDER": _saved(rgb.convert("F"), "SPIDER"),
        "MSP": _saved(rgb.convert("1"), "MSP"),
        "BLP": _saved(rgb.quantize(16), "BLP"),
        "DDS": _saved(rgb, "DDS"),
        "QOI": _saved(rgb, "QOI"),
        "XBM": _saved(rgb.convert("1"), "XBM"),
        "IMT": b"width 4\nheight 4\npixel n8\n\x0c" + bytes(16),
        "IPTC": _iptc(),
        "PCD": bytes(2048) + b"PCD_" + bytes(1600),
        "GBR": struct.pack(">IIIII", 28, 2, 4, 4, 1) + b"GIMP"
               + struct.pack(">I", 10) + bytes(16),
        "MPEG": b"\x00\x00\x01\xb3" + bytes([0x01, 0x00, 0x10]) + bytes(9),
    }
    ico = bytearray(_saved(rgb, "ICO", sizes=[(8, 8)], bitmap_format="bmp"))
    ico[2] = 2   # a cursor
    out["CUR"] = bytes(ico)
    return out


@pytest.mark.parametrize("name", sorted(_plugin_bodies()))
def test_plugins_the_port_does_not_read_are_named(name):
    """Bytes a plugin the port does not read opens (before TGA, or after
    it once TGA passes them on) are refused by that plugin's name, where
    Pillow opens them with it."""
    data = _plugin_bodies()[name]
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == name
    assert tplugins.takes(name, data)
    with pytest.raises(ValueError, match=f"^{name}: "):
        tpipe.decode_image(data)


def test_bytes_passed_on_reach_tga():
    """A TGA that PCX's and CUR's _accept take, whose _open fails (a bad
    PCX bounding box, no cursors): Pillow reads it as TGA, and so does the
    port."""
    rng = np.random.default_rng(4)
    px = rng.integers(0, 256, (3, 5, 3), dtype=np.uint8)
    pcx_like = bytearray(fx.tga_file(px, 2, 24, id_section=bytes(10)))
    pcx_like[5] = 1   # a colour map length PCX reads as a bounding box
    assert tplugins.ACCEPT["PCX"](bytes(pcx_like[:16]))
    assert not tplugins.takes("PCX", bytes(pcx_like))
    cur_like = fx.tga_file(px, 2, 24)
    assert tplugins.ACCEPT["CUR"](cur_like[:16])
    assert not tplugins.takes("CUR", cur_like)
    for data in (bytes(pcx_like), cur_like):
        want, fmt = tf.pil(data)
        assert fmt == "TGA", fmt
        assert np.array_equal(tpipe.decode_image(data), want)


def test_ico_refused_at_open_reaches_tga():
    """An ICO whose directory is cut short: Pillow's ICO plugin fails in
    its _open (IndexError), its TGA plugin opens the bytes (an image of
    type 1, no colour map) and refuses them at load; so does the port,
    naming TGA. A DIB refused at open never reaches TGA (its third byte
    is image type 0)."""
    # three entries declared, one given: its bpp (8) and size bytes read
    # as TGA's width, height (16) and depth (8)
    entry = struct.pack("<BBBBHHII", 16, 16, 0, 0, 1, 8, 0x00080010, 54)
    ico = b"\0\0\1\0" + struct.pack("<H", 3) + entry + bytes(24)
    for cut in (40, 46):
        data = ico[:cut]
        with Image.open(io.BytesIO(data)) as im:
            assert im.format == "TGA"
            with pytest.raises((OSError, ValueError)):
                im.load()
        with pytest.raises(ValueError, match="TGA"):
            tpipe.decode_image(data)
    dib = bytearray(tf.read("dib", "palette_4bit"))
    dib[4:8] = bytes(4)   # width 0: refused at open
    assert tf.pil(bytes(dib))[0] is None
    with pytest.raises(ValueError, match="BMP"):
        tpipe.decode_image(bytes(dib))


FUZZ_GROUPS = 4


@pytest.mark.parametrize("group", range(FUZZ_GROUPS))
def test_seeded_bodies_match_pil(tmp_path, group):
    """500 seeded bodies a group, 2,000 in all (scripts/
    fuzz_image_formats.gen_tga: random bytes, TGA files and ICO headers
    with fields mutated; half damaged): decoded in a subprocess, each
    PIL's verdict and pixels."""
    rng = np.random.default_rng(600 + group)
    cases = []
    for _ in range(500):
        data = fuzz.gen_tga(rng)
        if rng.random() < 0.5:
            data = fuzz.damage(data, rng, "tga")
        cases.append(data)
    counts = tf.verdicts_match_pil(cases, tmp_path)
    assert counts["refused"] and counts["decoded"], counts


# ---------------------------------------------------------------------------
# hostile bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itype,depth,why", [
    (2, 24, "truncated"), (10, 24, "truncated"), (11, 1, "truncated"),
    (10, 32, "truncated")])
def test_hostile_tga_refused_before_allocation(itype, depth, why):
    """A TGA of 65535 x 2000 in a few bytes: raw rows it does not hold,
    run-length data short of a packet a 128 pixels, 1-bit run-length
    (Pillow counts 0 bytes a pixel, so it never ends): refused, as PIL
    refuses it, before anything of its size is allocated."""
    data = _tga(itype, depth, 65535, 2000, b"\x80\x01\x02\x03\x04" * 4)
    assert tf.pil(data)[0] is None
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match=why):
            tpipe.decode_image(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20, peak


def test_tga_bomb_refused():
    """65535 x 65535 is above PIL's decompression-bomb limit: refused at
    open."""
    data = _tga(2, 24, 65535, 65535, bytes(64))
    assert tf.pil(data)[0] is None
    with pytest.raises(ValueError, match="decompression bomb"):
        tpipe.decode_image(data)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["pil_rgb_rle", "colormap_16bit_rle",
                                  "truecolor_16bit_raw", "coco_rle"])
def test_entry_points_match_jax(name):
    path = os.path.join(tf.DATA, "tga", f"{name}.tga")
    for size in (32, 100):
        assert np.array_equal(tpipe._decode_resize(path, size),
                              jpipe._decode_resize(path, size)), size
    data = tf.read("tga", name)
    assert np.array_equal(tserve._decode_to(64, data),
                          jserve._decode_to(64, data))


def _multipart(fields: dict) -> bytes:
    out = b""
    for name, data in fields.items():
        out += (b"--XB\r\nContent-Disposition: form-data; name=\"" +
                name.encode() + b"\"; filename=\"x\"\r\n\r\n" + data + b"\r\n")
    return out + b"--XB--\r\n"


def test_stylize_tga_and_g4_bodies_are_served():
    """A run-length TGA body and a T.6 TIFF body get 200 from the port's
    server, each reply equal to the reply for the same pixels sent as
    PNG."""
    m = tcfg.ModelConfig()
    cfg = m.replace(
        swin=tcfg.SwinConfig(variant="swin_custom", embed_dim=32,
                             num_heads=(2, 4)),
        transformer=m.transformer.replace(
            encoder_dim=64, decoder_dim=64, encoder_num_heads=4,
            decoder_num_heads=4),
        decoder=m.decoder.replace(channel_dim=64))
    params = init_master_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    svc = tserve.StylizeService(params, cfg, size=64, k=1, max_batch=1,
                                device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                tserve.make_handler({1: svc}, default_k=1))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/stylize"

    def post(fields):
        req = urllib.request.Request(url, data=_multipart(fields), headers={
            "Content-Type": "multipart/form-data; boundary=XB"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    try:
        style = tf.read("tga", "pil_rgb_raw_top")
        for content in (tf.read("tga", "pil_rgba_rle"),
                        tf.read("tiff_ccitt", "ccitt_g4_strips")):
            code, reply = post({"content": content, "style": style})
            assert code == 200
            png = {k: _saved(Image.fromarray(tf.pil(v)[0]), "PNG")
                   for k, v in (("content", content), ("style", style))}
            assert post(png) == (200, reply)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        svc.close()
