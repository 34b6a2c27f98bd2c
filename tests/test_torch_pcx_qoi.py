"""The port's PCX, DCX and QOI readers (``utils/pcx.py`` with
``native/pcx.cpp``, ``utils/qoi.py`` with ``native/qoi.cpp``) against PIL
and the JAX package on the CPU, with 0 values differing:

* every fixture of tests/data/{pcx,dcx,qoi}/ (scripts/make_image_format_
  fixtures.py: PIL's save, and the byte-level writers' 1-bit files of
  versions 0 and 2, 2- and 4-bit planes at widths whose planes Pillow's
  decoder moves, 8-bit grey with and without a palette, 256 colours, RGB
  at odd widths with the header's stride kept, padded and given
  otherwise, a bounding box off the origin, empty runs; DCX page tables;
  QOI ops of every kind written byte by byte) to its stored pixels and
  PIL's;
* a seeded sweep at odd sizes (1x1, 1x17, 17x1, 33x47) of PIL's saves and
  the writers' layouts, each verdict PIL's;
* truncations and byte flips of every fixture, decoded in a subprocess:
  refused where PIL refuses, PIL's pixels where PIL decodes;
* refusals: Pillow's unknown PCX modes by name, bombs and bodies too
  short for their size before anything of their size is allocated, the
  bytes PCX's, DCX's and QOI's _open pass on given to the next plugin;
* ``_decode_resize`` and ``serve._decode_to`` against the JAX package's;
* chip_smoke.py's kinds phase holding the new directories.
"""

import io
import os
import struct
import tracemalloc

import numpy as np
import pytest
from PIL import Image

from mastermetastyletransfer_tpu import serve as jserve
from mastermetastyletransfer_tpu.data import pipeline as jpipe
from mastermetastyletransfer_tpu_torch import serve as tserve
from mastermetastyletransfer_tpu_torch.data import pipeline as tpipe
from scripts import make_image_format_fixtures as fx
from tests import torch_image_formats as tf

KINDS = ("pcx", "dcx", "qoi")
FIXTURES = [(k, n) for k in KINDS for n in tf.names(k)]


def test_every_fixture_is_stored():
    for kind in KINDS:
        pixels = np.load(os.path.join(tf.DATA, kind, "pixels.npz")).files
        names = tf.names(kind)
        assert sorted(pixels) == [n for n in names if n != "coco"], kind
        assert "coco" in names, kind
    assert len(tf.names("pcx")) >= 18 and len(tf.names("qoi")) >= 7


@pytest.mark.parametrize("kind,name", FIXTURES)
def test_fixture_matches_pil(kind, name):
    data = tf.read(kind, name)
    want = tf.stored(kind, name)
    pixels, fmt = tf.pil(data)
    assert fmt == kind.upper()
    got = tpipe.decode_image(data)
    assert got.dtype == np.uint8
    if isinstance(want, tuple):   # the 640x480 timing input
        assert (pixels.shape, tf.digest(pixels)) == want
        assert (got.shape, tf.digest(got)) == want
    else:
        assert np.array_equal(pixels, want)
        assert got.shape == want.shape
        assert np.count_nonzero(got != want) == 0


def test_fixtures_cover_the_kinds():
    """The headers the fixture names promise."""
    def pcx(name):
        s = tf.read("pcx", name)[:68]
        return {"version": s[1], "bits": s[3], "planes": s[65],
                "stride": struct.unpack_from("<H", s, 66)[0],
                "box": struct.unpack_from("<4H", s, 4)}
    layouts = {(pcx(n)["bits"], pcx(n)["planes"]) for n in tf.names("pcx")}
    assert layouts == {(1, 1), (1, 2), (1, 4), (8, 1), (8, 3)}
    assert {pcx(n)["version"] for n in tf.names("pcx")} >= {0, 2, 5}
    assert pcx("rgb_w9_stride_other")["stride"] == 50
    assert pcx("rgb_origin_5_3")["box"][:2] == (5, 3)
    assert tf.read("pcx", "palette_256")[-769] == 12
    assert tf.read("pcx", "palette_marker_not_12")[-769] == 11
    two = tf.read("dcx", "two_pages")
    assert struct.unpack_from("<4I", two)[3] == 0
    ops = tf.read("qoi", "ops_every_kind")[14:]
    assert {0xFE, 0xFF} <= set(ops) and {b >> 6 for b in ops} == {0, 1, 2, 3}
    assert tf.read("qoi", "channels_7")[12] == 7
    assert not tf.read("qoi", "no_end_marker").endswith(b"\0" * 7 + b"\1")


@pytest.mark.parametrize("hw", tf.SIZES[:4])
def test_pil_saves_match_pil(hw):
    """PIL's PCX save in modes 1, L, P and RGB, a DCX of it, and its QOI
    save in RGB and RGBA, at odd sizes."""
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    img = fx.smooth(rng, *hw)
    for mode in ("1", "L", "P", "RGB"):
        buf = _saved(fx._pil_image(img, mode), "PCX")
        _same_verdict(buf, (hw, mode))
        _same_verdict(fx.dcx_file([buf]), (hw, mode, "dcx"))
    for bands in (3, 4):
        px = fx.smooth(rng, *hw, c=bands).astype(np.uint8)
        _same_verdict(_saved(Image.fromarray(px), "QOI"), (hw, bands))


def _saved(im: Image.Image, fmt: str) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt)
    return buf.getvalue()


def _same_verdict(data: bytes, label) -> None:
    want, _ = tf.pil(data)
    if want is None:
        with pytest.raises(ValueError):
            tpipe.decode_image(data)
        return
    got = tpipe.decode_image(data)
    assert got.shape == want.shape and np.array_equal(got, want), label


@pytest.mark.parametrize("hw", tf.SIZES[:4])
def test_writer_layouts_match_pil(hw):
    """The byte-level PCX writer's layouts (every bits x planes, versions,
    header strides, palettes) and QOI ops of every kind at odd sizes, each
    verdict and pixel PIL's."""
    rng = np.random.default_rng(hw[0] * 7 + hw[1] + 1)
    h, w = hw
    for bits, planes in ((1, 1), (1, 2), (1, 4), (8, 1), (8, 3), (8, 4),
                         (2, 1)):
        base = (w * bits + 7) // 8
        for stride in (base, base + base % 2, base + 3):
            rows = rng.integers(0, 256, (h, planes * stride), dtype=np.uint8)
            for version in (0, 5):
                data = fx.pcx_file(
                    rows, w, version=version, bits=bits, planes=planes,
                    stride=int(rng.choice([stride, base])),
                    palette256=rng.integers(0, 256, 768) if rng.random()
                    < 0.5 else None, palette16=bytes(rng.integers(
                        0, 256, 48, dtype=np.uint8)))
                _same_verdict(data, (bits, planes, stride, version))
    for channels in (3, 4, 9):
        ops = bytearray()
        for _ in range(h * w):
            k = int(rng.integers(0, 6))
            ops += [bytes([0xFE]) + bytes(rng.integers(0, 256, 3,
                                                       dtype=np.uint8)),
                    bytes([0xFF]) + bytes(rng.integers(0, 256, 4,
                                                       dtype=np.uint8)),
                    bytes([int(rng.integers(0, 64))]),
                    bytes([0x40 | int(rng.integers(0, 64))]),
                    bytes([0x80 | int(rng.integers(0, 64)),
                           int(rng.integers(0, 256))]),
                    bytes([0xC0 | int(rng.integers(0, 62))])][k]
        _same_verdict(fx.qoi_file(w, h, bytes(ops), channels), channels)


FUZZ_GROUPS = 3


@pytest.mark.parametrize("group", range(FUZZ_GROUPS))
def test_truncations_and_flips_match_pil(tmp_path, group):
    rng = np.random.default_rng(700 + group)
    cases = []
    for kind, name in [f for f in FIXTURES if f[1] != "coco"][
            group::FUZZ_GROUPS]:
        cases += tf.damaged(tf.read(kind, name), rng, cuts=4, flips=12)
    counts = tf.verdicts_match_pil(cases, tmp_path)
    assert counts["refused"] and counts["decoded"], counts


@pytest.mark.parametrize("body,why", [
    (fx.pcx_file(np.zeros((2, 4), np.uint8), 4, bits=2), "unknown PCX mode"),
    (fx.pcx_file(np.zeros((2, 8), np.uint8), 4, bits=8, planes=4),
     "unknown PCX mode"),
    (fx.pcx_file(np.zeros((2, 4), np.uint8), 4, version=3, bits=8),
     "unknown PCX mode")])
def test_unknown_pcx_modes_are_named(body, why):
    """bits x planes x version that Pillow's _open has no mode for: an
    OSError there, which ends Pillow's search; the port's ValueError names
    it."""
    assert tf.pil(body)[0] is None
    with pytest.raises(ValueError, match=why):
        tpipe.decode_image(body)


def _bombs() -> dict:
    big = struct.pack("<4H", 0, 0, 65534, 65534)
    pcx = bytearray(fx.pcx_file(np.zeros((1, 1), np.uint8), 1))
    pcx[4:12] = big
    short = bytearray(fx.pcx_file(np.zeros((1, 1), np.uint8), 1))
    short[4:12] = struct.pack("<4H", 0, 0, 3999, 3999)
    return {"pcx_bomb": (bytes(pcx), "decompression bomb"),
            "pcx_short": (bytes(short), "truncated"),
            "dcx_bomb": (fx.dcx_file([bytes(pcx)]), "decompression bomb"),
            "qoi_bomb": (fx.qoi_file(40000, 40000, b"\xfd" * 4),
                         "decompression bomb"),
            "qoi_short": (fx.qoi_file(4000, 4000, b"\xfd" * 100),
                          "before the last pixel")}


@pytest.mark.parametrize("name", sorted(_bombs()))
def test_refused_before_allocation(name):
    data, why = _bombs()[name]
    assert tf.pil(data)[0] is None
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match=why):
            tpipe.decode_image(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20, peak


def test_bytes_passed_on_as_pillow_passes_them():
    """A DCX whose page table runs off the file, or holds no page, and a
    QOI too short for its header, and a QOI of width 0: Pillow's _open
    fails with an exception it passes over, and the next plugin's verdict
    stands (here none reads them, or TGA's); so does the port's."""
    pages = fx.dcx_file([fx.pcx_file(np.zeros((3, 4), np.uint8), 4)])
    cases = [pages[:4 + 4 * 2], struct.pack("<2I", 0x3ADE68B1, 0) + pages,
             b"qoif\0\0\0\4\0\0", fx.qoi_file(0, 4, b"\xfd")]
    for data in cases:
        want, fmt = tf.pil(data)
        assert fmt not in ("DCX", "QOI"), fmt
        if want is None:
            with pytest.raises(ValueError):
                tpipe.decode_image(data)
        else:
            assert np.array_equal(tpipe.decode_image(data), want)


RESIZED = [("pcx", "coco"), ("pcx", "planes4_1bit_w21"), ("dcx", "coco"),
           ("qoi", "coco"), ("qoi", "pil_rgba")]


@pytest.mark.parametrize("kind,name", RESIZED)
def test_entry_points_match_jax(kind, name):
    """_decode_resize and serve._decode_to equal the JAX package's."""
    path = os.path.join(tf.DATA, kind, f"{name}.{kind}")
    for size in (32, 100):
        assert np.array_equal(tpipe._decode_resize(path, size),
                              jpipe._decode_resize(path, size)), size
    data = tf.read(kind, name)
    assert np.array_equal(tserve._decode_to(64, data),
                          jserve._decode_to(64, data))


def test_chip_smoke_reads_the_new_fixtures():
    """chip_smoke.py's codecs phase holds every PCX, DCX and QOI fixture
    and the new TIFF kinds to their stored pixels, and times each new
    kind's 640x480 input."""
    import chip_smoke as cs

    for kind in KINDS + ("tiff",):
        assert cs.N_KIND_FIXTURES[kind] == len(tf.names(kind)), kind
    fixtures = cs.kind_fixtures()
    for kind in KINDS:
        for name in tf.names(kind):
            data, want = fixtures[f"{kind}/{name}"]
            assert cs.pixels_differing(tpipe.decode_image(data), want) == 0
    for name in ("tiff thunderscan", "tiff ojpeg", "tiff cielab", "pcx rle",
                 "dcx", "qoi"):
        with open(os.path.join(tf.DATA, cs.FORMAT_TIMING[name]), "rb") as f:
            assert tpipe.decode_image(f.read()).shape == (480, 640, 3), name
