"""The port's TIFF reader (``utils/tiff.py`` with the byte-serial codecs of
``native/tiff.cpp``) against PIL and the JAX package's readers on the CPU.
Pillow reads an uncompressed TIFF itself and every other one through
libtiff; the port must give its ``Image.open(...).convert("RGB")`` of IFD
0 with 0 values differing:

* every fixture of tests/data/tiff/ (scripts/make_image_format_fixtures.py:
  PIL's save in modes 1, L, I;16, F, RGB, RGBA, P and CMYK with no,
  PackBits, LZW, Deflate and Adobe Deflate compression and JPEG; the
  byte-level writer's tiles, planar files, predictors 2 and 3,
  big-endian, BigTIFF, FillOrder 2, 1- to 4-bit palettes, min-is-white,
  12-bit grey, signed samples, associated and unassociated alpha, extra
  samples, the old LZW, a strip with no end code, orientations, YCbCr in
  JPEG and, through libtiff's RGBA route, in LZW, Deflate and PackBits at
  several subsamplings) to its stored pixels and to PIL's;
* a seeded sweep of PIL-written files at odd sizes (1x1, 1x17, 17x1,
  33x47, 257x131) over modes and compressions, and one of the byte-level
  writer's layouts;
* the port's ``_decode_resize`` and ``serve._decode_to`` to the JAX
  package's arrays;
* refusals: a bomb and a file whose strips lie past its end refused before
  anything of their size is allocated, and so are strip and tile
  geometries far past their data (tests/torch_image_formats.
  hostile_tiffs), also in a process with little address space to spare;
* tiles reaching far past a small image decoded to PIL's pixels a few
  batches at a time, and files of several strips or tiles (planar ones
  too) in batches of one and in runs;
* refusals by name: the compressions and photometrics
  left out (CCITT, G3, G4, LZMA, ZSTD, YCbCr tiles without JPEG, CIELab)
  refused by name; truncations and byte flips of every fixture, decoded in
  a subprocess, each refused where PIL refuses it and PIL's pixels where
  PIL decodes it.
"""

import os
import struct
import subprocess
import sys
import tracemalloc
import zlib

import numpy as np
import pytest
from PIL import Image

from mastermetastyletransfer_tpu import serve as jserve
from mastermetastyletransfer_tpu.data import pipeline as jpipe
from mastermetastyletransfer_tpu_torch import serve as tserve
from mastermetastyletransfer_tpu_torch.data import pipeline as tpipe
from mastermetastyletransfer_tpu_torch.utils import tiff as ttiff
from scripts import make_image_format_fixtures as fx
from tests import torch_image_formats as tf

NAMES = tf.names("tiff")


def _read(name: str) -> bytes:
    return tf.read("tiff", name)


def test_every_fixture_is_stored():
    pixels = np.load(os.path.join(tf.DATA, "tiff", "pixels.npz")).files
    assert sorted(pixels) == [n for n in NAMES if not n.startswith("coco")]
    assert len(NAMES) >= 80


@pytest.mark.parametrize("name", NAMES)
def test_fixture_matches_pil(name):
    data = _read(name)
    want = tf.stored("tiff", name)
    pixels, fmt = tf.pil(data)
    assert fmt == "TIFF"
    got = ttiff.read_tiff(data)
    assert got.dtype == np.uint8
    if isinstance(want, tuple):   # a timing input: its shape and digest
        assert (pixels.shape, tf.digest(pixels)) == want
        assert (got.shape, tf.digest(got)) == want
    else:
        assert np.array_equal(pixels, want)    # PIL still decodes it so
        assert got.shape == want.shape
        assert np.count_nonzero(got != want) == 0
    assert np.array_equal(tpipe.decode_image(data), got)


def _tags(name: str) -> dict:
    ifd = ttiff._Ifd(_read(name))
    return {t: ifd.get(t) for t in ifd.tags} | {"big": ifd.big,
                                                "order": ifd.order}


def test_fixtures_cover_the_kinds():
    """The tags each fixture name promises."""
    comps = {_tags(n)[259] for n in NAMES}
    assert comps >= {1, 5, 7, 8, 32773, 32946}
    assert _tags("tiles_lzw")[322] == 16
    assert _tags("tiles_planar_deflate_16bit")[284] == 2
    assert _tags("jpeg_tiles_ycbcr")[259] == 7
    assert 322 in _tags("jpeg_tiles_ycbcr")
    assert _tags("jpeg_strips_ycbcr")[262] == 6
    assert _tags("lzw_predictor2_8bit")[317] == 2
    assert _tags("lzw_predictor3_float")[317] == 3
    assert _tags("big_endian_rgb16_lzw")["order"] == ">"
    assert _tags("bigtiff_rgb")["big"]
    assert _tags("fill_order2_1bit_lzw")[266] == 2
    assert _tags("grey_12bit_raw")[258] == (12,)
    assert _tags("associated_alpha_8bit")[338] == (1,)
    assert _tags("orientation_6")[274] == 6
    old = _read("lzw_old_style")
    strip = _tags("lzw_old_style")[273][0]
    assert old[strip] == 0 and old[strip + 1] & 1    # LSB-first codes
    assert {_tags(f"palette_{b}bit_lzw")[258] for b in (1, 2, 4)} == {
        (1,), (2,), (4,)}
    assert 530 not in _tags("ycbcr_lzw_2x2_default")
    assert _tags("ycbcr_deflate_4x2_refbw")[530] == (4, 2)
    assert 529 in _tags("ycbcr_packbits_1x1_bt709")
    assert _tags("ycbcr_planar_lzw")[284] == 2


UNPACKED = sorted(k for k in ttiff._UNPACKERS if k not in ttiff._BAND
                  and k[0] != "LAB")


@pytest.mark.parametrize("mode,rawmode", UNPACKED)
def test_unpacker_matches_pil(mode, rawmode):
    """Each raw mode a TIFF can reach, unpacked and converted to RGB as
    Pillow's ``Image.frombytes(mode, size, data, "raw", rawmode)
    .convert("RGB")`` does, on random bytes (a zero alpha row among
    them) at widths that end mid-byte."""
    rng = np.random.default_rng(len(rawmode))
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    bits = ttiff._UNPACKERS[mode, rawmode]
    for w in (1, 3, 8, 13):
        rows = rng.integers(0, 256, (4, (w * bits + 7) // 8), dtype=np.uint8)
        rows[0] = 0
        im = Image.frombytes(mode, (w, 4), rows.tobytes(), "raw", rawmode)
        if mode in ("P", "PA"):
            im.putpalette(palette.tobytes())
        got = ttiff._to_rgb(ttiff._unpack(mode, rawmode, rows, w), mode,
                            palette)
        assert np.array_equal(got, np.asarray(im.convert("RGB"))), w


# ---------------------------------------------------------------------------
# seeded sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", tf.SIZES)
def test_pil_sweep_matches_pil(hw):
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    img = fx.smooth(rng, *hw)
    for mode in fx.PIL_TIFF_MODES + ("LA", "I"):
        src = img if mode in ("RGB", "RGBA", "P", "CMYK", "LA") else \
            img[..., 1]
        for comp in fx.PIL_TIFF_COMPRESSIONS:
            tf.assert_pil_pixels(ttiff.read_tiff, fx.pil_tiff(
                src, mode, compression=comp), (hw, mode, comp))
    for mode in ("RGB", "L", "CMYK"):
        src = img if mode != "L" else img[..., 1]
        for quality in (30, 95):
            tf.assert_pil_pixels(ttiff.read_tiff, fx.pil_tiff(
                src, mode, compression="jpeg", quality=quality),
                (hw, mode, quality))


@pytest.mark.parametrize("group", range(3))
def test_writer_sweep_matches_pil(group):
    rng = np.random.default_rng(50 + group)
    for i in range(60):
        data = fx.writer_case(rng)
        want, _ = tf.pil(data)
        if want is None:   # a layout Pillow does not read: nor the port
            with pytest.raises(ValueError):
                ttiff.read_tiff(data)
            continue
        got = ttiff.read_tiff(data)
        assert got.shape == want.shape and np.array_equal(got, want), i


# ---------------------------------------------------------------------------
# the entry points against the JAX package's
# ---------------------------------------------------------------------------

RESIZED = ["coco_deflate", "coco_jpeg", "jpeg_tiles_ycbcr", "pil_p_tiff_lzw",
           "orientation_6", "associated_alpha_16bit", "grey_12bit_lzw",
           "pil_f_packbits"]


@pytest.mark.parametrize("name", RESIZED)
def test_decode_resize_matches_jax(name):
    path = os.path.join(tf.DATA, "tiff", f"{name}.tif")
    for size in (32, 100):
        assert np.array_equal(tpipe._decode_resize(path, size),
                              jpipe._decode_resize(path, size)), size


def test_decode_to_matches_jax():
    for name in RESIZED:
        data = _read(name)
        got = tserve._decode_to(64, data)
        assert got.dtype == np.float32 and got.shape == (64, 64, 3)
        assert np.array_equal(got, jserve._decode_to(64, data)), name


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _huge(w: int, h: int) -> bytes:
    """An 8-bit grey TIFF that claims w x h pixels and holds one strip of
    8 bytes."""
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8),
               (259, 3, 1, 1), (262, 3, 1, 1), (273, 4, 1, 8),
               (277, 3, 1, 1), (278, 4, 1, h), (279, 4, 1, 8)]
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII", *e) for e in entries) + bytes(4)
    return b"II*\x00" + struct.pack("<I", 16) + bytes(8) + ifd


@pytest.mark.parametrize("wh,why", [((60000, 60000), "decompression bomb"),
                                    ((13000, 13000), "truncated")])
def test_refused_before_allocation(wh, why):
    data = _huge(*wh)
    assert tf.pil(data)[0] is None
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match=why):
            tpipe.decode_image(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20, peak


HOSTILE = sorted(tf.hostile_tiffs())


@pytest.mark.parametrize("name", HOSTILE)
def test_tile_geometry_refused_before_allocation(name):
    """Bodies whose strips or tiles reach far past their data (a million
    tiles of 1 x 1, tiles with no byte counts, a tile of 4 GiB, a short
    offsets tag past libtiff's million) are refused as PIL refuses them,
    before anything of the strips' or tiles' number or size is built."""
    data, why = tf.hostile_tiffs()[name]
    assert tf.pil(data)[0] is None
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match=why):
            tpipe.decode_image(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < (1 << 20) + 2 * len(data), peak


def test_tile_geometry_refused_under_an_address_space_limit():
    """The same bodies, in a process that cannot map 256 MiB more."""
    code = ("import resource, sys\n"
            "from mastermetastyletransfer_tpu_torch.data import pipeline, "
            "native_loader\n"
            "from tests import torch_image_formats as tf\n"
            "native_loader._library()\n"
            "bodies = tf.hostile_tiffs()\n"
            "with open('/proc/self/status') as f:\n"
            "    vm = [int(l.split()[1]) for l in f if l.startswith('VmSize')]"
            "[0] * 1024\n"
            "resource.setrlimit(resource.RLIMIT_AS, (vm + (256 << 20),) * 2)\n"
            "for name in sorted(bodies):\n"
            "    try:\n"
            "        pipeline.decode_image(bodies[name][0])\n"
            "        print(name, 'DECODED')\n"
            "    except ValueError as e:\n"
            "        print(name, 'REFUSED', e)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tf.ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert [line.split()[0] for line in lines] == HOSTILE, lines
    for line in lines:
        name = line.split()[0]
        assert "REFUSED" in line and tf.hostile_tiffs()[name][1] in line, line


def _far_tiles() -> bytes:
    """A 4096 x 1 grey Deflate TIFF in 256 tiles of 16 x 65535 (1 MiB
    each, one stream shared by all): PIL decodes it a tile at a time."""
    tile = np.zeros((65535, 16), np.uint8)
    tile[0] = np.arange(16) * 16 + 7
    stream = zlib.compress(tile.tobytes(), 9)
    return tf._tiff_ifd([
        (256, 4, [4096]), (257, 4, [1]), (258, 3, [8]), (259, 3, [8]),
        (262, 3, [1]), (277, 3, [1]), (322, 4, [16]), (323, 4, [65535]),
        (324, 4, np.full(256, 8)), (325, 4, np.full(256, len(stream)))],
        stream)


def test_tiles_past_a_small_image_decoded_some_at_a_time():
    """256 MiB of tiles for 4 KiB of image: decoded to PIL's pixels while
    holding a few batches (``_BATCH_BYTES``) of them at most."""
    data = _far_tiles()
    want = tf.pil(data)[0]
    assert want is not None and want.shape == (1, 4096, 3)
    tracemalloc.start()
    try:
        got = tpipe.decode_image(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert np.array_equal(got, want)
    assert peak < 3 * ttiff._BATCH_BYTES, peak


BATCHED = ["jpeg_strips_ycbcr", "jpeg_tiles_ycbcr", "lzw_no_end_code",
           "lzw_old_style", "lzw_predictor2_8bit", "planar_rgba_lzw",
           "tiles_lzw", "tiles_planar_deflate_16bit", "planar_rows_lzw",
           "planar_rows_deflate_16bit"]


def _batched_body(name: str) -> bytes:
    """A fixture, or a planar file of several rows of strips written here."""
    if not name.startswith("planar_rows"):
        return _read(name)
    rng = np.random.default_rng(len(name))
    if name.endswith("16bit"):
        return fx.tiff_file(rng.integers(0, 65536, (11, 7, 3)), bps=16,
                            compression=8, planar=2, rows_per_strip=3)
    return fx.tiff_file(rng.integers(0, 256, (9, 13, 4)), compression=5,
                        planar=2, rows_per_strip=2, extra=(2,))


@pytest.mark.parametrize("budget", [1, 3000])
@pytest.mark.parametrize("name", BATCHED)
def test_strips_and_tiles_in_batches_match_pil(monkeypatch, name, budget):
    """Files of several strips or tiles decoded a strip or tile at a time,
    and in runs of them, give PIL's pixels."""
    monkeypatch.setattr(ttiff, "_BATCH_BYTES", budget)
    tf.assert_pil_pixels(tpipe.decode_image, _batched_body(name),
                         (name, budget))


def _ycbcr_tiles() -> bytes:
    return fx.tiff_file(np.full((20, 20, 3), 128), photometric=6,
                        compression=5, tile=(16, 16), tags={530: (3, [1, 1])})


def _lab() -> bytes:
    return fx.tiff_file(np.full((8, 8, 3), 60), photometric=8)


@pytest.mark.parametrize("why,make", [
    ("group4", lambda: fx.pil_tiff(np.eye(16, dtype=np.uint8) * 255, "1",
                                   compression="group4")),
    ("group3", lambda: fx.pil_tiff(np.eye(16, dtype=np.uint8) * 255, "1",
                                   compression="group3")),
    ("tiff_ccitt", lambda: fx.pil_tiff(np.eye(16, dtype=np.uint8) * 255,
                                       "1", compression="tiff_ccitt")),
    ("lzma", lambda: fx.pil_tiff(np.zeros((8, 8, 3), np.uint8), "RGB",
                                 compression="lzma")),
    ("zstd", lambda: fx.pil_tiff(np.zeros((8, 8, 3), np.uint8), "RGB",
                                 compression="zstd")),
    ("YCbCr tiles", _ycbcr_tiles), ("CIELab", _lab)])
def test_left_out_kinds_refused_by_name(why, make):
    """Kinds PIL reads that this slice leaves out (ROADMAP): refused with
    a ValueError that names them."""
    data = make()
    assert tf.pil(data)[0] is not None
    with pytest.raises(ValueError, match=why):
        tpipe.decode_image(data)


def test_big_endian_bigtiff_refused_as_pil_refuses():
    """Pillow takes a big-endian BigTIFF header for a classic one (its
    version byte is read at offset 2) and refuses the file; so does the
    port."""
    data = fx.tiff_file(np.zeros((4, 4, 3), np.int64), bigtiff=True,
                        big_endian=True)
    assert tf.pil(data)[0] is None
    with pytest.raises(ValueError):
        tpipe.decode_image(data)


FUZZ_GROUPS = 4


@pytest.mark.parametrize("group", range(FUZZ_GROUPS))
def test_truncations_and_flips_match_pil(tmp_path, group):
    rng = np.random.default_rng(300 + group)
    cases = []
    for name in [n for n in NAMES if not n.startswith("coco")][
            group::FUZZ_GROUPS]:
        cases += tf.damaged(_read(name), rng, cuts=4, flips=12)
    counts = tf.verdicts_match_pil(cases, tmp_path)
    assert counts["refused"] and counts["decoded"], counts
