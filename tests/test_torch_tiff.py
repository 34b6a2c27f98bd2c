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


@pytest.mark.parametrize("why,make,read", [
    ("group4", lambda: fx.pil_tiff(np.eye(16, dtype=np.uint8) * 255, "1",
                                   compression="group4"), True),
    ("group3", lambda: fx.pil_tiff(np.eye(16, dtype=np.uint8) * 255, "1",
                                   compression="group3"), True),
    ("tiff_ccitt", lambda: fx.pil_tiff(np.eye(16, dtype=np.uint8) * 255,
                                       "1", compression="tiff_ccitt"), True),
    ("lzma", lambda: fx.pil_tiff(np.zeros((8, 8, 3), np.uint8), "RGB",
                                 compression="lzma"), True),
    ("zstd", lambda: fx.pil_tiff(np.zeros((8, 8, 3), np.uint8), "RGB",
                                 compression="zstd"), True),
    ("YCbCr tiles", _ycbcr_tiles, True), ("CIELab", _lab, False),
    ("tiff_thunderscan",
     lambda: fx.thunderscan_tiff(np.random.default_rng(1)), False),
    ("tiff_jpeg", lambda: fx.ojpeg_tiff(np.random.default_rng(2)), False)])
def test_left_out_kinds_refused_by_name(why, make, read):
    """Kinds PIL reads that were left out before: those read now
    (CCITT, LZMA, Zstandard, YCbCr in tiles) give PIL's pixels; those
    still left out (CIELab, ThunderScan, old-style JPEG: ROADMAP) are
    refused with a ValueError that names them."""
    data = make()
    assert tf.pil(data)[0] is not None
    if read:
        tf.assert_pil_pixels(tpipe.decode_image, data, why)
    else:
        with pytest.raises(ValueError, match=why):
            tpipe.decode_image(data)


@pytest.mark.parametrize("code,photometric", [
    (34676, 1), (34677, 2), (50001, 2), (32766, 1), (34661, 1), (9, 1),
    (65000, 2), (6, 2), (6, 6)])
def test_codes_pil_refuses_are_refused(code, photometric):
    """Compression codes PIL refuses on valid-looking strips (SGILog
    without its photometric, WebP: no codec in this libtiff; NeXT, JBIG
    and codes Pillow does not know; old-style JPEG without its
    JPEGInterchangeFormat): refused by the port too."""
    data = fx.unread_code_tiff(np.random.default_rng(code), code,
                               photometric)
    assert tf.pil(data)[0] is None
    with pytest.raises(ValueError):
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


# ---------------------------------------------------------------------------
# CCITT, LZMA, Zstandard, YCbCr tiles, predictor, orientation, planar JPEG
# ---------------------------------------------------------------------------

CCITT = tf.names("tiff_ccitt")


@pytest.mark.parametrize("name", CCITT)
def test_ccitt_fixture_matches_pil(name):
    """Every CCITT fixture (tests/data/tiff_ccitt/: MH, RLE-W, T.4 1-D and
    2-D with and without fill bits and uncompressed mode asked, T.6; both
    fill orders, WhiteIsZero and BlackIsZero; RLE-W strips at odd
    offsets; a T.6 strip cut short) to its stored pixels and PIL's."""
    data = tf.read("tiff_ccitt", name)
    want = tf.stored("tiff_ccitt", name)
    pixels, fmt = tf.pil(data)
    assert fmt == "TIFF" and np.array_equal(pixels, want)
    got = tpipe.decode_image(data)
    assert got.shape == want.shape and np.count_nonzero(got != want) == 0


def test_ccitt_fixtures_are_stored():
    stored = np.load(os.path.join(tf.DATA, "tiff_ccitt", "pixels.npz")).files
    assert sorted(stored) == CCITT and len(CCITT) >= 20


def test_codec_fixtures_cover_the_kinds():
    """The tags the new fixture names promise."""
    def tags(kind, name):
        ifd = ttiff._Ifd(tf.read(kind, name))
        return {t: ifd.get(t) for t in ifd.tags}
    codes = {tags("tiff_ccitt", n)[259] for n in CCITT}
    assert codes == {2, 3, 4, 32771}
    assert tags("tiff_ccitt", "ccitt_g3_2d")[292] == (1,)
    assert tags("tiff_ccitt", "ccitt_g3_2d_fill")[292] == (5,)
    assert tags("tiff_ccitt", "ccitt_g3_uncompressed_option")[292] == (2,)
    assert tags("tiff_ccitt", "ccitt_g4_fill2_white0")[266] == 2
    assert tags("tiff_ccitt", "ccitt_g4_fill2_white0")[262] == 0
    assert tags("tiff_ccitt", "ccitt_rlew_gap1")[273][0] % 2 == 1
    assert {tags("tiff", n)[259] for n in NAMES} >= {34925, 50000}
    assert tags("tiff", "ycbcr_tiles_lzw_2x2")[262] == 6
    assert 322 in tags("tiff", "ycbcr_tiles_lzma_4x4")
    assert tags("tiff", "ycbcr_tiles_lzma_4x4")[530] == (4, 4)
    assert tags("tiff", "ycbcr_lzw_predictor2_2x2")[317] == 2
    assert tags("tiff", "ycbcr_orientation_7")[274] == 7
    planar = tags("tiff", "jpeg_planar_rgb")
    assert planar[259] == 7 and planar[284] == 2
    raw = tf.read("tiff", "lzma_dict_64mib")
    at = ttiff._Ifd(raw).get(273)[0]
    block = raw[at + 12:at + 12 + (raw[at + 12] + 1) * 4]
    prop = block[block.index(b"\x21\x01") + 2]   # LZMA2's dictionary
    assert (2 | prop & 1) << (prop // 2 + 11) >= 64 << 20
    zstd = tf.read("tiff", "zstd_checksum_size")
    at = ttiff._Ifd(zstd).get(273)[0]
    assert zstd[at:at + 4] == b"\x28\xb5\x2f\xfd" and zstd[at + 4] & 4


@pytest.mark.parametrize("comp", ["tiff_ccitt", "tiff_raw_16", "group3",
                                  "group4"])
def test_ccitt_sweep_matches_pil(comp):
    """PIL's CCITT save at odd sizes, in strips, both fill orders and both
    photometrics, T.4 1-D and 2-D."""
    rng = np.random.default_rng(sum(map(ord, comp)))
    for h, w in tf.SIZES + [(40, 300)]:
        bits = fx.fax_pattern(rng, h, w)
        for info in ({}, {278: max(1, h // 3)}, {266: 2, 262: 0},
                     {292: 1, 278: max(1, h // 2)}, {292: 5, 266: 2}):
            if comp != "group3" and 292 in info:
                continue
            data = fx.pil_ccitt(bits, comp, info)
            want, _ = tf.pil(data)
            if want is None:   # PIL refuses (RLE-W of FillOrder 2): so do we
                with pytest.raises(ValueError):
                    tpipe.decode_image(data)
                continue
            got = tpipe.decode_image(data)
            assert np.array_equal(got, want), (h, w, info)


@pytest.mark.parametrize("comp", ["lzma", "zstd"])
def test_lzma_zstd_sweep_matches_pil(comp):
    """PIL's LZMA and Zstandard saves at odd sizes in every mode, and the
    byte-level writer's predictor, tiles and fill order."""
    rng = np.random.default_rng(len(comp))
    code = {"lzma": 34925, "zstd": 50000}[comp]
    for hw in tf.SIZES:
        img = fx.smooth(rng, *hw)
        for mode in fx.PIL_TIFF_MODES:
            src = img if mode in ("RGB", "RGBA", "P", "CMYK") else img[..., 1]
            tf.assert_pil_pixels(tpipe.decode_image, fx.pil_tiff(
                src, mode, compression=comp), (hw, mode))
        s8 = img.astype(np.int64)
        for kw in ({"predictor": 2}, {"tile": (16, 16)},
                   {"fill_order": 2, "rows_per_strip": 5}):
            tf.assert_pil_pixels(tpipe.decode_image, fx.tiff_file(
                s8, compression=code, **kw), (hw, kw))


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4)])
def test_ycbcr_layouts_match_pil(sub):
    """YCbCr not JPEG, through libtiff's TIFFRGBAImage: tiles (each codec,
    odd sizes, clipped edge tiles), a predictor, each orientation."""
    rng = np.random.default_rng(sub[0] * 10 + sub[1])
    for h, w in ((1, 1), (17, 33), (29, 37)):
        for comp in (5, 8, 32773, 34925, 50000):
            data = fx.ycbcr_tiles_tiff(rng, h, w, sub, compression=comp,
                                       tile=(16, 32))
            tf.assert_pil_pixels(tpipe.decode_image, data, (h, w, comp))
        data = fx.ycbcr_tiff(rng, h, w, sub, compression=5,
                             rows_per_strip=sub[1], tags={317: (3, [2])})
        tf.assert_pil_pixels(tpipe.decode_image, data, (h, w, "predictor"))
        for k in (2, 3, 6, 8):
            data = fx.ycbcr_tiff(rng, h, w, sub, compression=8,
                                 rows_per_strip=2 * sub[1],
                                 tags={274: (3, [k])})
            tf.assert_pil_pixels(tpipe.decode_image, data, (h, w, k))


CODEC_RESIZED = [("tiff", "coco_g4"), ("tiff", "coco_lzma"),
                 ("tiff", "coco_zstd"), ("tiff", "ycbcr_tiles_lzw_2x2"),
                 ("tiff_ccitt", "ccitt_g3_2d_fill2_white0")]


@pytest.mark.parametrize("kind,name", CODEC_RESIZED)
def test_codec_entry_points_match_jax(kind, name):
    """_decode_resize and serve._decode_to equal the JAX package's for a
    T.6, an LZMA, a Zstandard and a YCbCr-tiled TIFF."""
    path = os.path.join(tf.DATA, kind, f"{name}.tif")
    for size in (32, 100):
        assert np.array_equal(tpipe._decode_resize(path, size),
                              jpipe._decode_resize(path, size)), size
    data = tf.read(kind, name)
    assert np.array_equal(tserve._decode_to(64, data),
                          jserve._decode_to(64, data))


def _zstd_frame(raw: bytes, window_log: int) -> bytes:
    """A Zstandard frame of one raw block whose window descriptor declares
    2^window_log bytes."""
    head = b"\x28\xb5\x2f\xfd" + bytes([0, (window_log - 10) << 3])
    return head + struct.pack("<I", (len(raw) << 3) | 1)[:3] + raw


def _xz_huge_dictionary(raw: bytes) -> bytes:
    """An xz stream of raw whose LZMA2 filter declares a 1.5 GiB
    dictionary (its block header's CRC32 made anew)."""
    import lzma

    data = bytearray(lzma.compress(raw, format=lzma.FORMAT_XZ,
                                   filters=[{"id": lzma.FILTER_LZMA2,
                                             "dict_size": 1 << 16}]))
    size = (data[12] + 1) * 4
    header = data[12:12 + size]
    at = header.index(b"\x21\x01") + 2
    header[at] = 37   # (2 | 1) << (18 + 11): 1.5 GiB
    header[-4:] = zlib.crc32(bytes(header[:-4])).to_bytes(4, "little")
    data[12:12 + size] = header
    return bytes(data)


def _hostile_codecs() -> dict:
    """Bodies declaring sizes far beyond their data: name -> (body, PIL
    reads it, what a refusal names)."""
    grey = np.full((4, 4, 1), 9)
    px = np.arange(48).reshape(4, 4, 3)
    return {
        "zstd_window_2gib": (fx.tiff_file(
            grey, photometric=1, tags={259: (3, [50000])},
            chunk_hook=lambda i, b: _zstd_frame(b, 31)), False, "2\\^27"),
        "zstd_window_128mib": (fx.tiff_file(
            grey, photometric=1, tags={259: (3, [50000])},
            chunk_hook=lambda i, b: _zstd_frame(b, 27)), True, None),
        "lzma_dictionary_1536mib": (fx.tiff_file(
            px, tags={259: (3, [34925])},
            chunk_hook=lambda i, b: _xz_huge_dictionary(b)), True, None),
    }


def test_codec_hostile_bodies_as_pil():
    """Each hostile body gets PIL's verdict: the 2 GiB Zstandard window
    refused (before allocating: a tracemalloc peak under 1 MiB), the 128
    MiB window and the 1.5 GiB LZMA dictionary read; and a T.6 row of
    200,000 pixels (libtiff's run arrays 3.2 MB) in 3 bytes read as PIL
    reads it."""
    for name, (data, read, why) in _hostile_codecs().items():
        want, _ = tf.pil(data)
        assert (want is not None) == read, name
        tracemalloc.start()
        try:
            if read:
                got = tpipe.decode_image(data)
            else:
                with pytest.raises(ValueError, match=why):
                    tpipe.decode_image(data)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert peak < 1 << 20, (name, peak)
        if read:
            assert np.array_equal(got, want), name
    wide = fx.tiff_file(np.zeros((2, 1, 1), np.int64), bps=1, photometric=1,
                        tags={256: (4, [200_000]), 259: (3, [4])},
                        chunk_hook=lambda i, b: b"\xff\xff\xff")
    tf.assert_pil_pixels(tpipe.decode_image, wide, "wide T.6")


# a T.6 strip of one row of 100 million pixels in 3 bytes: libtiff's two
# run arrays of 2 x (pixels + 32) entries take 1.6 GB
_WIDE_FAX = """
import resource
import numpy as np
from mastermetastyletransfer_tpu_torch.data import native_loader as nl
nl._library()
with open('/proc/self/status') as f:
    vm = [int(l.split()[1]) for l in f if l.startswith('VmSize')][0] * 1024
resource.setrlimit(resource.RLIMIT_AS, (vm + (64 << 20),) * 2)
width = 100_000_000
out = np.zeros((width + 7) // 8, np.uint8)
data = b"\\xff\\xff\\xff"
chunk = np.array([(0, 3, out.size, width, 1, 0, 0)], nl.TIFF_CHUNK)
nl.decode_tiff(4, data, chunk, False, b"", 2, 1, out)
print("DECODED", int(out.min()), int(out.max()))
"""


def test_codec_hostile_bodies_under_an_address_space_limit():
    """The same bodies in a process that cannot map 128 MiB more: the
    native decoders allocate neither the Zstandard window nor the LZMA
    dictionary; and a T.6 row of 100 million pixels decodes in 64 MiB
    more, its run arrays held to its 3 bytes of data."""
    code = ("import resource, sys\n"
            "from mastermetastyletransfer_tpu_torch.data import pipeline, "
            "native_loader\n"
            "from mastermetastyletransfer_tpu_torch.utils import tiff\n"
            "from tests import test_torch_tiff as t\n"
            "native_loader._library(); tiff._liblzma()\n"
            "bodies = t._hostile_codecs()\n"
            "with open('/proc/self/status') as f:\n"
            "    vm = [int(l.split()[1]) for l in f if l.startswith('VmSize')]"
            "[0] * 1024\n"
            "resource.setrlimit(resource.RLIMIT_AS, (vm + (128 << 20),) * 2)\n"
            "for name in sorted(bodies):\n"
            "    try:\n"
            "        px = pipeline.decode_image(bodies[name][0])\n"
            "        print(name, 'DECODED', px.shape)\n"
            "    except ValueError as e:\n"
            "        print(name, 'REFUSED', e)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tf.ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines())
    for name, (_, read, _) in _hostile_codecs().items():
        assert lines[name].startswith("DECODED" if read else "REFUSED"), (
            name, lines[name])
    proc = subprocess.run([sys.executable, "-c", _WIDE_FAX], cwd=tf.ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("DECODED"), proc.stdout


def _crafted_zstd() -> dict:
    """Zstandard strips made byte by byte: each (strip bytes) for a 4 x 4
    grey image."""
    raw = bytes(range(16))
    frame = _zstd_frame(raw, 10)
    rle = (b"\x28\xb5\x2f\xfd\x00\x00" + struct.pack("<I", (16 << 3) | 3)[:3]
           + b"\x07")
    return {
        "raw_block": frame,
        "rle_block": rle,
        "skippable_first": b"\x50\x2a\x4d\x18" + struct.pack("<I", 3)
                           + b"abc" + frame,
        "dictionary_id": frame[:4] + b"\x01" + frame[5:6] + b"\x05"
                         + frame[6:],
        "reserved_bit": frame[:4] + b"\x08" + frame[5:],
        "reserved_block_type": frame[:6] + b"\x07\x00\x00",
        "short_block": _zstd_frame(raw[:10], 10),
        "two_frames": _zstd_frame(raw[:8], 10)[:-8] + raw[:8].replace(
            b"", b"")[:0] + _zstd_frame(raw[:8], 10)[6:9] + raw[:8]
                       + frame,
        "checksum_bad": zstandard_checked(raw, bad=True),
        "checksum_good": zstandard_checked(raw, bad=False),
        "content_size_short": zstandard_sized(raw, 12),
    }


def zstandard_checked(raw: bytes, bad: bool) -> bytes:
    import zstandard

    data = bytearray(zstandard.ZstdCompressor(
        write_checksum=True, write_content_size=False).compress(raw))
    if bad:
        data[-1] ^= 0xFF
    return bytes(data)


def zstandard_sized(raw: bytes, declared: int) -> bytes:
    """A single-segment frame of raw that declares ``declared`` bytes."""
    return (b"\x28\xb5\x2f\xfd\x20" + bytes([declared])
            + struct.pack("<I", (len(raw) << 3) | 1)[:3] + raw)


@pytest.mark.parametrize("name", sorted(_crafted_zstd()))
def test_crafted_zstd_frames_as_pil(name):
    """Frames libzstd takes or refuses (raw and RLE blocks, a skippable
    frame first, a dictionary ID, reserved bits and block types, a block
    short of the strip, a checksum, a content size that does not hold):
    the port's verdict and pixels are PIL's."""
    strip = _crafted_zstd()[name]
    data = fx.tiff_file(np.zeros((4, 4, 1), np.int64), photometric=1,
                        tags={259: (3, [50000])},
                        chunk_hook=lambda i, b: strip)
    want, _ = tf.pil(data)
    if want is None:
        with pytest.raises(ValueError):
            tpipe.decode_image(data)
    else:
        assert np.array_equal(tpipe.decode_image(data), want)


@pytest.mark.parametrize("group", range(FUZZ_GROUPS))
def test_ccitt_truncations_and_flips_match_pil(tmp_path, group):
    """Truncations and byte flips of every CCITT fixture, decoded in a
    subprocess: PIL's verdict and pixels, but for rows PIL takes from
    memory it never wrote (a T.6 strip that ends early in the first
    strips), which libtiff's own decoding of the strip shows."""
    rng = np.random.default_rng(500 + group)
    cases, rps = [], {}
    for name in CCITT[group::FUZZ_GROUPS]:
        data = tf.read("tiff_ccitt", name)
        for case in tf.damaged(data, rng, cuts=4, flips=12):
            rps[len(cases)] = ttiff._Ifd(data).get(278)
            cases.append(case)
    index = {id(c): i for i, c in enumerate(cases)}

    def unwritten(case):
        return tf.unwritten_rows(case, rps[index[id(case)]], tmp_path)
    counts = tf.verdicts_match_pil(cases, tmp_path, unwritten)
    assert counts["refused"] and counts["decoded"], counts
