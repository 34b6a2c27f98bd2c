"""The port's image codecs against PIL (and the JAX package's request
decode and batch loader) on the CPU: the JPEG decoder (sequential and
progressive, at full size and at n/8 of it) and the baseline encoder of
``native/jpeg.cpp`` through ``data/native_loader.py``, the PNG reader of
``utils/png.py`` and ``serve._decode_to``. The other kinds PIL reads
(arithmetic-coded, lossless, CMYK and smoothed JPEG; every PNG and BMP
kind) are held to PIL in tests/test_torch_image_kinds.py.

The JPEGs are written here by PIL (libjpeg-turbo) from numpy seeds. Bounds:
the decoder within 1 level of PIL's pixels and equal in at least 99% of
the samples (it computes libjpeg's own integer arithmetic, so
every case here is equal; the share that differs is printed), progressive
files and the scaled decode bit for bit with PIL's; the encoder's
PSNR within 0.2 dB of PIL's own quality-95 JPEG and its size within 10%
(it writes libjpeg's bytes, so both are equal); the PNG reader bit for bit;
``_decode_to`` within 2/255 max and 0.3/255 mean of JAX's.
"""

import ctypes
import io
import resource
import struct
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from mastermetastyletransfer_tpu import serve as jserve
from mastermetastyletransfer_tpu.data import native_loader as jnative
from mastermetastyletransfer_tpu_torch import serve as tserve
from mastermetastyletransfer_tpu_torch.data import native_loader as tnative
from mastermetastyletransfer_tpu_torch.data import pipeline as tpipe
from mastermetastyletransfer_tpu_torch.utils.png import png_bytes, read_png
from scripts import make_image_fixtures, make_jpeg_fixtures

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
MAX_LEVELS, MIN_EQUAL = 1, 0.99
PSNR_DB, SIZE_REL = 0.2, 0.10


def _smooth(rng, h, w):
    return make_jpeg_fixtures.smooth(rng, h, w)


def _jpeg(img, **kw):
    return make_jpeg_fixtures.jpeg(img, **kw)


def _pil(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _held_to_pil(data, label):
    want = _pil(data)
    got = tnative.decode_jpeg(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want)
    share = float((diff > 0).mean())
    print(f"{label}: max {diff.max()} levels, {share:.4%} of samples differ")
    assert diff.max() <= MAX_LEVELS and share <= 1 - MIN_EQUAL, label


# (subsampling, quality, (H, W), extra save options)
JPEG_CASES = {
    "444_q95": (0, 95, (48, 64), {}),
    "422_q95": (1, 95, (48, 64), {}),
    "420_q95": (2, 95, (48, 64), {}),
    "420_q50": (2, 50, (48, 64), {}),
    "444_odd": (0, 90, (37, 23), {}),
    "422_odd": (1, 90, (37, 23), {}),
    "420_odd": (2, 90, (37, 23), {}),
    "420_thin": (2, 90, (3, 70), {}),
    "420_restart_blocks": (2, 85, (40, 56), {"restart_marker_blocks": 3}),
    "422_restart_rows": (1, 85, (40, 56), {"restart_marker_rows": 1}),
    "420_noise": (2, 75, (33, 45), {}),
}


@pytest.mark.parametrize("case", list(JPEG_CASES))
def test_jpeg_decoder_matches_pil(case):
    sub, quality, (h, w), kw = JPEG_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    img = (rng.integers(0, 256, (h, w, 3), np.uint8) if "noise" in case
           else _smooth(rng, h, w))
    _held_to_pil(_jpeg(img, quality=quality, subsampling=sub, **kw), case)


@pytest.mark.parametrize("hw", [(48, 64), (37, 23), (5, 3)])
def test_jpeg_decoder_matches_pil_at_440(hw):
    """4:4:0 (h1v2 fancy upsampling): PIL's 4:2:2 file of the transposed
    size with its frame header rewritten (scripts/make_jpeg_fixtures.py)."""
    rng = np.random.default_rng(hw[0])
    data = make_jpeg_fixtures.as_440(
        _jpeg(_smooth(rng, hw[1], hw[0]), quality=90, subsampling=1))
    assert _pil(data).shape == hw + (3,)
    _held_to_pil(data, f"440 {hw}")


@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_decoder_matches_pil_on_grayscale(quality):
    rng = np.random.default_rng(quality)
    gray = np.asarray(Image.fromarray(_smooth(rng, 37, 41)).convert("L"))
    _held_to_pil(_jpeg(gray, quality=quality), f"gray q{quality}")


def test_jpeg_decoder_refuses_what_it_does_not_read():
    """What PIL reads decodes to PIL's pixels: a progressive file, and the
    arithmetic-coded (SOF9, SOF10), lossless (SOF3) and CMYK files that
    were once refused. What PIL refuses raises, naming it: a truncated or
    foreign body, a hierarchical frame (its markers named, the
    progressive ones among them) and a 12-bit one."""
    img = _smooth(np.random.default_rng(1), 32, 32)
    prog = _jpeg(img, quality=90, progressive=True)
    assert np.array_equal(tnative.decode_jpeg(prog), _pil(prog))
    data = _jpeg(img, quality=90)
    cmyk = np.dstack([img, img[:, :, :1]])
    for read in (make_jpeg_fixtures.libjpeg_file(img, arith=True),
                 make_jpeg_fixtures.libjpeg_file(img, arith=True, scans="p"),
                 make_jpeg_fixtures.lossless_jpeg([img[:, :, 0]], [(1, 1)]),
                 make_jpeg_fixtures.libjpeg_file(cmyk, space="cmyk"),
                 make_jpeg_fixtures.libjpeg_file(cmyk, space="ycck")):
        assert np.array_equal(tnative.decode_jpeg(read), _pil(read))
    for broken in (data[:len(data) // 3], b"\xff\xd8\xff\xd9",
                   b"not a jpeg", prog[:len(prog) // 2]):
        with pytest.raises(ValueError, match="JPEG"):
            tnative.decode_jpeg(broken)
    for body, sof, markers in ((data, b"\xff\xc0", (0xC5, 0xC7, 0xCD)),
                               (prog, b"\xff\xc2", (0xC6, 0xCE, 0xCF))):
        for marker in markers:
            patched = body.replace(sof, bytes([0xFF, marker]), 1)
            with pytest.raises(ValueError, match=f"hierarchical JPEG "
                                                 f"\\(SOF{marker - 0xC0}\\)"):
                tnative.decode_jpeg(patched)
        i = body.index(sof)
        twelve = body[:i + 4] + b"\x0c" + body[i + 5:]
        with pytest.raises(ValueError, match=r"12-bit JPEG \(SOF[02]\)"):
            tnative.decode_jpeg(twelve)


# ---------------------------------------------------------------------------
# progressive JPEG
# ---------------------------------------------------------------------------

def _held_to_pil_exactly(data, label):
    want = _pil(data)
    got = tnative.decode_jpeg(data)
    assert got.shape == want.shape and got.dtype == np.uint8, label
    assert np.array_equal(got, want), (
        label, int(np.abs(got.astype(int) - want).max()))


# (subsampling, quality, (H, W), extra save options); "gray" and "440" are
# the grayscale and 4:4:0 files.
PROGRESSIVE_CASES = {
    "444_q95": (0, 95, (48, 64), {}),
    "422_q95": (1, 95, (48, 64), {}),
    "420_q95": (2, 95, (48, 64), {}),
    "420_q50": (2, 50, (48, 64), {}),
    "440_q90": ("440", 90, (48, 64), {}),
    "gray_q50": ("gray", 50, (37, 41), {}),
    "gray_q95": ("gray", 95, (37, 41), {}),
    "444_odd": (0, 90, (37, 23), {}),
    "422_odd": (1, 90, (37, 23), {}),
    "420_odd": (2, 90, (37, 23), {}),
    "440_odd": ("440", 90, (37, 23), {}),
    "420_thin": (2, 90, (3, 70), {}),
    "420_optimize": (2, 90, (45, 61), {"optimize": True}),
    "444_optimize": (0, 50, (45, 61), {"optimize": True}),
    "gray_optimize": ("gray", 90, (45, 61), {"optimize": True}),
    "420_restart_blocks": (2, 85, (40, 56), {"restart_marker_blocks": 3}),
    "422_restart_rows": (1, 85, (40, 56), {"restart_marker_rows": 1}),
    "gray_restart_blocks": ("gray", 85, (40, 56),
                            {"restart_marker_blocks": 1}),
    "420_noise": (2, 75, (33, 45), {}),
}


def progressive_jpeg(sub, quality, hw, rng, **kw):
    """PIL's progressive JPEG of a seeded image: ``sub`` 0, 1, 2 (4:4:4,
    4:2:2, 4:2:0), "440" (PIL's 4:2:2 file of the transposed size, its
    frame header rewritten; scripts/make_jpeg_fixtures.py) or "gray"."""
    h, w = hw
    if sub == "440":
        return make_jpeg_fixtures.as_440(_jpeg(
            _smooth(rng, w, h), quality=quality, subsampling=1,
            progressive=True, **kw))
    img = (rng.integers(0, 256, (h, w, 3), np.uint8)
           if kw.pop("noise", False) else _smooth(rng, h, w))
    if sub == "gray":
        return _jpeg(np.asarray(Image.fromarray(img).convert("L")),
                     quality=quality, progressive=True, **kw)
    return _jpeg(img, quality=quality, subsampling=sub, progressive=True,
                 **kw)


@pytest.mark.parametrize("case", list(PROGRESSIVE_CASES))
def test_progressive_decoder_matches_pil(case):
    sub, quality, hw, kw = PROGRESSIVE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    data = progressive_jpeg(sub, quality, hw, rng, noise="noise" in case,
                            **kw)
    assert b"\xff\xc2" in data
    _held_to_pil_exactly(data, case)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       sub=st.sampled_from([0, 1, 2, "gray"]),
       quality=st.sampled_from([30, 75, 95]))
def test_progressive_decoder_matches_pil_at_any_size(h, w, sub, quality):
    rng = np.random.default_rng(h * 71 + w)
    data = progressive_jpeg(sub, quality, (h, w), rng)
    _held_to_pil_exactly(data, (h, w, sub, quality))


def _segments(data):
    """(marker, start, end) of each marker segment and its entropy-coded
    data up to the next marker (SOI and EOI have no payload)."""
    out, i = [], 2
    while i < len(data) - 1:
        marker = data[i + 1]
        if marker == 0xD9:
            out.append((marker, i, i + 2))
            break
        end = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
        if marker == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in
                       (0x00, *range(0xD0, 0xD8))):
                end += 1
        out.append((marker, i, end))
        i = end
    return out


def test_progressive_decoder_refuses_a_scan_decoded_twice():
    """A scan repeated (the same band and bit of the same component) is a
    bogus progression that libjpeg warns of and decodes all the same: PIL
    reads it, and so does the port, to PIL's pixels; a scan whose
    parameters break the progression's rules (JERR_BAD_PROGRESSION: an AC
    band of two components, Al not Ah - 1) is refused by both."""
    data = _jpeg(_smooth(np.random.default_rng(2), 40, 40), quality=90,
                 progressive=True)
    scans = [(a, b) for m, a, b in _segments(data) if m == 0xDA]
    for a, b in (scans[0], scans[3]):
        twice = data[:b] + data[a:b] + data[b:]
        _held_to_pil_exactly(twice, ("twice", a))
    a = scans[3][0]
    assert data[a + 4] == 1   # one component: Ah/Al at a + 9
    bad = data[:a + 9] + bytes([0x31]) + data[a + 10:]
    with pytest.raises(OSError):
        _pil(bad)
    with pytest.raises(ValueError, match="bad progressive scan"):
        tnative.decode_jpeg(bad)
    assert np.array_equal(tnative.decode_jpeg(data), _pil(data))


def test_progressive_decoder_refuses_what_libjpeg_would_smooth():
    """A progressive file whose scans stop after the DC (its first AC
    coefficients never decoded, EOI after them), or after any later scan
    but the last, is one that libjpeg block-smooths (jdcoefct.c): the
    decoder smooths it as PIL's libjpeg-turbo does, to PIL's pixels, at
    4:2:0, 4:4:4 and grey."""
    rng = np.random.default_rng(3)
    for sub in (2, 0, "gray"):
        data = progressive_jpeg(sub, 90, (40, 40), rng)
        first_ac = next(a for m, a, b in _segments(data)
                        if m == 0xDA and data[a + 5 + 2 * data[a + 4]] != 0)
        cut = data[:first_ac] + b"\xff\xd9"
        _held_to_pil_exactly(cut, (sub, "DC only"))
        scans = [b for m, a, b in _segments(data) if m == 0xDA]
        for end in scans[1:-1]:
            _held_to_pil_exactly(data[:end] + b"\xff\xd9", (sub, end))


def progressive_bomb() -> bytes:
    """A grayscale progressive JPEG whose frame header claims 65535 x 2730
    pixels (under the pixel limit) with enough bytes before its frame to
    pass the bound on the blocks a byte can code: its coefficient buffer,
    65536 x 2736 coefficients, is above the limit for one component."""
    gray = np.asarray(Image.fromarray(_smooth(np.random.default_rng(4),
                                              16, 16)).convert("L"))
    data = _jpeg(gray, quality=90, progressive=True)
    i = data.index(b"\xff\xc2")
    data = data[:i + 5] + struct.pack(">HH", 2730, 65535) + data[i + 9:]
    com = b"\xff\xfe" + struct.pack(">H", 65535) + bytes(65533)
    return data[:2] + com * 6 + data[2:]


def test_progressive_bomb_refused_before_allocating():
    data = progressive_bomb()
    assert 65535 * 2730 <= 2 * 89478485 and len(data) < 400_000
    tnative.decode_jpeg(_jpeg(_smooth(np.random.default_rng(1), 8, 8),
                              progressive=True))
    before = _max_rss_mb()
    with pytest.raises(ValueError, match="coefficient buffer .* above the "
                                         "limit"):
        tnative.decode_jpeg(data)
    assert _max_rss_mb() - before < 64


# ---------------------------------------------------------------------------
# the scaled decode (libjpeg's scale_num / scale_denom)
# ---------------------------------------------------------------------------

def decode_scaled(data: bytes, n: int) -> np.ndarray:
    """``mmst_jpeg_decode_scaled`` at n/8 (its C ABI)."""
    lib = tnative._library()
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    assert lib.mmst_jpeg_info(data, len(data), ctypes.byref(w),
                              ctypes.byref(h), err, 256) == 0, err.value
    out = np.empty(((h.value * n + 7) // 8, (w.value * n + 7) // 8, 3),
                   np.uint8)
    if lib.mmst_jpeg_decode_scaled(data, len(data), n,
                                   out.ctypes.data_as(tnative._u8p),
                                   out.shape[1], out.shape[0], err, 256):
        raise ValueError(err.value.decode())
    return out


def _pil_draft(data: bytes, denom: int) -> np.ndarray:
    """PIL's decode at 1/denom (``Image.draft``: libjpeg's scale_num 1,
    scale_denom ``denom``, its defaults otherwise)."""
    with Image.open(io.BytesIO(data)) as im:
        w, h = im.size
        im.draft("RGB", (max(w // denom, 1), max(h // denom, 1)))
        assert im.size == ((w + denom - 1) // denom, (h + denom - 1) // denom)
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("denom", [2, 4, 8])
@pytest.mark.parametrize("sub", [0, 1, 2, "440", "gray"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_scaled_decode_matches_pil_draft(denom, sub, progressive):
    """n/8 = 1/2, 1/4, 1/8 (the 4 x 4, 2 x 2 and 1 x 1 IDCTs; 4:2:0 chroma
    at twice that), odd sizes, bit for bit with PIL's draft decode."""
    for hw in ((61, 83), (37, 23)):
        rng = np.random.default_rng(denom * 100 + hw[0])
        if progressive:
            data = progressive_jpeg(sub, 90, hw, rng)
        elif sub == "440":
            data = make_jpeg_fixtures.as_440(
                _jpeg(_smooth(rng, hw[1], hw[0]), quality=90, subsampling=1))
        elif sub == "gray":
            data = _jpeg(np.asarray(Image.fromarray(_smooth(rng, *hw))
                                    .convert("L")), quality=90)
        else:
            data = _jpeg(_smooth(rng, *hw), quality=90, subsampling=sub)
        got, want = decode_scaled(data, 8 // denom), _pil_draft(data, denom)
        assert got.shape == want.shape and np.array_equal(got, want), (
            hw, int(np.abs(got.astype(int) - want).max()))


def test_scaled_decode_refuses_other_scales():
    data = _jpeg(_smooth(np.random.default_rng(6), 16, 16))
    assert np.array_equal(decode_scaled(data, 8), tnative.decode_jpeg(data))
    for n in (0, 9):
        with pytest.raises(ValueError, match="out of 1..8"):
            decode_scaled(data, n)


def with_frame_size(data: bytes, h: int, w: int) -> bytes:
    """A JPEG whose frame header (SOF0) claims h x w pixels."""
    i = data.index(b"\xff\xc0")
    return data[:i + 5] + struct.pack(">HH", h, w) + data[i + 9:]


def with_dc_symbol(data: bytes, symbol: int) -> bytes:
    """A JPEG whose first DC Huffman table has ``symbol`` as its first
    value (a DC symbol is a coefficient's bit length: 15 at the most)."""
    i = data.index(b"\xff\xc4")
    assert data[i + 4] == 0x00   # class 0 (DC), table 0
    return data[:i + 21] + bytes([symbol]) + data[i + 22:]


def bomb_bodies() -> dict:
    """Small JPEGs that claim what no request may make the decoder
    allocate, each with the reason it is refused: frames above PIL's
    decompression-bomb limit (2 x 89,478,485 pixels), a frame far larger
    than its bytes could code, and a DC table symbol of 200."""
    data = _jpeg(_smooth(np.random.default_rng(11), 32, 32), quality=90)
    return {
        "65535x65535": (with_frame_size(data, 65535, 65535),
                        "decompression bomb"),
        "above_limit": (with_frame_size(data, 10923, 16384),
                        "decompression bomb"),
        "short_data": (with_frame_size(data, 4000, 4000),
                       "cannot hold a 4000x4000 frame"),
        "dc_symbol_200": (with_dc_symbol(data, 200), "DC symbol above 15"),
    }


def _max_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


@pytest.mark.parametrize("case", list(bomb_bodies()))
def test_jpeg_decoder_refuses_bombs_before_allocating(case):
    """A 1 KB body may not make the decoder allocate its claimed frame:
    each is refused with its reason, the process's peak memory unmoved
    (65535^2 would be some 13 GB of planes)."""
    data, why = bomb_bodies()[case]
    assert len(data) < 2000
    tnative.decode_jpeg(_jpeg(_smooth(np.random.default_rng(1), 8, 8)))
    before = _max_rss_mb()
    with pytest.raises(ValueError, match=why):
        tnative.decode_jpeg(data)
    assert _max_rss_mb() - before < 64


@pytest.mark.parametrize("symbol", [15, 16])
def test_jpeg_decoder_dc_symbols_up_to_15(symbol):
    """libjpeg's bound on a DC table: 15 is read (the file then decodes as
    far as its codes allow), 16 is refused."""
    data = with_dc_symbol(
        _jpeg(_smooth(np.random.default_rng(12), 16, 16), quality=90),
        symbol)
    if symbol > 15:
        with pytest.raises(ValueError, match="DC symbol above 15"):
            tnative.decode_jpeg(data)
    else:
        assert tnative.decode_jpeg(data).shape == (16, 16, 3)


def test_fixtures_decode_to_their_stored_pixels():
    """The card's fixtures: PIL decodes each to the stored pixels, and so
    does the port's decoder (what chip_smoke.py's codecs phase checks)."""
    stored = np.load(FIXTURES / "pixels.npz")
    names = sorted(p.stem for p in FIXTURES.glob("*.jpg")
                   if not p.stem.startswith("src_"))
    assert names == sorted(stored.files) and len(names) == 11
    assert sum(n.startswith("progressive_") for n in names) == 4
    total = sum((FIXTURES / f"{n}.jpg").stat().st_size for n in names)
    assert total + (FIXTURES / "pixels.npz").stat().st_size < 200_000
    for name in names:
        data = (FIXTURES / f"{name}.jpg").read_bytes()
        assert np.array_equal(_pil(data), stored[name]), name
        assert np.array_equal(tnative.decode_jpeg(data), stored[name]), name


def test_prescale_fixtures_are_the_jax_loaders_batches():
    """The card's prescale fixtures: the JAX package's loader gives the
    stored batch of each source at each target (one per scale n/8, n =
    1..8), and so does the port's loader."""
    stored = np.load(FIXTURES / "prescale.npz")
    names = [name for name, *_ in make_jpeg_fixtures.PRESCALE_SOURCES]
    files = [FIXTURES / f"{name}.jpg" for name in names]
    total = sum(f.stat().st_size for f in files)
    assert total + (FIXTURES / "prescale.npz").stat().st_size < 400_000
    keys = []
    for name, path in zip(names, files):
        with Image.open(path) as im:
            w, h = im.size
        targets = make_jpeg_fixtures.prescale_targets(w, h)
        assert [make_jpeg_fixtures.jax_loader_scale(w, h, t)
                for t in targets] == list(range(1, 9))
        for t in targets:
            want = stored[f"{name}_{t}"]
            keys.append(f"{name}_{t}")
            assert np.array_equal(
                jnative.decode_resize_batch([str(path)], t)[0], want)
            assert np.array_equal(
                tnative.decode_resize_batch([str(path)], t)[0], want)
    assert sorted(keys) == sorted(stored.files)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("hw", [(64, 64), (61, 97), (100, 33), (1, 1)])
def test_jpeg_encoder_against_pil(hw):
    """PIL reads the port's quality-95 JPEG; its PSNR and size against
    PIL's own are within the bounds (and the bytes are PIL's)."""
    rng = np.random.default_rng(hw[0] * 3 + hw[1])
    img = _smooth(rng, *hw)
    ours = tnative.encode_jpeg(img, 95)
    pils = _jpeg(img, quality=95)
    with Image.open(io.BytesIO(ours)) as im:
        assert im.format == "JPEG" and im.size == (hw[1], hw[0])
        decoded = np.asarray(im.convert("RGB"))
    if hw != (1, 1):
        assert abs(_psnr(decoded, img) - _psnr(_pil(pils), img)) <= PSNR_DB
    assert abs(len(ours) - len(pils)) <= SIZE_REL * len(pils)
    assert ours == pils


def test_jpeg_encoder_refuses_other_arrays():
    with pytest.raises(ValueError, match="uint8"):
        tnative.encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        tnative.encode_jpeg(np.zeros((4, 4), np.uint8))


def test_codec_is_thread_safe():
    """Sixteen threads (more than the cores), the interpreter switching
    often, decode and encode different images at once, half of them
    progressive files; each result equals the same call made alone."""
    rng = np.random.default_rng(5)
    imgs = [_smooth(rng, 40 + 8 * i, 56) for i in range(16)]
    datas = [_jpeg(img, quality=90, subsampling=i % 3, progressive=i % 2)
             for i, img in enumerate(imgs)]
    alone = [(tnative.decode_jpeg(d), tnative.encode_jpeg(img, 95))
             for d, img in zip(datas, imgs)]
    results = [None] * len(imgs)

    def work(i):
        out = None
        for _ in range(20):
            out = (tnative.decode_jpeg(datas[i]),
                   tnative.encode_jpeg(imgs[i], 95))
        results[i] = out

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(imgs))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    for (a_px, a_jpg), (b_px, b_jpg) in zip(alone, results):
        assert np.array_equal(a_px, b_px) and a_jpg == b_jpg


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

PNG_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


@pytest.mark.parametrize("ctype", list(PNG_MODES))
@pytest.mark.parametrize("content", ["smooth", "noise"])
def test_png_reader_matches_pil(ctype, content):
    """Colour types 0, 2, 3, 4 and 6 as PIL writes them (its adaptive row
    filters: all five kinds) and at compress_level 0, bit for bit with
    PIL's convert("RGB")."""
    rng = np.random.default_rng(ctype)
    rgb = (_smooth(rng, 45, 61) if content == "smooth"
           else rng.integers(0, 256, (45, 61, 3), np.uint8))
    im = Image.fromarray(rgb)
    if ctype == 6:
        im = Image.fromarray(np.dstack([rgb, rgb[:, :, 1]]), "RGBA")
    else:
        im = im.convert(PNG_MODES[ctype])
    for kw in ({}, {"compress_level": 0}, {"optimize": True}):
        buf = io.BytesIO()
        im.save(buf, "PNG", **kw)
        data = buf.getvalue()
        with Image.open(io.BytesIO(data)) as back:
            want = np.asarray(back.convert("RGB"))
        assert np.array_equal(read_png(data), want), (ctype, kw)


def test_png_reader_refuses_interlaced_and_16_bit():
    """Adam7 and 16-bit files, once refused, read to PIL's pixels: an
    interlaced RGB file (PIL writes none: scripts/make_image_fixtures.py)
    and PIL's own 16-bit grey one ("I;16", clipped at 255). A depth its
    colour type does not take (3-bit grey, 16-bit palette) is refused by
    PIL and by the reader."""
    rgb = _smooth(np.random.default_rng(2), 20, 20)
    data = make_image_fixtures.png_file(rgb, 8, 2, interlace=True)
    assert np.array_equal(read_png(data), _pil(data))
    assert np.array_equal(read_png(data), rgb)
    buf = io.BytesIO()
    Image.fromarray(rgb[:, :, 0].astype(np.uint16) * 257).save(buf, "PNG")
    assert np.array_equal(read_png(buf.getvalue()), _pil(buf.getvalue()))
    for depth, ctype in ((3, 0), (16, 3)):
        bad = bytearray(png_bytes(rgb))
        ihdr = bad.index(b"IHDR")
        bad[ihdr + 12:ihdr + 14] = bytes([depth, ctype])
        bad[ihdr + 17:ihdr + 21] = struct.pack(
            ">I", zlib.crc32(bytes(bad[ihdr:ihdr + 17])) & 0xFFFFFFFF)
        with pytest.raises(Exception):
            _pil(bytes(bad))
        with pytest.raises(ValueError, match=f"at {depth} bits"):
            read_png(bytes(bad))
    assert np.array_equal(read_png(png_bytes(rgb)), rgb)


def png_bomb() -> bytes:
    """A PNG whose header claims 65535 x 65535 RGB pixels."""
    data = bytearray(png_bytes(np.zeros((2, 2, 3), np.uint8)))
    ihdr = data.index(b"IHDR")
    data[ihdr + 4:ihdr + 12] = struct.pack(">II", 65535, 65535)
    data[ihdr + 17:ihdr + 21] = struct.pack(
        ">I", zlib.crc32(bytes(data[ihdr:ihdr + 17])) & 0xFFFFFFFF)
    return bytes(data)


def test_png_reader_refuses_bombs():
    """A header above PIL's decompression-bomb limit is refused before the
    data is inflated; image data that inflates far past the image (64 MB
    of zeros behind a 4 x 4 header) is inflated only as far as the image
    needs."""
    with pytest.raises(ValueError, match="decompression bomb"):
        read_png(png_bomb())
    z = zlib.compressobj()
    idat = b"".join(z.compress(bytes(1 << 20)) for _ in range(64)) + z.flush()
    data = bytearray(png_bytes(np.zeros((4, 4, 3), np.uint8)))
    i = data.index(b"IDAT") - 4
    (n,) = struct.unpack(">I", data[i:i + 4])
    body = (struct.pack(">I", len(idat)) + b"IDAT" + idat
            + struct.pack(">I", zlib.crc32(b"IDAT" + idat) & 0xFFFFFFFF))
    data = bytes(data[:i]) + body + bytes(data[i + 12 + n:])
    before = _max_rss_mb()
    assert np.array_equal(read_png(data), np.zeros((4, 4, 3), np.uint8))
    assert _max_rss_mb() - before < 32


# ---------------------------------------------------------------------------
# the server's request decode against JAX's
# ---------------------------------------------------------------------------

def _bodies(rng):
    img = _smooth(rng, 75, 97)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    bmp = io.BytesIO()
    Image.fromarray(img).save(bmp, "BMP")
    return {"jpeg": _jpeg(img, quality=92), "png": buf.getvalue(),
            "bmp": bmp.getvalue(),
            "gray_jpeg": _jpeg(np.asarray(Image.fromarray(img).convert("L")),
                               quality=90)}


@pytest.mark.parametrize("size", [64, 128])
def test_decode_to_matches_jax(size):
    for name, data in _bodies(np.random.default_rng(size)).items():
        got = tserve._decode_to(size, data)
        want = jserve._decode_to(size, data)
        assert got.shape == want.shape == (size, size, 3)
        assert got.dtype == np.float32
        err = np.abs(got - want)
        assert err.max() <= 2 / 255 and err.mean() <= 0.3 / 255, name


def test_decode_image_names_what_it_reads():
    """Bytes no reader takes (an SGI image, which PIL opens through a
    plugin the port does not have) name that plugin and the kinds that
    are read."""
    sgi = io.BytesIO()
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(sgi, "SGI")
    with pytest.raises(ValueError,
                       match="SGI.*GIF.*baseline JPEG.*TIFF.*TGA.*PCX.*QOI"
                             ".*WebP"):
        tpipe.decode_image(sgi.getvalue())
    with pytest.raises(ValueError, match="BMP"):
        tpipe.decode_image(b"BM" + bytes(60))


def test_library_needs_no_libjpeg():
    """The codec and the loader build from the port's sources alone: no
    -ljpeg on the command line, no libjpeg among the library's
    dependencies (the machine with the card has no jpeglib.h)."""
    assert not any("jpeg" in flag for flag in tnative.LIBS)
    assert tnative.native_available()
    deps = subprocess.run(["ldd", str(tnative.library_path())],
                          capture_output=True, text=True, timeout=60).stdout
    assert deps and "libjpeg" not in deps, deps


def test_png_reader_sub_and_up_rows():
    """A file whose rows use only None, Sub and Up (the reader's per-row
    route, which PIL's adaptive filtering rarely picks alone), written
    here, against PIL."""
    rgb = _smooth(np.random.default_rng(4), 23, 31)
    h, w, _ = rgb.shape
    px = rgb.astype(np.int64).reshape(h, w * 3)
    rows = []
    for r in range(h):
        kind = r % 3
        if kind == 1:
            left = np.concatenate([np.zeros(3, np.int64), px[r, :-3]])
            f = px[r] - left
        elif kind == 2:
            f = px[r] - (px[r - 1] if r else 0)
        else:
            f = px[r]
        rows.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
    assert np.array_equal(want, rgb)
    assert np.array_equal(read_png(data), want)
