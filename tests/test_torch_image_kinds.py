"""The port's readers on every JPEG, PNG and BMP kind that PIL reads, against
PIL's ``convert("RGB")`` and the JAX package's decode paths on the CPU.

JPEG: arithmetic-coded files (sequential and progressive), CMYK and YCCK
(with and without the Adobe marker), progressive files whose scans stop
early (libjpeg-turbo block-smooths them) and lossless (SOF3) files,
written here by the system's libjpeg (scripts/jpeg_fixture_writer.c), by
PIL, or by ``make_jpeg_fixtures.lossless_jpeg``; PNG at every depth and
colour type and Adam7 and BMP of every header, depth and compression, by
``make_image_fixtures`` (numpy and zlib). Inputs come from numpy seeds.
Bound everywhere: 0 values differ. The batch loader is held to the JAX
loader at one target per scale n/8: prescaled for arithmetic and smoothed
files, through the fallback (full-size decode, Pillow's BILINEAR) for the
kinds its libjpeg does not decode to RGB; ``_decode_resize`` and
``serve._decode_to`` to JAX's; the kinds PIL refuses stay refused, and a
bomb of each new kind is refused before anything of its size is
allocated. The trainer takes folders that hold every new kind.
"""

import io
import os
import resource
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mastermetastyletransfer_tpu import serve as jserve
from mastermetastyletransfer_tpu.data import native_loader as jnative
from mastermetastyletransfer_tpu.data import pipeline as jpipe
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch import serve as tserve
from mastermetastyletransfer_tpu_torch.data import native_loader as tnative
from mastermetastyletransfer_tpu_torch.data import pipeline as tpipe
from mastermetastyletransfer_tpu_torch.train import trainer
from mastermetastyletransfer_tpu_torch.utils.bmp import read_bmp
from mastermetastyletransfer_tpu_torch.utils.png import read_png
from scripts import make_image_fixtures as mif
from scripts import make_jpeg_fixtures as mjf
from tests.torch_threads import two_torch_threads  # noqa: F401

DATA = Path(__file__).resolve().parent / "data"
SUFFIX = {"jpeg_kinds": "jpg", "png": "png", "bmp": "bmp"}


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _pil_refuses(data: bytes) -> bool:
    try:
        _pil(data)
    except Exception:  # noqa: BLE001  (PIL's own kinds of refusal)
        return True
    return False


def _exact(got: np.ndarray, want: np.ndarray, label) -> None:
    assert got.shape == want.shape and got.dtype == np.uint8, label
    assert int(np.count_nonzero(got != want)) == 0, (
        label, int(np.abs(got.astype(int) - want).max()))


def _max_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


# ---------------------------------------------------------------------------
# the card's fixtures
# ---------------------------------------------------------------------------

def _fixture_names():
    return [(d, name) for d in SUFFIX
            for name in sorted(np.load(DATA / d / "pixels.npz").files)]


@pytest.mark.parametrize("kind,name", _fixture_names())
def test_fixture_decodes_to_its_stored_pixels(kind, name):
    """Each fixture of tests/data/{jpeg_kinds,png,bmp}: PIL decodes it to
    the stored pixels (what chip_smoke.py's codecs phase holds the port
    to), and so does the port's ``decode_image``."""
    data = (DATA / kind / f"{name}.{SUFFIX[kind]}").read_bytes()
    want = np.load(DATA / kind / "pixels.npz")[name]
    _exact(_pil(data), want, name)
    _exact(tpipe.decode_image(data), want, name)


def test_fixture_sets_are_whole_and_small():
    stored = {d: sorted(np.load(DATA / d / "pixels.npz").files)
              for d in SUFFIX}
    for d, names in stored.items():
        files = sorted(p.stem for p in (DATA / d).glob(f"*.{SUFFIX[d]}")
                       if not p.stem.startswith(("src_", "trainer_")))
        assert files == names, d
    assert len(stored["jpeg_kinds"]) == 10
    assert len(stored["png"]) == 13 and len(stored["bmp"]) == 10
    total = sum(p.stat().st_size for d in SUFFIX for p in (DATA / d).iterdir())
    assert total < 600_000


@pytest.mark.parametrize("name", sorted(mjf.trainer_files()))
def test_trainer_files_decode_as_pil(name):
    """chip_smoke.py's 640x480 CMYK and arithmetic-coded inputs (its
    trainer and http phases): the port decodes each to PIL's pixels, and
    the batch loader gives the JAX loader's batch at 512^2 and 256^2."""
    path = DATA / "jpeg_kinds" / f"{name}.jpg"
    data = path.read_bytes()
    _exact(tnative.decode_jpeg(data), _pil(data), name)
    assert _pil(data).shape == (480, 640, 3)
    for t in (512, 256):
        _exact(tnative.decode_resize_batch([str(path)], t)[0],
               jnative.decode_resize_batch([str(path)], t)[0], t)


@pytest.mark.parametrize("source", sorted(mjf.kind_sources()))
def test_kind_sources_are_the_jax_loaders_batches(source):
    """The loader's sources of the new kinds: the JAX loader gives the
    stored batch at each target (one per scale n/8), prescaled or through
    its fallback, and so does the port's loader."""
    stored = np.load(DATA / "jpeg_kinds" / "prescale.npz")
    path = DATA / "jpeg_kinds" / f"{source}.jpg"
    with Image.open(path) as im:
        w, h = im.size
    targets = mjf.prescale_targets(w, h)
    assert sorted(f"{source}_{t}" for t in targets) == sorted(
        k for k in stored.files if k.rsplit("_", 1)[0] == source)
    for t in targets:
        want = stored[f"{source}_{t}"]
        _exact(jnative.decode_resize_batch([str(path)], t)[0], want, t)
        _exact(tnative.decode_resize_batch([str(path)], t)[0], want, t)


# ---------------------------------------------------------------------------
# JPEG kinds against PIL, seeded
# ---------------------------------------------------------------------------

SAMPLINGS = ("1x1,1x1,1x1", "2x2,1x1,1x1", "2x1,1x1,1x1", "1x2,1x1,1x1",
             "2x2,1x2,2x1")


def _img(seed: int, h: int, w: int, noise: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if noise:
        return rng.integers(0, 256, (h, w, 3), np.uint8)
    return mjf.smooth(rng, h, w)


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("hw", [(48, 64), (37, 23), (3, 70)])
def test_arithmetic_jpeg_matches_pil(sampling, hw):
    """SOF9 and SOF10 (arithmetic coding), with and without restart
    intervals, conditioning tables left at their defaults."""
    img = _img(hw[0] * 7 + len(sampling), *hw)
    noise = _img(hw[1], *hw, noise=True)
    for label, data in (
            ("sequential", mjf.libjpeg_file(img, arith=True,
                                            sampling=sampling)),
            ("progressive", mjf.libjpeg_file(img, arith=True, scans="p",
                                             sampling=sampling)),
            ("noise restart", mjf.libjpeg_file(
                noise, arith=True, quality=95, sampling=sampling,
                restart=2)),
            ("progressive noise restart", mjf.libjpeg_file(
                noise, arith=True, scans="p", sampling=sampling,
                restart=3))):
        assert data[2:].count(b"\xff\xc9") + data[2:].count(b"\xff\xca")
        _exact(tnative.decode_jpeg(data), _pil(data), label)


def test_arithmetic_dac_conditioning_matches_pil():
    """A DAC segment (its L, U and K for every table the scans use) put in
    front of the frame: the file then decodes another way, PIL's way."""
    img = _img(3, 40, 56)
    data = mjf.libjpeg_file(img, arith=True, sampling="2x2,1x1,1x1")
    dac = b"\xff\xcc\x00\x0a" + bytes([0x00, 0x52, 0x01, 0x31, 0x10, 0x02,
                                       0x11, 0x09])
    i = data.index(b"\xff\xc9")
    body = data[:i] + dac + data[i:]
    want = _pil(body)
    _exact(tnative.decode_jpeg(body), want, "dac")


@pytest.mark.parametrize("space,adobe", [("cmyk", "-"), ("cmyk", "0"),
                                         ("ycck", "-")])
@pytest.mark.parametrize("sampling", ["1x1,1x1,1x1,1x1", "2x2,1x1,1x1,2x2",
                                      "2x1,1x2,1x1,1x1"])
def test_cmyk_and_ycck_jpeg_match_pil(space, adobe, sampling):
    """Four components: CMYK with libjpeg's Adobe marker or none, YCCK
    (Adobe transform 2); sequential, progressive and arithmetic-coded.
    PIL reads every one as inverted CMYK and converts with cmyk2rgb."""
    img = _img(len(sampling) + len(space), 37, 45)
    cmyk = np.dstack([img, _img(9, 37, 45, noise=True)[:, :, :1]])
    for scans, arith in (("-", False), ("p", False), ("-", True)):
        data = mjf.libjpeg_file(cmyk, space=space, adobe=adobe,
                                sampling=sampling, scans=scans, arith=arith)
        _exact(tnative.decode_jpeg(data), _pil(data), (scans, arith))


def test_pil_written_cmyk_round_trip():
    """PIL's own CMYK JPEG (Adobe marker, samples inverted): CMYK (10,
    200, 30, 40) at quality 95 reads back as (207, 46, 190) through
    both."""
    cmyk = np.broadcast_to(np.array([10, 200, 30, 40], np.uint8),
                           (16, 16, 4))
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(cmyk), "CMYK").save(
        buf, "JPEG", quality=95)
    data = buf.getvalue()
    got = tnative.decode_jpeg(data)
    _exact(got, _pil(data), "pil cmyk")
    assert tuple(got[8, 8]) == (207, 46, 190)


def _script(rng, nc: int) -> str:
    """A progressive scan script: DC (interleaved or per component, maybe
    with successive approximation), then each component's AC bands and
    refinements, then the DC refinements."""
    scans = []
    al_dc = int(rng.integers(0, 3))
    allc = "".join(map(str, range(nc)))
    if rng.random() < 0.5:
        scans.append(f"{allc}:0-0:0-{al_dc}")
    else:
        scans += [f"{c}:0-0:0-{al_dc}" for c in range(nc)]
    for c in rng.permutation(nc):
        al, cut = int(rng.integers(0, 3)), int(rng.integers(1, 20))
        scans += [f"{c}:1-{cut}:0-{al}", f"{c}:{cut + 1}-63:0-{al}"]
        scans += [f"{c}:1-63:{a}-{a - 1}" for a in range(al, 0, -1)]
    scans += [f"{allc}:0-0:{a}-{a - 1}" for a in range(al_dc, 0, -1)]
    return ";".join(scans)


@pytest.mark.parametrize("seed", range(12))
def test_progressive_scripts_stopped_early_match_pil(seed):
    """Scan scripts of every kind, Huffman or arithmetic-coded, grey,
    YCbCr or CMYK, cut after a random scan: where the coefficients 1-9 are
    left short of their last bit libjpeg-turbo block-smooths (with the DC
    too where no AC was coded), a component no scan reached is mid grey.
    Full size against PIL (libjpeg-turbo 3's edges)."""
    rng = np.random.default_rng(seed)
    for _ in range(4):
        h, w = int(rng.integers(1, 80)), int(rng.integers(1, 80))
        kind = str(rng.choice(["ycc", "ycc", "gray", "cmyk"]))
        img = _img(int(rng.integers(1 << 30)), h, w,
                   noise=rng.random() < 0.3)
        sampling = str(rng.choice(SAMPLINGS))
        if kind == "gray":
            px, space, nc, sampling = img[:, :, 0], "gray", 1, "-"
        elif kind == "ycc":
            px, space, nc = img, "ycbcr", 3
        else:
            px, space, nc = np.dstack([img, img[:, :, :1]]), "cmyk", 4
            sampling += ",1x1"
        data = mjf.libjpeg_file(
            px, space=space, quality=int(rng.choice([30, 75, 95])),
            sampling=sampling, arith=bool(rng.integers(0, 2)),
            restart=int(rng.choice([0, 0, 2])), scans=_script(rng, nc))
        k = int(rng.integers(0, len(mjf.scans_of(data))))
        cut = mjf.stop_after(data, k)
        _exact(tnative.decode_jpeg(cut), _pil(cut), (h, w, kind, k))


@pytest.mark.parametrize("sampling", ["1x1,1x1,1x1", "2x2,1x1,1x1",
                                      "1x2,1x1,1x1", "2x1,1x1,1x1"])
@pytest.mark.parametrize("arith", [False, True], ids=["huffman", "arith"])
def test_smoothed_decode_at_every_scale_matches_jax_loader(sampling, arith):
    """libjpeg-turbo's n/8 decode of a file it smooths, as the JAX loader's
    libjpeg (2.1: its own edges) gives it: the loader's batch at one
    target per scale n/8, after each scan of the progression, bit for bit
    with JAX's; the full-size decode (PIL's libjpeg-turbo 3) with PIL."""
    img = _img(len(sampling) * 3 + arith, 80, 104)
    data = mjf.libjpeg_file(img, sampling=sampling, scans="p", arith=arith,
                            quality=75)
    targets = mjf.prescale_targets(104, 80)
    for k in range(0, len(mjf.scans_of(data)) - 1, 2):
        cut = mjf.stop_after(data, k)
        _exact(tnative.decode_jpeg(cut), _pil(cut), k)
        _loader_matches_jax(cut, targets, (sampling, k))


def _loader_matches_jax(data: bytes, targets, label, tmp=None) -> None:
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.jpg")
        with open(path, "wb") as f:
            f.write(data)
        for t in targets:
            _exact(tnative.decode_resize_batch([path], t)[0],
                   jnative.decode_resize_batch([path], t)[0], (label, t))


@pytest.mark.parametrize("case", ["arith", "arith_progressive", "cmyk",
                                  "ycck", "lossless"])
def test_loader_takes_the_jax_loaders_route(case):
    """Arithmetic-coded files are prescaled as the JAX loader's libjpeg
    prescales them; CMYK, YCCK and lossless ones, which it does not decode
    to RGB, take its fallback (full-size decode, Pillow's BILINEAR): the
    port's batches equal JAX's at one target per n/8."""
    img = _img(len(case), 72, 88)
    cmyk = mjf.cmyk_of(img)
    data = {
        "arith": lambda: mjf.libjpeg_file(img, arith=True,
                                          sampling="2x2,1x1,1x1"),
        "arith_progressive": lambda: mjf.libjpeg_file(
            img, arith=True, scans="p", sampling="2x1,1x1,1x1", restart=2),
        "cmyk": lambda: mjf.pil_cmyk_jpeg(img, quality=90),
        "ycck": lambda: mjf.libjpeg_file(cmyk, space="ycck",
                                         sampling="2x2,1x1,1x1,2x2"),
        "lossless": lambda: mjf.lossless_jpeg(list(np.moveaxis(img, 2, 0)),
                                              [(1, 1)] * 3, psv=5),
    }[case]()
    _loader_matches_jax(data, mjf.prescale_targets(88, 72), case)


@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_jpeg_matches_pil(psv):
    """SOF3: each predictor, point transforms 0 and 2, restarts every 2
    rows, grey and RGB, one interleaved scan or one scan per component,
    4:2:0, 4:2:2 and 4:4:0 sampling (box upsampling), odd sizes."""
    img = _img(psv, 21, 30)
    grey = img[:, :, 0]
    planes = list(np.moveaxis(img, 2, 0))
    for label, data in (
            ("grey", mjf.lossless_jpeg([grey], [(1, 1)], psv)),
            ("grey pt2 restart", mjf.lossless_jpeg(
                [grey], [(1, 1)], psv, pt=2, restart_rows=2)),
            ("rgb ids R,G,B", mjf.lossless_jpeg(planes, [(1, 1)] * 3, psv,
                                               ids=[82, 71, 66])),
            ("rgb per component", mjf.lossless_jpeg(
                planes, [(1, 1)] * 3, psv, pt=1, interleave=False,
                restart_rows=3))):
        _exact(tnative.decode_jpeg(data), _pil(data), label)
    for h, v in ((2, 2), (2, 1), (1, 2)):
        sub = [img[:, :, 0], img[::v, ::h, 1], img[::v, ::h, 2]]
        for inter in (True, False):
            data = mjf.lossless_jpeg(sub, [(h, v), (1, 1), (1, 1)], psv,
                                     interleave=inter,
                                     restart_rows=2 if inter else 0)
            _exact(tnative.decode_jpeg(data), _pil(data), (h, v, inter))


def test_jpeg_kinds_pil_refuses_stay_refused():
    """Hierarchical, 12-bit, lossless arithmetic-coded, 2-component,
    DNL frames, lossless YCbCr (libjpeg converts no colour of a lossless
    frame), truncated and corrupt files: PIL refuses each, and the port
    raises naming it."""
    img = _img(4, 24, 32)
    base = mjf.libjpeg_file(img)
    arith = mjf.libjpeg_file(img, arith=True)
    lossless = mjf.lossless_jpeg(list(np.moveaxis(img, 2, 0)),
                                 [(1, 1)] * 3, 1)
    i = lossless.index(b"\xff\xc3")
    jfif = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    j = base.index(b"\xff\xc0")
    two = base[:j + 9] + b"\x02" + base[j + 10:]
    cases = {
        "hierarchical JPEG": base.replace(b"\xff\xc0", b"\xff\xc5", 1),
        "12-bit JPEG": base[:j + 4] + b"\x0c" + base[j + 5:],
        "arithmetic-coded lossless": lossless.replace(b"\xff\xc3",
                                                      b"\xff\xcb", 1),
        "2-component": two,
        "DNL": base[:j + 5] + b"\x00\x00" + base[j + 7:],
        "lossless JPEG in YCbCr": lossless[:i] + jfif + lossless[i:],
        "truncated": arith[:len(arith) * 2 // 3],
        "not a JPEG": b"\xff\xd8\xff\xd9",
    }
    for why, data in cases.items():
        assert _pil_refuses(data), why
        with pytest.raises(ValueError, match="JPEG"):
            tnative.decode_jpeg(data)
    with pytest.raises(ValueError, match="hierarchical JPEG \\(SOF5\\)"):
        tnative.decode_jpeg(cases["hierarchical JPEG"])
    with pytest.raises(ValueError, match="YCbCr"):
        tnative.decode_jpeg(cases["lossless JPEG in YCbCr"])


def _with_size(data: bytes, sof: bytes, h: int, w: int) -> bytes:
    i = data.index(sof)
    return data[:i + 5] + struct.pack(">HH", h, w) + data[i + 9:]


@pytest.mark.parametrize("case", ["arith", "arith_progressive", "cmyk",
                                  "lossless_bytes", "lossless_limit"])
def test_new_jpeg_kinds_refuse_bombs_before_allocating(case):
    """A small body claiming what no request may make the decoder
    allocate: arithmetic frames above the pixel limit (their bytes bound
    no frame: a decision can take far less than a bit), a progressive
    CMYK frame its bytes could not code, a lossless frame its bytes could
    not code (a sample takes a bit at the least) and one above the
    limit."""
    img = _img(5, 16, 16)
    cmyk = np.dstack([img, img[:, :, :1]])
    data, why = {
        "arith": (_with_size(mjf.libjpeg_file(img, arith=True), b"\xff\xc9",
                             65535, 65535), "decompression bomb"),
        "arith_progressive": (_with_size(mjf.libjpeg_file(
            img, arith=True, scans="p"), b"\xff\xca", 20000, 10000),
            "decompression bomb"),
        "cmyk": (_with_size(mjf.libjpeg_file(cmyk, space="cmyk", scans="p"),
                            b"\xff\xc2", 9000, 9000), "cannot hold"),
        "lossless_bytes": (_with_size(mjf.lossless_jpeg(
            [img[:, :, 0]], [(1, 1)]), b"\xff\xc3", 4000, 4000),
            "cannot hold"),
        "lossless_limit": (_with_size(mjf.lossless_jpeg(
            [img[:, :, 0]], [(1, 1)]), b"\xff\xc3", 65535, 65535),
            "decompression bomb"),
    }[case]
    tnative.decode_jpeg(mjf.libjpeg_file(img))
    before = _max_rss_mb()
    with pytest.raises(ValueError, match=why):
        tnative.decode_jpeg(data)
    assert _max_rss_mb() - before < 64


def test_progressive_cmyk_coefficient_buffer_bound():
    """A progressive CMYK frame under the pixel limit (65535 x 2730) whose
    four components' coefficients, in whole blocks, would be above four
    times it, with enough bytes before the frame to pass the byte bound,
    is refused before its buffer is allocated."""
    img = _img(6, 16, 16)
    data = mjf.libjpeg_file(np.dstack([img, img[:, :, :1]]), space="cmyk",
                            scans="p")
    data = _with_size(data, b"\xff\xc2", 2730, 65535)
    com = b"\xff\xfe" + struct.pack(">H", 65535) + bytes(65533)
    data = data[:2] + com * 23 + data[2:]
    assert 65535 * 2730 <= 2 * 89478485 < 65536 * 2736
    before = _max_rss_mb()
    with pytest.raises(ValueError, match="coefficient buffer"):
        tnative.decode_jpeg(data)
    assert _max_rss_mb() - before < 64


# ---------------------------------------------------------------------------
# PNG and BMP kinds against PIL, seeded
# ---------------------------------------------------------------------------

PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
             (6, 16)]


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_png_kind_matches_pil(ctype, depth, interlace):
    """Every colour type at every depth PIL reads, non-interlaced and
    Adam7, rows under all five filters, sizes from 1 to 39 (Adam7's empty
    passes too), a palette shorter than the indices reach."""
    rng = np.random.default_rng(ctype * 100 + depth + interlace)
    for h, w in ((1, 1), (3, 2), (9, 13), (39, 27)):
        samples = rng.integers(0, 1 << depth, (h, w, mif._CHANNELS[ctype]))
        palette = None
        if ctype == 3:
            n = int(rng.integers(1, (1 << depth) + 1))
            palette = rng.integers(0, 256, 3 * n, np.uint8).tobytes()
        data = mif.png_file(samples, depth, ctype, palette=palette,
                            interlace=interlace, seed=h * w)
        _exact(read_png(data), _pil(data), (h, w))


def test_png_kinds_pil_refuses_stay_refused():
    """A depth a colour type does not take (16-bit palette, 3-bit grey,
    4-bit RGB), a filter method other than 0, truncated image data: PIL
    refuses each, and so does the port."""
    s = np.zeros((4, 4, 1), np.uint8)
    good = mif.png_file(s, 8, 0)
    ihdr = good.index(b"IHDR")

    def with_ihdr(depth, ctype, filt=0):
        body = struct.pack(">IIBBBBB", 4, 4, depth, ctype, 0, filt, 0)
        return (good[:ihdr - 4] + mif._chunk(b"IHDR", body)
                + good[ihdr + 21:])

    for data in (with_ihdr(16, 3), with_ihdr(3, 0), with_ihdr(4, 2),
                 with_ihdr(8, 0, filt=1),
                 mif.png_file(np.zeros((40, 40, 3), np.uint8), 8, 2)[:-40]):
        assert _pil_refuses(data)
        with pytest.raises(ValueError, match="PNG"):
            read_png(data)


def test_adam7_png_bomb_refused_before_inflating():
    """An Adam7 header claiming 65535 x 65535 16-bit RGBA pixels is refused
    before its passes are sized or inflated."""
    data = bytearray(mif.png_file(np.zeros((2, 2, 4), np.uint16), 16, 6,
                                  interlace=True))
    ihdr = data.index(b"IHDR")
    data[ihdr + 4:ihdr + 12] = struct.pack(">II", 65535, 65535)
    data[ihdr + 17:ihdr + 21] = struct.pack(
        ">I", __import__("zlib").crc32(bytes(data[ihdr:ihdr + 17]))
        & 0xFFFFFFFF)
    before = _max_rss_mb()
    with pytest.raises(ValueError, match="decompression bomb"):
        read_png(bytes(data))
    assert _max_rss_mb() - before < 32


def _bmp_case(rng, kind: str, h: int, w: int, header: int, top: bool):
    pal = mif._palette
    if kind.startswith("palette"):
        bits = int(kind[7:])
        n = int(rng.integers(1, (1 << bits) + 1))
        idx = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
        return mif.bmp_file(mif.bmp_rows(idx, bits, top), w, h, bits,
                            header=header, palette=pal(rng, n),
                            colors=n if rng.random() < 0.5 else 0,
                            top_down=top)
    if kind == "grey_ramp":
        idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
        ramp = b"".join(bytes([i, i, i, 0]) for i in range(256))
        return mif.bmp_file(mif.bmp_rows(idx, 8, top), w, h, 8,
                            header=header, palette=ramp, top_down=top)
    if kind == "black_white_8bit":
        idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
        return mif.bmp_file(mif.bmp_rows(idx, 8), w, h, 8, colors=2,
                            palette=bytes([0, 0, 0, 0, 255, 255, 255, 0]))
    if kind in ("rle8", "rle4"):
        bits = 8 if kind == "rle8" else 4
        idx = rng.integers(0, 6 if bits == 8 else 16, (h, w)).astype(
            np.uint8)
        body = mif.rle8(idx) if bits == 8 else mif.rle4(idx)
        return mif.bmp_file(body, w, h, bits, compression=1 if bits == 8
                            else 2, palette=pal(rng, 1 << bits),
                            header=header)
    if kind == "rle_escapes":
        # deltas, absolute runs (odd lengths), early ends of line, runs
        # past a row's end: Pillow's decoder, quirks and all
        body = bytes([3, 7, 0, 2, 9, 9, 1, 1, 0, 3, 1, 2, 3, 0, 0, 0,
                      50, 4, 0, 5, 1, 2, 3, 4, 5, 0]) + bytes([w, 2, 0, 0]) \
            * h + b"\0\1"
        return mif.bmp_file(body, w, h, 8, compression=1,
                            palette=pal(rng, 256), header=header)
    if kind in ("rgb555", "bitfields565"):
        v = rng.integers(0, 65536, (h, w)).astype("<u2").view(
            np.uint8).reshape(h, -1)
        masks = None if kind == "rgb555" else (0xF800, 0x7E0, 0x1F)
        return mif.bmp_file(mif.bmp_rows(v, 8, top), w, h, 16,
                            compression=3 if masks else 0, masks=masks,
                            header=header, top_down=top)
    if kind == "bgr24":
        v = rng.integers(0, 256, (h, 3 * w)).astype(np.uint8)
        return mif.bmp_file(mif.bmp_rows(v, 8, top), w, h, 24,
                            header=header, top_down=top)
    masks = [(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0),
             (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00,
                                             0xFF),
             (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
             (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
             (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)]
    v = rng.integers(0, 256, (h, 4 * w)).astype(np.uint8)
    return mif.bmp_file(mif.bmp_rows(v, 8, top), w, h, 32, header=124,
                        compression=3, top_down=top,
                        masks=masks[int(rng.integers(0, len(masks)))])


BMP_KINDS = ["palette1", "palette4", "palette8", "grey_ramp",
             "black_white_8bit", "rle8", "rle4", "rle_escapes", "rgb555",
             "bitfields565", "bgr24", "bitfields32"]


@pytest.mark.parametrize("kind", BMP_KINDS)
def test_bmp_kind_matches_pil(kind):
    """Every BMP kind Pillow reads, over headers (core for palettes, INFO,
    V2, V3, OS/2 2.x, V4, V5), bottom-up and top-down rows, sizes from 1
    to 30."""
    rng = np.random.default_rng(len(kind) * 31)
    for i in range(8):
        h, w = int(rng.integers(1, 31)), int(rng.integers(1, 31))
        header = int(rng.choice([40, 52, 56, 64, 108, 124]))
        data = _bmp_case(rng, kind, h, w, header, bool(i % 2))
        _exact(read_bmp(data), _pil(data), (kind, h, w, header))
    if kind == "palette8":
        idx = rng.integers(0, 256, (5, 7)).astype(np.uint8)
        core = mif.bmp_file(mif.bmp_rows(idx, 8), 7, 5, 8, header=12,
                            palette=mif._palette(rng, 256, False))
        _exact(read_bmp(core), _pil(core), "core")


def test_bmp_kinds_pil_refuses_stay_refused():
    """2-bit pixels, bit fields Pillow does not take, JPEG inside, an RLE
    bitmap ending before its last pixel or of a black and white palette,
    a truncated file, an unknown header: PIL refuses each, and so does the
    port."""
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 4, (4, 4)).astype(np.uint8)
    ramp = b"".join(bytes([i, i, i, 0]) for i in range(256))
    bw = bytes([0, 0, 0, 0, 255, 255, 255, 0])
    v = rng.integers(0, 256, (4, 8)).astype(np.uint8)
    cases = [
        mif.bmp_file(mif.bmp_rows(idx, 2), 4, 4, 2,
                     palette=mif._palette(rng, 4)),
        mif.bmp_file(mif.bmp_rows(v, 8), 4, 4, 16, compression=3,
                     masks=(0xF00, 0xF0, 0xF)),
        mif.bmp_file(b"\xff\xd8\xff\xd9", 4, 4, 24, compression=4),
        mif.bmp_file(bytes([4, 7, 0, 0, 0, 1]), 4, 3, 8, compression=1,
                     palette=ramp),
        mif.bmp_file(bytes([4, 1, 0, 0] * 3 + [0, 1]), 4, 3, 8,
                     compression=1, palette=bw, colors=2),
        mif.bmp_file(bytes(10), 4, 4, 24),
        b"BM" + bytes(12) + struct.pack("<I", 20) + bytes(40),
    ]
    for data in cases:
        assert _pil_refuses(data)
        with pytest.raises(ValueError, match="BMP"):
            read_bmp(data)


@pytest.mark.parametrize("kind", ["raw", "rle8"])
def test_bmp_bomb_refused_before_allocating(kind):
    """A header claiming 60,000^2 pixels, raw or RLE8 (whose few bytes
    could otherwise fill any image), is refused before its pixels are
    allocated."""
    data = mif.bmp_file(bytes([2, 1, 0, 0, 0, 1]) if kind == "rle8"
                        else bytes(64), 60000, 60000, 8,
                        compression=1 if kind == "rle8" else 0,
                        palette=mif._palette(np.random.default_rng(1), 256))
    before = _max_rss_mb()
    with pytest.raises(ValueError, match="decompression bomb"):
        read_bmp(data)
    assert _max_rss_mb() - before < 32


# ---------------------------------------------------------------------------
# the JAX package's decode paths, on folders of every new kind
# ---------------------------------------------------------------------------

def _kind_bodies(seed: int) -> dict:
    """One file of each new kind, seeded, of a few tens of pixels a side."""
    rng = np.random.default_rng(seed)
    img = mjf.smooth(rng, 45, 61)
    grey = img[:, :, 0]
    return {
        "arith.jpg": mjf.libjpeg_file(img, arith=True,
                                      sampling="2x2,1x1,1x1"),
        "arith_progressive.jpg": mjf.libjpeg_file(img, arith=True,
                                                  scans="p"),
        "cmyk.jpg": mjf.pil_cmyk_jpeg(img, quality=90),
        "ycck.jpg": mjf.libjpeg_file(mjf.cmyk_of(img), space="ycck"),
        "smoothed.jpg": mjf.stop_after(mjf.jpeg(img, progressive=True), 1),
        "lossless.jpg": mjf.lossless_jpeg(list(np.moveaxis(img, 2, 0)),
                                          [(1, 1)] * 3, psv=7),
        "adam7.png": mif.png_file(img, 8, 2, interlace=True),
        "grey16.png": mif.png_file(grey.astype(np.uint16) * 300, 16, 0),
        "palette4.png": mif.png_file(grey >> 4, 4, 3,
                                     palette=mif._palette(rng, 16, False)),
        "palette8.bmp": mif.bmp_file(mif.bmp_rows(grey, 8), 61, 45, 8,
                                     palette=mif._palette(rng, 256)),
        "rle4.bmp": mif.bmp_file(mif.rle4(grey >> 4), 61, 45, 4,
                                 compression=2,
                                 palette=mif._palette(rng, 16)),
        "rgb555.bmp": mif.bmp_file(mif.bmp_rows(
            (grey.astype(np.uint16) * 129).astype("<u2").view(np.uint8)
            .reshape(45, -1), 8), 61, 45, 16),
    }


def _write_folder(root: str, bodies: dict) -> str:
    os.makedirs(root)
    for name, data in bodies.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(data)
    return root


def test_decode_resize_and_decode_to_match_jax(tmp_path):
    """Every new kind through ``_decode_resize`` and ``serve._decode_to``
    at two sizes against JAX's (PIL's decode and resize): 0 values
    differ."""
    folder = _write_folder(str(tmp_path / "k"), _kind_bodies(1))
    for name in sorted(os.listdir(folder)):
        path = os.path.join(folder, name)
        data = Path(path).read_bytes()
        for size in (40, 96):
            _exact(tpipe._decode_resize(path, size),
                   jpipe._decode_resize(path, size), (name, size))
            got, want = tserve._decode_to(size, data), \
                jserve._decode_to(size, data)
            assert got.dtype == want.dtype == np.float32
            assert np.array_equal(got, want), (name, size)


def test_loaders_batches_match_jax_on_every_kind(tmp_path):
    """The dataset's batch of a folder holding every new kind (the native
    loader with its fallback) and the prefetching loader's stream over it,
    against JAX's, 0 values differing."""
    folder = _write_folder(str(tmp_path / "k"), _kind_bodies(2))
    n = len(os.listdir(folder))
    got = tpipe.ImageFolderDataset(folder, 72).get_batch(range(n))
    want = jpipe.ImageFolderDataset(folder, 72).get_batch(range(n))
    _exact(got, want, "batch")
    loaders = [pkg.PrefetchLoader(pkg.ImageFolderDataset(folder, 48),
                                  batch_size=4, num_workers=2, seed=3)
               for pkg in (tpipe, jpipe)]
    try:
        for _ in range(4):
            _exact(next(loaders[0]), next(loaders[1]), "stream")
    finally:
        for loader in loaders:
            loader.close()


def test_trainer_trains_on_folders_of_every_kind(tmp_path):
    """The trainer (plain, 2 iterations, 64^2 crops from 80^2 staging,
    batch 2, on the CPU) on a content folder holding every new kind and a
    style folder of a few: finite metrics, one JSONL line an iteration."""
    bodies = _kind_bodies(3)
    cdir = _write_folder(str(tmp_path / "c"), bodies)
    sdir = _write_folder(str(tmp_path / "s"), {
        k: v for k, v in _kind_bodies(4).items()
        if k in ("cmyk.jpg", "adam7.png", "palette8.bmp", "arith.jpg")})
    cfg = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(),
        data=tcfg.DataConfig(content_dir=cdir, style_dir=sdir,
                             batch_size_content=2, resize_to=80, crop_to=64,
                             num_workers=2, seed=0),
        train=tcfg.TrainConfig(max_iterations=2, max_layers=1,
                               save_every=1000, save_every_for_model=1000,
                               seed=0))
    exp = str(tmp_path / "exp")
    metrics = trainer.train(cfg, exp_dir=exp, log_every=1, device="cpu")
    assert all(np.isfinite(v) for v in metrics.values())
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 2
