"""libjpeg's recovery of cut and damaged JPEG data in the port's decoder
(``native/jpeg.cpp``), on the CPU, against the two references the port
follows:

* the batch loader (``data.native_loader.decode_resize_batch``) against
  the JAX package's, which decodes with the system's libjpeg-turbo 2.1.5
  through ``jpeg_stdio_src`` (past a file's end a fake EOI, so a cut file
  is read, the blocks past the cut grey or as earlier scans left them)
  and falls back to PIL where libjpeg fails;
* ``decode_image`` against PIL (Pillow 12.1, libjpeg-turbo 3.1.3), whose
  data source suspends: ``ImageFile.load`` hands the file over in 64 KiB
  reads and refuses a file whose data ends before libjpeg has output every
  row ("image file is truncated").

The fixtures (tests/data/jpeg_damaged/, written by
``scripts/make_image_format_fixtures.write_jpeg_damaged``) carry both
references' digests: PIL's pixels, and the JAX loader's staged image at
one target for each scale n/8, n = 1..8; 0 values may differ. Where the
JAX loader's library loads, and PIL is here, the tests also compare live;
seeded sweeps of damaged files (Huffman sequential and progressive,
arithmetic-coded, multi-scan, lossless; cuts, flips, restart markers
renumbered or dropped, stray markers) hold the port to libjpeg's raw n/8
pixels (scripts/jpeg_recovery_oracle.py) and to PIL.
"""

import argparse
import hashlib
import io
import json
import os
import struct
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mastermetastyletransfer_tpu.config import DataConfig as JDataConfig
from mastermetastyletransfer_tpu.data import native_loader as jnative
from mastermetastyletransfer_tpu.data import pipeline as jpipe
from mastermetastyletransfer_tpu_torch.config import DataConfig
from mastermetastyletransfer_tpu_torch.data import native_loader as tnative
from mastermetastyletransfer_tpu_torch.data import pipeline as tpipe
from scripts import fuzz_image_formats as fuzz
from scripts import jpeg_recovery_oracle as oracle
from scripts import make_image_format_fixtures as fx
from scripts import make_jpeg_fixtures as mjf
from tests.torch_threads import one_torch_thread  # noqa: F401

DAMAGED = Path(__file__).resolve().parent / "data" / "jpeg_damaged"
with open(DAMAGED / "digests.json") as f:
    DIGESTS = json.load(f)
SMALL = sorted(n for n in DIGESTS if not n.startswith("trainer_"))


def _read(name: str) -> bytes:
    return (DAMAGED / f"{name}.jpg").read_bytes()


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _pil(data: bytes):
    """PIL's pixels of the bytes, or None where it refuses them."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(io.BytesIO(data)) as im:
                return np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 - any refusal of PIL's
        return None


def _port(data: bytes):
    try:
        return tpipe.decode_image(data)
    except ValueError:
        return None


def _same(want, got) -> bool:
    if want is None or got is None:
        return want is None and got is None
    return want.shape == got.shape and np.array_equal(want, got)


def test_damaged_fixtures_are_the_generators():
    """The stored files are what write_jpeg_damaged makes from its seed
    (PIL's writer, the system's libjpeg for the arithmetic-coded ones)."""
    made = fx.jpeg_damaged_fixtures()
    assert sorted(made) == sorted(DIGESTS)
    for name, data in made.items():
        assert data == _read(name), name


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_damaged_fixture_decodes_as_pil(name):
    """decode_image's verdict and pixels are PIL's stored ones (and PIL
    still gives them)."""
    data, want = _read(name), DIGESTS[name]["pil"]
    got = _port(data)
    if want is None:
        assert got is None, name
        with pytest.raises(ValueError, match="JPEG"):
            tpipe.decode_image(data)
    else:
        assert got is not None and list(got.shape) == want["shape"]
        assert _sha(got) == want["sha256"], name
    live = _pil(data)
    assert (live is None) == (want is None)
    if live is not None:
        assert _sha(live) == want["sha256"]


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_damaged_fixture_loads_as_the_jax_loader(name):
    """The batch loader's staged image at each target (each scale n/8) is
    the JAX loader's stored one, or raises where it raises; live too."""
    path = str(DAMAGED / f"{name}.jpg")
    for target, want in DIGESTS[name]["loader"].items():
        try:
            got = _sha(tnative.decode_resize_batch([path], int(target))[0])
        except ValueError as e:
            assert str(path) in str(e)
            got = None
        assert got == want, (name, target)
        if jnative.native_available():
            try:
                live = _sha(jnative.decode_resize_batch([path],
                                                        int(target))[0])
            except Exception:  # noqa: BLE001 - PIL's refusal, any kind
                live = None
            assert live == want, (name, target)


@pytest.mark.parametrize("name", SMALL)
def test_damaged_fixture_scaled_decode_is_libjpegs(name):
    """Before any resize: the port's n/8 decode against libjpeg-turbo
    2.1.5's raw pixels (jpeg_stdio_src, scale_num n), n = 1..8, the same
    verdict and 0 values differing."""
    data = _read(name)
    for n in range(1, 9):
        row = oracle.compare(data, n)
        assert (row["libjpeg"] == "decodes") == (row["port"] == "decodes"), \
            (name, row)
        assert row.get("values_differing", 0) == 0 and "shapes" not in row, \
            (name, row)


def test_cut_files_in_the_training_folder_match_jax(tmp_path):
    """make_train_iterators over a content folder holding a cut JPEG with
    restart markers and a cut progressive one (both refused by PIL, read
    by JAX's libjpeg) yields JAX's batches: training goes on."""
    cdir, sdir = tmp_path / "c", tmp_path / "s"
    cdir.mkdir()
    sdir.mkdir()
    rng = np.random.default_rng(41)
    for i in range(3):
        img = fx.smooth(rng, 60 + 7 * i, 80)
        Image.fromarray(img).save(cdir / f"{i}.jpg", quality=90)
        Image.fromarray(img[::-1]).save(sdir / f"{i}.jpg", quality=90)
    for name in ("trainer_cut_restart", "trainer_cut_progressive"):
        assert DIGESTS[name]["pil"] is None
        (cdir / f"{name}.jpg").write_bytes(_read(name))
    fields = dict(content_dir=str(cdir), style_dir=str(sdir),
                  batch_size_content=5, batch_size_style=2, resize_to=48,
                  num_workers=2, seed=4)
    got = tpipe.make_train_iterators(DataConfig(**fields))
    want = jpipe.make_train_iterators(JDataConfig(**fields))
    try:
        assert len(got[0].dataset) == 5
        for g, w in zip(got, want):
            for _ in range(3):
                a, b = next(g), next(w)
                assert a.shape == b.shape and np.array_equal(a, b)
    finally:
        for loader in (*got, *want):
            loader.close()


def _restart_file() -> bytes:
    return fx._pil_jpeg(fx.smooth(np.random.default_rng(42), 64, 88),
                        quality=85, subsampling=2, restart_marker_blocks=3)


@pytest.mark.parametrize("step", range(1, 8))
def test_restart_marker_renumbered(step):
    """An RSTn renumbered by `step` (jpeg_resync_to_restart: the next two
    are left for the data to come, the two before passed over for the next
    marker, the others taken for the one expected): the loader's n/8
    decode is libjpeg's at every n, decode_image PIL's."""
    data = _restart_file()
    rsts = [i for i, m in fx._markers(data) if 0xD0 <= m <= 0xD7]
    for k in (rsts[1], rsts[len(rsts) // 2]):
        b = bytearray(data)
        b[k + 1] = 0xD0 + ((b[k + 1] - 0xD0 + step) & 7)
        b = bytes(b)
        assert _same(_pil(b), _port(b)), (step, k)
        for n in (1, 2, 4, 8):
            row = oracle.compare(b, n)
            assert row["libjpeg"] == row["port"] == "decodes", row
            assert row["values_differing"] == 0, (step, k, row)


def _big_sequential(restart: bool) -> bytes:
    img = fx.smooth(np.random.default_rng(43), 400, 420, noise=60)
    kw = {"restart_marker_rows": 2} if restart else {}
    data = fx._pil_jpeg(img, quality=95, subsampling=0, **kw)
    assert len(data) > 2 * 65536
    return data


@pytest.mark.parametrize("restart", [False, True])
def test_pil_verdicts_on_files_cut_near_their_end(restart):
    """A file over 64 KiB cut 1 to 40 bytes before its end: PIL reads it
    only where libjpeg's reading ahead (jdhuff.c's fill to 57 bits, its
    fast path 6 bytes at a time where 512 bytes a block are left of the
    read so far) did not run past the data before the last MCU was out;
    the port's verdicts and pixels are PIL's at every cut, the loader's
    libjpeg's."""
    data = _big_sequential(restart)
    verdicts = set()
    for cut in range(1, 41):
        body = data[:len(data) - cut]
        want = _pil(body)
        verdicts.add(want is not None)
        assert _same(want, _port(body)), cut
    assert verdicts == ({True, False} if restart else {False})
    row = oracle.compare(data[:len(data) - 7], 4)
    assert row["values_differing"] == 0


def test_arithmetic_data_across_pils_64k_read():
    """libjpeg's arithmetic decoder cannot suspend: PIL refuses an
    arithmetic-coded file whose scan data crosses ImageFile.load's first
    64 KiB read (a COM segment before the frame moves it there), and
    reads it where the data is inside a read; the port gives both
    verdicts, and its loader reads every one (jpeg_stdio_src)."""
    rng = np.random.default_rng(44)
    data = mjf.libjpeg_file(rng.integers(0, 256, (40, 48, 3), np.uint8),
                            arith=True)

    def padded(total: int) -> bytes:
        pad, coms = total - len(data), b""
        while pad:
            n = min(pad, 40000)
            coms += b"\xff\xfe" + struct.pack(">H", n - 2) + bytes(n - 4)
            pad -= n
        return data[:2] + coms + data[2:]

    for total, read in ((65536, True), (65537, False),
                        (65536 + len(data) // 2, False),
                        (65536 + len(data) + 8, True)):
        body = padded(total)
        assert (_pil(body) is not None) == read, total
        assert _same(_pil(body), _port(body)), total
        row = oracle.compare(body, 8)
        assert row["port"] == "decodes" and row["values_differing"] == 0


def _sweep_source(kind: str, rng) -> bytes:
    img = fx.smooth(rng, int(rng.integers(16, 90)), int(rng.integers(16, 90)))
    restart = int(rng.choice([0, 1, 3]))
    if kind == "sequential":
        kw = {"restart_marker_blocks": restart} if restart else {}
        return fx._pil_jpeg(img, quality=int(rng.choice([50, 90])),
                            subsampling=int(rng.integers(0, 3)), **kw)
    if kind == "progressive":
        kw = {"restart_marker_rows": 1} if restart else {}
        return fx._pil_jpeg(img, quality=90, progressive=True,
                            subsampling=int(rng.integers(0, 3)), **kw)
    if kind == "multi_scan":
        return mjf.libjpeg_file(img, restart=restart, sampling="1x1,1x1,1x1",
                                scans="0:0-63:0-0;12:0-63:0-0")
    if kind == "lossless":
        return mjf.lossless_jpeg([img[..., 0]], [(1, 1)],
                                 int(rng.integers(1, 8)),
                                 restart_rows=int(rng.choice([0, 1, 2])))
    return mjf.libjpeg_file(img, arith=True, restart=restart,
                            scans="p" if kind == "arith_progressive" else "-")


def _damaged(data: bytes, rng) -> bytes:
    start = data.index(b"\xff\xda") + 10
    pick = rng.random()
    if pick < 0.3:
        return data[:int(rng.integers(start - 8, len(data)))]
    if pick < 0.6:
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 5))):
            b[int(rng.integers(start, len(b)))] ^= int(rng.integers(1, 256))
        return bytes(b)
    if pick < 0.8:
        rsts = [i for i, m in fx._markers(data) if 0xD0 <= m <= 0xD7]
        if rsts:
            k = rsts[int(rng.integers(0, len(rsts)))]
            return data[:k] + data[k + 2:]
    at = int(rng.integers(start, len(data)))
    code = int(rng.choice([0xD9, 0xD4, 0x01, 0xC4, 0xE1, 0xDA]))
    return data[:at] + bytes([0xFF, code]) + data[at:]


@pytest.mark.parametrize("kind", ["sequential", "progressive", "multi_scan",
                                  "arith", "arith_progressive", "lossless"])
def test_seeded_damage_sweep(kind):
    """30 seeded damaged files of each kind: decode_image's verdicts and
    pixels are PIL's, the loader's n/8 decode libjpeg's (lossless files,
    which the JAX loader's libjpeg does not read, go to PIL alone)."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    for i in range(30):
        body = _damaged(_sweep_source(kind, rng), rng)
        assert _same(_pil(body), _port(body)), (kind, i)
        if kind != "lossless":
            row = oracle.compare(body, int(rng.integers(1, 9)))
            assert (row["libjpeg"] == "decodes") == \
                (row["port"] == "decodes"), (kind, i, row)
            assert row.get("values_differing", 0) == 0, (kind, i, row)


def test_loader_fuzz_reports_no_difference():
    """scripts/fuzz_image_formats.py --kind loader on 40 files: the port's
    batch loader against the JAX package's, 0 differing."""
    if not jnative.native_available():
        pytest.skip("the JAX loader's library does not build here")
    out = fuzz.loader_fuzz(argparse.Namespace(seed=5, n=40, keep=None))
    assert out["differing"] == 0, out
    assert sum(out["counts"].values()) == 40
    assert any(k.startswith("cut: jax reads") for k in out["counts"])


def test_chip_smoke_checks_the_damaged_fixtures(tmp_path):
    """chip_smoke.py's codecs phase holds every damaged fixture to the
    stored digests (its counts match the directory), and its trainer
    folders hold the two cut 640x480 files among the contents, which the
    loader stages as the JAX loader's digests say."""
    import chip_smoke as cs

    out = cs.check_damaged()
    assert out["damaged_batches_differing"] == 0
    assert sorted(out["damaged_640x480"]) == ["trainer_cut_progressive",
                                              "trainer_cut_restart"]
    bodies = cs.kind_bodies(np.random.default_rng(0))
    assert bodies["kind_cut_restart.jpg"] == _read("trainer_cut_restart")
    cdir, _ = cs.trainer_folders(str(tmp_path))
    for name in ("restart", "progressive"):
        path = os.path.join(cdir, f"kind_cut_{name}.jpg")
        got = _sha(tnative.decode_resize_batch([path], cs.TRAINER_RESIZE)[0])
        assert got == DIGESTS[f"trainer_cut_{name}"]["loader"][
            str(cs.TRAINER_RESIZE)]


def _without_dht(data: bytes) -> bytes:
    out, i = data[:2], 2
    while i < len(data):
        if data[i] != 0xFF or data[i + 1] in (0xD8, 0xD9) or \
                0xD0 <= data[i + 1] <= 0xD7:
            out += data[i:i + 1]
            i += 1
            continue
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        if data[i + 1] != 0xC4:
            out += data[i:i + 2 + n]
        i += 2 + n
        if data[i - 2 - n + 1] == 0xDA:   # the scan's data to its marker
            j = i
            while not (data[j] == 0xFF and data[j + 1] not in
                       (0x00, *range(0xD0, 0xD8))):
                j += 1
            out += data[i:j]
            i = j
    return out


@pytest.mark.parametrize("kind", ["sequential", "progressive", "lossless"])
def test_missing_huffman_tables(kind):
    """Without its DHT segments a sequential frame decodes with
    libjpeg-turbo's standard tables (Motion-JPEG), where jdphuff.c and
    jdlhuff.c refuse a table no segment defined: PIL's verdicts."""
    rng = np.random.default_rng(45)
    img = fx.smooth(rng, 24, 32)
    data = {"sequential": lambda: fx._pil_jpeg(img, quality=75),
            "progressive": lambda: fx._pil_jpeg(img, quality=75,
                                                progressive=True),
            "lossless": lambda: mjf.lossless_jpeg([img[..., 0]], [(1, 1)],
                                                  1)}[kind]()
    body = _without_dht(data)
    assert b"\xff\xc4" not in body and len(body) < len(data)
    want = _pil(body)
    assert (want is not None) == (kind == "sequential")
    assert _same(want, _port(body))
