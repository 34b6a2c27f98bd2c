"""Helpers of the image-format tests (tests/test_torch_image_formats.py,
tests/test_torch_tiff.py): the fixtures of scripts/make_image_format_
fixtures.py, PIL's pixels of a body, and the subprocess run that decodes
damaged files with the port's readers and holds each verdict to PIL's."""

from __future__ import annotations

import functools
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import warnings

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
EXT = {"pnm": "pnm", "gif": "gif", "tiff": "tif", "ico": "ico",
       "dib": "dib", "tga": "tga", "tiff_ccitt": "tif"}
# Pillow's formats that the port reads (data/pipeline.py's _KINDS)
PORT_FORMATS = {"BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "ICO", "TIFF",
                "TGA", "WEBP", "MPO"}
SIZES = [(1, 1), (1, 17), (17, 1), (33, 47), (257, 131)]


def names(kind: str) -> list:
    d = os.path.join(DATA, kind)
    return sorted(f[:-len(EXT[kind]) - 1] for f in os.listdir(d)
                  if f.endswith("." + EXT[kind]))


def read(kind: str, name: str) -> bytes:
    with open(os.path.join(DATA, kind, f"{name}.{EXT[kind]}"), "rb") as f:
        return f.read()


def stored(kind: str, name: str):
    """The stored pixels of a fixture, or (shape, sha256) of a timing
    input's."""
    path = os.path.join(DATA, kind, "digests.json")
    if os.path.exists(path):
        with open(path) as f:
            digests = json.load(f)
        if name in digests:
            return tuple(digests[name]["shape"]), digests[name]["sha256"]
    return np.load(os.path.join(DATA, kind, "pixels.npz"))[name]


def digest(px: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()


def pil(data: bytes):
    """(PIL's convert("RGB") of the bytes, or None where PIL refuses them,
    and the format PIL opened them as)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(io.BytesIO(data)) as im:
                return np.asarray(im.convert("RGB")), im.format
    except Exception:  # noqa: BLE001 - any refusal of PIL's
        return None, None


def assert_pil_pixels(decode, data: bytes, label) -> None:
    want, _ = pil(data)
    assert want is not None, label
    got = decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, label
    assert np.count_nonzero(got != want) == 0, label


def flip(data: bytes, i: int, mask: int) -> bytes:
    b = bytearray(data)
    b[i] ^= mask
    return bytes(b)


_FUZZ = """
import hashlib, os, sys
from mastermetastyletransfer_tpu_torch.data.pipeline import decode_image
import numpy as np
folder, keep = sys.argv[1], sys.argv[2] == "1"
for name in sorted((n for n in os.listdir(folder) if n.isdigit()), key=int):
    with open(os.path.join(folder, name), "rb") as f:
        data = f.read()
    try:
        px = decode_image(data)
        if keep:
            np.save(os.path.join(folder, name + ".npy"), px)
        print(name, "OK", px.shape, hashlib.sha256(px.tobytes()).hexdigest())
    except ValueError as e:
        print(name, "REFUSED", str(e).replace(chr(10), " "))
"""


def damaged(data: bytes, rng: np.random.Generator, cuts: int,
            flips: int) -> list:
    """Truncations at ``cuts`` random lengths and ``flips`` single-byte
    flips of random bits."""
    out = [data[:c] for c in sorted(set(
        rng.integers(1, len(data), cuts).tolist()))]
    out += [flip(data, int(rng.integers(0, len(data))),
                 int(rng.integers(1, 256))) for _ in range(flips)]
    return out


@functools.lru_cache(maxsize=None)
def _libtiff():
    """Pillow's own libtiff (its wheel's pillow.libs), through ctypes."""
    import ctypes
    import glob

    from PIL import _imaging  # noqa: F401 - loads libtiff's libraries

    here = os.path.dirname(os.path.dirname(Image.__file__))
    lib = ctypes.CDLL(glob.glob(os.path.join(here, "pillow.libs",
                                             "libtiff-*.so*"))[0])
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    for name in ("TIFFNumberOfStrips", "TIFFStripSize"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.TIFFNumberOfStrips.restype = ctypes.c_uint32
    lib.TIFFStripSize.restype = ctypes.c_int64
    lib.TIFFReadEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                         ctypes.c_void_p, ctypes.c_int64]
    lib.TIFFReadEncodedStrip.restype = ctypes.c_int64
    for name in ("TIFFSetErrorHandler", "TIFFSetWarningHandler"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_void_p
        getattr(lib, name)(None)
    return lib


def unwritten_rows(data: bytes, rows_per_strip: int, tmp_path) -> set:
    """The image rows of a one-sample striped TIFF that libtiff leaves as
    its strip buffer held them (a T.6 strip that ends early), where the
    rows before them do not fix them: Pillow reads one buffer, never
    cleared, strip after strip, so such rows of its first strips are
    memory it never wrote."""
    path = str(tmp_path / "unwritten.tif")
    with open(path, "wb") as f:
        f.write(data)
    lib = _libtiff()
    got = []
    for fill in (0x00, 0xFF):   # one buffer for all strips, as Pillow's
        t = lib.TIFFOpen(path.encode(), b"r")
        if not t:
            return set()
        size = lib.TIFFStripSize(t)
        buf = np.full(max(size, 1), fill, np.uint8)
        rows = []
        for i in range(lib.TIFFNumberOfStrips(t)):
            lib.TIFFReadEncodedStrip(t, i, buf.ctypes.data, size)
            rows.append(buf.copy())
        lib.TIFFClose(t)
        got.append(rows)
    out = set()
    for i, (a, b) in enumerate(zip(*got)):
        per_row = a.size // rows_per_strip
        for r in range(rows_per_strip):
            if not np.array_equal(a[r * per_row:(r + 1) * per_row],
                                  b[r * per_row:(r + 1) * per_row]):
                out.add(i * rows_per_strip + r)
    return out


def verdicts_match_pil(cases: list, tmp_path, unwritten=None) -> dict:
    """Decode each case with the port in a subprocess (a crash fails the
    caller's test, not its worker) and hold the verdict to PIL's: refused
    where PIL refuses, PIL's pixels where PIL decodes. Bodies that PIL
    opens as a format the port does not read must be refused, and are
    counted under "other". ``unwritten(case)``, where given, names the
    rows whose pixels PIL takes from memory it never wrote: the rest of
    such a case is held to PIL's (counted under "unwritten")."""
    for i, data in enumerate(cases):
        with open(tmp_path / str(i), "wb") as f:
            f.write(data)
    proc = subprocess.run([sys.executable, "-c", _FUZZ, str(tmp_path), "1"
                           if unwritten else "0"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == len(cases)
    counts = {"refused": 0, "decoded": 0, "other": 0, "unwritten": 0}
    for line in lines:
        i, verdict, rest = line.split(" ", 2)
        want, fmt = pil(cases[int(i)])
        if want is not None and fmt not in PORT_FORMATS:
            assert verdict == "REFUSED", (i, fmt)
            counts["other"] += 1
        elif verdict == "REFUSED":
            counts["refused"] += 1
            assert want is None, (i, rest)
        else:
            assert want is not None, i
            if rest == f"{want.shape} {digest(want)}":
                counts["decoded"] += 1
                continue
            skip = unwritten(cases[int(i)]) if unwritten else set()
            assert skip, (i, rest[:80])
            got = np.load(tmp_path / f"{i}.npy")
            keep = [r for r in range(want.shape[0]) if r not in skip]
            assert got.shape == want.shape, i
            assert np.array_equal(got[keep], want[keep]), i
            counts["unwritten"] += 1
    return counts


def _tiff_ifd(entries: list, body: bytes) -> bytes:
    """A little-endian TIFF: ``body`` from byte 8, then one IFD of
    ``entries`` (tag, type, numpy values), arrays past 4 bytes after it."""
    ifd_at = 8 + len(body)
    data_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, extra = struct.pack("<H", len(entries)), b""
    for tag, typ, values in sorted(entries, key=lambda e: e[0]):
        payload = np.asarray(values, {3: "<u2", 4: "<u4"}[typ]).tobytes()
        if len(payload) <= 4:
            field = payload.ljust(4, b"\0")
        else:
            field = struct.pack("<I", data_at + len(extra))
            extra += payload
        ifd += struct.pack("<HHI", tag, typ, len(values)) + field
    return b"II*\0" + struct.pack("<I", ifd_at) + body + ifd + bytes(4) + extra


@functools.lru_cache(maxsize=None)
def hostile_tiffs() -> dict:
    """TIFF bodies of a few hundred bytes to a few MB whose strip or tile
    geometry reaches far past their data, each refused by PIL: name ->
    (body, what the port's refusal names)."""
    from scripts import make_image_format_fixtures as fx

    px = np.full((1, 1, 1), 7, np.uint8)
    grey = {"photometric": 1, "compression": 5}
    n = 1_000_001
    return {
        # 169M tiles of 1 x 1, one of them given: libtiff's short tag
        "tiles_1x1_13000sq": (fx.tiff_file(px, tile=(1, 1), tags={
            256: (4, [13000]), 257: (4, [13000])}, **grey),
            "incorrect count"),
        # 59K tiles, one given: the rest have 0 bytes
        "tiles_16sq_short_counts": (fx.tiff_file(px, tile=(16, 16), tags={
            256: (4, [15000]), 257: (4, [1000])}, **grey), "0 bytes"),
        # a 1 x 1 image in one tile of 65535 x 65535 bytes
        "tile_4gib": (fx.tiff_file(px, tile=(16, 16), tags={
            322: (4, [65535]), 323: (4, [65535])}, **grey), "2 GiB"),
        # three million strips of one row, one given
        "strips_3m": (fx.tiff_file(px, rows_per_strip=1, tags={
            257: (4, [3_000_000])}, **grey), "incorrect count"),
        # a million and one PackBits strips with their byte counts but one
        # offset: libtiff pads no offsets past a million (below, strips at
        # offset 0 read the header)
        "offsets_short_past_a_million": (_tiff_ifd([
            (256, 4, [1]), (257, 4, [n]), (258, 3, [8]), (259, 3, [32773]),
            (262, 3, [1]), (273, 4, [8]), (277, 3, [1]), (278, 4, [1]),
            (279, 3, np.full(n, 2))], b"\x00\x07"), "incorrect count"),
    }
