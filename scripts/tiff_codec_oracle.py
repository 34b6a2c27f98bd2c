"""Hold the port's TIFF codecs to Pillow's own libtiff strip by strip, on
the CPU: each fixture of a codec, its strip bytes flipped at random, is
read by libtiff (Pillow's bundled build, through ctypes:
``TIFFReadEncodedStrip`` of every strip, in order, into one buffer filled
with a sentinel) and by the port's native codec (``decode_tiff`` on one
``TiffState`` for the image, tolerant, the same sentinel); a strip
differs where the two disagree on success, or, both reading it, on any
byte.

    python scripts/tiff_codec_oracle.py --codec ccitt [--seed 0]
        [--flips 150]

Codecs: ccitt (tests/data/tiff_ccitt/), zstd (the chunky striped
Zstandard fixtures of tests/data/tiff/ without a predictor, which
libtiff undoes inside its read). Prints one JSON line: strips compared
and differing (in verdict, or in bytes where both read the strip), with
the first few cases. The way to see what libtiff does on damaged data,
where Pillow's pixels alone hide it.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def libtiff():
    from PIL import Image, _imaging  # noqa: F401 - loads libtiff's libraries

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


def libtiff_strips(lib, data: bytes, sentinel: int = 0xAB):
    """[(libtiff's return, the buffer after)] a strip, one buffer for
    all; None where libtiff cannot open the file."""
    fd, path = tempfile.mkstemp(suffix=".tif")
    os.write(fd, data)
    os.close(fd)
    try:
        t = lib.TIFFOpen(path.encode(), b"r")
        if not t:
            return None
        size = lib.TIFFStripSize(t)
        buf = np.full(max(size, 1), sentinel, np.uint8)
        out = []
        for i in range(lib.TIFFNumberOfStrips(t)):
            r = lib.TIFFReadEncodedStrip(t, i, buf.ctypes.data, size)
            out.append((r, buf.copy()))
        lib.TIFFClose(t)
        return out
    finally:
        os.unlink(path)


def port_strips(data: bytes, sentinel: int = 0xAB):
    """The same from the port's codec; None where its reader refuses the
    file's layout before any strip."""
    from mastermetastyletransfer_tpu_torch.data import native_loader as nl
    from mastermetastyletransfer_tpu_torch.utils import tiff as T

    try:
        s = T._Setup(T._Ifd(data))
        lay = T._Layout(data, s)
    except ValueError:
        return None
    row_bytes = (lay.seg_w * lay.bits * lay.spp + 7) // 8
    size = row_bytes * lay.rows_per
    buf = np.full(size, sentinel, np.uint8)
    out = []
    with nl.TiffState() as state:
        for i in range(lay.nx * lay.ny):   # one step a strip
            rows = min(lay.rows_per, s.ysize - i * lay.rows_per)
            chunk = np.array([(int(lay.offsets[i]), int(lay.counts[i]),
                               rows * row_bytes, lay.seg_w, rows, 0, 0)],
                             nl.TIFF_CHUNK)
            try:
                status = nl.decode_tiff(s.code, data, chunk,
                                        lay.fillorder == 2, lay.tables, 2, 1,
                                        buf, tolerant=True,
                                        options=lay.t4options, state=state)
                ok = not status[0]
            except ValueError:
                ok = False
            out.append((ok, buf.copy()))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--codec", required=True, choices=("ccitt", "zstd"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flips", type=int, default=150)
    args = ap.parse_args(argv)
    from mastermetastyletransfer_tpu_torch.utils import tiff as T
    from tests import torch_image_formats as tf

    kind = "tiff_ccitt" if args.codec == "ccitt" else "tiff"
    names = [n for n in tf.names(kind) if args.codec == "ccitt" or (
        "zstd" in n and not n.startswith("coco") and not any(
            w in n for w in ("predictor", "tiles", "planar")))]
    lib = libtiff()
    rng = np.random.default_rng(args.seed)
    compared, cases = 0, []
    for name in names:
        data = tf.read(kind, name)
        ifd = T._Ifd(data)
        offsets, counts = ifd.get(273), ifd.get(279)
        lo = min(offsets)
        hi = max(o + c for o, c in zip(offsets, counts))
        for _ in range(args.flips):   # one step a damaged copy
            at, mask = int(rng.integers(lo, hi)), int(rng.integers(1, 256))
            damaged = tf.flip(data, at, mask)
            theirs, ours = libtiff_strips(lib, damaged), port_strips(damaged)
            if theirs is None or ours is None:
                continue
            for i, ((r, a), (ok, b)) in enumerate(zip(theirs, ours)):
                compared += 1
                if (r > 0) != ok or (ok and not np.array_equal(a, b)):
                    cases.append([name, at, mask, i])
    print(json.dumps(dict(codec=args.codec, seed=args.seed,
                          strips_compared=compared, differing=len(cases),
                          cases=cases[:20])))


if __name__ == "__main__":
    main()
