"""ctypes bridge to the native library: the port's own JPEG codec
(``native/jpeg.cpp``), its WebP and GIF decoders (``native/webp.cpp``,
``native/gif.cpp``), the byte-serial TIFF codecs that ``utils/tiff.py``
drives (``native/tiff.cpp``, with CCITT in ``native/fax.cpp`` and
Zstandard in ``native/zstd.cpp``), TGA's, PCX's and QOI's decoders
(``native/tga.cpp``, ``native/pcx.cpp``, ``native/qoi.cpp``) and the
batch loader that decodes and
resizes JPEGs on worker threads (``native/loader.cpp``; JAX counterpart:
data/native_loader.py, which links libjpeg, and PIL for every other
file).

The library is compiled on first use with the flags of the JAX package's
native/build.sh, less libjpeg, which neither machine needs:

    g++ -O3 -march=native -shared -fPIC -o build/libmmst_loader-<hash>.so
        native/loader.cpp native/jpeg.cpp native/webp.cpp native/gif.cpp
        native/tiff.cpp native/fax.cpp native/zstd.cpp native/tga.cpp
        native/pcx.cpp native/qoi.cpp native/cms.cpp -lpthread

into ``build/`` at the repository root (listed in .gitignore), keyed by a
hash of the sources and the flags; the library is written to a temporary
file first and renamed into place. Nothing is written inside the package.
It runs on the host, not on the device.

* ``decode_jpeg(bytes) -> uint8 (H, W, 3)``: every 8-bit JPEG that PIL
  reads (sequential and progressive, Huffman or arithmetic-coded, and
  lossless frames; grey, YCbCr, RGB, CMYK or YCCK at any sampling; restart
  intervals; libjpeg-turbo's block smoothing where a progressive file's
  scans stop early) at full size with libjpeg-turbo's default arithmetic,
  so the pixels are PIL's ``convert("RGB")``. Anything else (hierarchical,
  12-bit, truncated, corrupt, a decompression bomb) raises ``ValueError``
  naming the reason.
* ``decode_jpeg_planes``: a JPEG's components as libjpeg's raw data
  output gives them, for ``utils/ojpeg.py``.
* ``decode_webp(bytes) -> uint8 (H, W, 3)``: every WebP that PIL reads
  (lossy VP8 and lossless VP8L, simple or extended, with or without
  alpha, still or animated) as PIL's ``convert("RGB")`` gives it: the
  first frame on its canvas, zero outside it, the alpha dropped. A file
  libwebp refuses (truncated, corrupt, not a key frame, sizes that
  disagree) or one above the decompression-bomb limit raises
  ``ValueError`` naming the reason.
* ``decode_gif(bytes) -> uint8 (H, W, 3)``: a GIF's first frame as PIL's
  ``convert("RGB")`` gives it (Pillow's GifImagePlugin and GifDecode.c:
  the canvas grown to the frame, filled with the transparency index or 0,
  the palette black past its entries, a grey ramp read as grey). A file
  Pillow refuses, or a canvas above the decompression-bomb limit, raises
  ``ValueError`` naming the reason.
* ``decode_tiff``: a TIFF's strips or tiles (a ``TIFF_CHUNK`` table)
  through libtiff's LZW, PackBits, JPEG, CCITT (``native/fax.cpp``) or
  Zstandard (``native/zstd.cpp``) codec as libtiff runs them for Pillow,
  many in one call (``utils/tiff.py`` reads the file and lays out the
  rows).
* ``decode_tga_rle``: a TGA's run-length packets as Pillow's
  TgaRleDecode.c reads them (``native/tga.cpp``; ``utils/tga.py`` reads
  the header and the colours).
* ``decode_pcx_rle``: a PCX's run-length rows as Pillow's PcxDecode.c
  reads them (``native/pcx.cpp``; ``utils/pcx.py`` reads the header, the
  planes and the palette).
* ``decode_qoi``: a QOI's ops as Pillow's QoiDecoder applies them
  (``native/qoi.cpp``; ``utils/qoi.py`` reads the header).
* ``cms_tetrahedral8``: an 8-bit colour transform's pixels through its
  16-bit CLUT as LittleCMS evaluates them (``native/cms.cpp``;
  ``utils/cms.py`` builds the CLUT).
* ``decode_zstd_frame(bytes, limit) -> bytes``: one whole Zstandard frame
  (``native/zstd.cpp``), the output growing as it decodes, for the
  checkpoint readers (``utils/ocdbt.py``, ``utils/zarr.py``).
* ``encode_jpeg(uint8 (H, W, 3), quality) -> bytes``: baseline 4:2:0 JFIF
  as PIL's ``Image.save(..., "JPEG", quality=q)`` writes it (IJG tables
  scaled to the quality, standard Huffman tables).
* ``decode_resize_batch``: a batch of JPEG files decoded and resized on
  worker threads, each with the JAX package's DCT-domain prescale (JAX
  native/loader.cpp:62-75): decoded at the smallest n/8 of its size that
  still covers the target (block smoothing as that loader's libjpeg-turbo
  2.1 does it), then resized as JAX's loader resizes, so that the batch is
  JAX's bit for bit. CMYK, YCCK and lossless files, which that libjpeg
  does not decode to RGB, take its fallback as there: the full-size decode
  and Pillow's BILINEAR (``pipeline._decode_resize``).

The codecs keep no state between calls, and ctypes releases the
interpreter lock while they run: the HTTP server's threads decode at once.
Where the library does not build (no g++), the codecs raise
``RuntimeError`` with the compiler's reason; nothing decodes a JPEG, a
WebP, a GIF, a compressed TIFF, a run-length TGA or PCX or a QOI by
another route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

NATIVE = Path(__file__).resolve().parents[1] / "native"
SOURCES = [NATIVE / "loader.cpp", NATIVE / "jpeg.cpp", NATIVE / "webp.cpp",
           NATIVE / "gif.cpp", NATIVE / "tiff.cpp", NATIVE / "fax.cpp",
           NATIVE / "zstd.cpp", NATIVE / "tga.cpp", NATIVE / "pcx.cpp",
           NATIVE / "qoi.cpp", NATIVE / "cms.cpp"]
HEADERS = [NATIVE / "jpeg.h", NATIVE / "webp.h", NATIVE / "gif.h",
           NATIVE / "tiff.h", NATIVE / "fax.h", NATIVE / "zstd.h",
           NATIVE / "tga.h", NATIVE / "pcx.h", NATIVE / "qoi.h",
           NATIVE / "cms.h"]
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
LIBS = ["-lpthread"]

_lock = threading.Lock()
_state = {"lib": None, "error": None}
_ERR_LEN = 256
_u8p = ctypes.POINTER(ctypes.c_uint8)
# native/tiff.h Chunk, one row of the table decode_tiff takes
TIFF_CHUNK = np.dtype([("offset", "<u8"), ("count", "<u8"), ("need", "<i8"),
                       ("width", "<i4"), ("height", "<i4"), ("last", "<i4"),
                       ("status", "<i4")], align=True)


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    for f in SOURCES + HEADERS:
        digest.update(f.read_bytes())
    return BUILD_DIR / f"libmmst_loader-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp),
                        *(str(s) for s in SOURCES), *LIBS],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        tmp.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    lib.mmst_decode_resize_batch.restype = ctypes.c_int
    lib.mmst_decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _u8p, ctypes.c_int,
        ctypes.c_int, _u8p]
    lib.mmst_jpeg_info.restype = ctypes.c_int
    lib.mmst_jpeg_info.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.mmst_jpeg_decode.restype = ctypes.c_int
    lib.mmst_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, _u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    # the n/8 decode (n = 1..8) that the batch loader runs in C++, block
    # smoothing's edges as libjpeg-turbo 2.1 (the JAX loader's) takes them
    lib.mmst_jpeg_decode_scaled.restype = ctypes.c_int
    lib.mmst_jpeg_decode_scaled.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, _u8p, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.mmst_jpeg_decode_planes.restype = ctypes.c_int
    lib.mmst_jpeg_decode_planes.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, _u8p,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int]
    lib.mmst_jpeg_encode.restype = ctypes.c_int
    lib.mmst_jpeg_encode.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_u8p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_int]
    lib.mmst_jpeg_free.restype = None
    lib.mmst_jpeg_free.argtypes = [ctypes.c_void_p]
    lib.mmst_webp_info.restype = ctypes.c_int
    lib.mmst_webp_info.argtypes = lib.mmst_jpeg_info.argtypes
    lib.mmst_webp_decode.restype = ctypes.c_int
    lib.mmst_webp_decode.argtypes = lib.mmst_jpeg_decode.argtypes
    lib.mmst_gif_info.restype = ctypes.c_int
    lib.mmst_gif_info.argtypes = lib.mmst_jpeg_info.argtypes
    lib.mmst_gif_decode.restype = ctypes.c_int
    lib.mmst_gif_decode.argtypes = lib.mmst_jpeg_decode.argtypes
    lib.mmst_tiff_decode.restype = ctypes.c_int
    lib.mmst_tiff_decode.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, _u8p, ctypes.c_char_p, ctypes.c_int]
    lib.mmst_tiff_state_new.restype = ctypes.c_void_p
    lib.mmst_tiff_state_new.argtypes = []
    lib.mmst_tiff_state_free.restype = None
    lib.mmst_tiff_state_free.argtypes = [ctypes.c_void_p]
    lib.mmst_zstd_frame.restype = ctypes.c_int
    lib.mmst_zstd_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_char_p, ctypes.c_int]
    lib.mmst_zstd_free.restype = None
    lib.mmst_zstd_free.argtypes = [ctypes.c_void_p]
    lib.mmst_tga_rle.restype = ctypes.c_int
    lib.mmst_tga_rle.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_char_p, ctypes.c_int]
    lib.mmst_pcx_rle.restype = ctypes.c_int
    lib.mmst_pcx_rle.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, _u8p, ctypes.c_char_p, ctypes.c_int]
    lib.mmst_cms_tetrahedral8.restype = None
    lib.mmst_cms_tetrahedral8.argtypes = [
        _u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
        _u8p]
    lib.mmst_qoi_decode.restype = ctypes.c_int
    lib.mmst_qoi_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int64, ctypes.c_int,
        _u8p]


def _load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None where it does not
    build or load (then and later: one attempt per process, the reason
    kept for ``_library``)."""
    with _lock:
        if _state["lib"] is not None or _state["error"] is not None:
            return _state["lib"]
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except subprocess.CalledProcessError as e:
            _state["error"] = (f"g++ failed: "
                               f"{e.stderr.decode(errors='replace')[-2000:]}")
            return None
        except (OSError, subprocess.SubprocessError) as e:
            _state["error"] = f"{type(e).__name__}: {e}"
            return None
        _declare(lib)
        _state["lib"] = lib
        return lib


def _library() -> ctypes.CDLL:
    lib = _load_library()
    if lib is None:
        raise RuntimeError("the native codecs (native/jpeg.cpp, "
                           "native/webp.cpp, native/gif.cpp, "
                           "native/tiff.cpp, native/fax.cpp, "
                           "native/zstd.cpp, native/tga.cpp, "
                           "native/pcx.cpp, native/qoi.cpp, "
                           "native/cms.cpp) did not "
                           "build: "
                           f"{_state['error']}")
    return lib


def native_available() -> bool:
    return _load_library() is not None


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG's pixels at full size as uint8 (H, W, 3) RGB, as PIL's
    convert("RGB") gives them (grayscale replicated, CMYK through Pillow's
    cmyk2rgb); ValueError for a file the decoder does not read, a frame
    above PIL's decompression-bomb limit (2 x 89,478,485 pixels) among
    them. The frame header is read first and the pixels decoded straight
    into the returned array."""
    lib = _library()
    data = bytes(data)
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.mmst_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                          err, _ERR_LEN):
        raise ValueError(f"JPEG: {err.value.decode(errors='replace')}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.mmst_jpeg_decode(data, len(data), out.ctypes.data_as(_u8p),
                            w.value, h.value, err, _ERR_LEN):
        raise ValueError(f"JPEG: {err.value.decode(errors='replace')}")
    return out


def decode_jpeg_planes(data: bytes, bound: int, stop: bool = False):
    """A JPEG's components as libjpeg's raw data output gives them (each
    component's samples at its own size, its blocks whole: a (rows,
    stride) uint8 array each), the first scan read as libtiff's old-style
    JPEG codec has libjpeg read its stream: a fake EOI past the data, or
    with ``stop`` a failure there, and a failure at a restart marker other
    than the one expected. Returns (planes, the iMCU row where the decode
    failed or -1). ValueError where the decoder refuses the stream or the
    planes pass ``bound`` bytes, which the caller bounds."""
    lib = _library()
    data = bytes(data)
    out = np.empty(bound, np.uint8)
    dims = (ctypes.c_int * 8)()
    n, failed = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.mmst_jpeg_decode_planes(data, len(data), int(stop),
                                   out.ctypes.data_as(_u8p), bound, dims,
                                   ctypes.byref(n), ctypes.byref(failed),
                                   err, _ERR_LEN):
        raise ValueError(err.value.decode(errors="replace"))
    planes, at = [], 0
    for k in range(n.value):   # one step a component (4 at most)
        stride, rows = dims[2 * k], dims[2 * k + 1]
        planes.append(out[at:at + stride * rows].reshape(rows, stride))
        at += stride * rows
    return planes, failed.value


def decode_webp(data: bytes) -> np.ndarray:
    """A WebP file's first frame on its canvas as uint8 (H, W, 3) RGB, as
    PIL's convert("RGB") gives it; ValueError for a file libwebp refuses,
    or a canvas above PIL's decompression-bomb limit (2 x 89,478,485
    pixels), checked with the container before the array is allocated."""
    lib = _library()
    data = bytes(data)
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.mmst_webp_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                          err, _ERR_LEN):
        raise ValueError(err.value.decode(errors="replace"))
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.mmst_webp_decode(data, len(data), out.ctypes.data_as(_u8p),
                            w.value, h.value, err, _ERR_LEN):
        raise ValueError(err.value.decode(errors="replace"))
    return out


def decode_gif(data: bytes) -> np.ndarray:
    """A GIF's first frame on its canvas as uint8 (H, W, 3) RGB, as PIL's
    convert("RGB") gives it; ValueError for a file Pillow refuses, or a
    canvas above PIL's decompression-bomb limit (2 x 89,478,485 pixels),
    checked with the header before the array is allocated."""
    lib = _library()
    data = bytes(data)
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.mmst_gif_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                         err, _ERR_LEN):
        raise ValueError(err.value.decode(errors="replace"))
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.mmst_gif_decode(data, len(data), out.ctypes.data_as(_u8p),
                           w.value, h.value, err, _ERR_LEN):
        raise ValueError(err.value.decode(errors="replace"))
    return out


class TiffState:
    """What libtiff keeps from one strip or tile of an image to the next
    (native/tiff.h State: the CCITT codec's run arrays and "no EOL" mode,
    the tables libjpeg holds), for the ``decode_tiff`` calls over one
    image; a context manager that frees it."""

    def __init__(self):
        self._lib = _library()
        self.handle = self._lib.mmst_tiff_state_new()

    def __enter__(self) -> "TiffState":
        return self

    def __exit__(self, *exc) -> None:
        if self.handle:
            self._lib.mmst_tiff_state_free(self.handle)
            self.handle = None


def decode_tiff(compression: int, data: bytes, chunks: np.ndarray,
                reverse: bool, tables: bytes, colour: int, channels: int,
                out: np.ndarray, tolerant: bool = False, carry: bool = False,
                options: int = 0, state: Optional[TiffState] = None
                ) -> np.ndarray:
    """Decode a TIFF's strips or tiles (``chunks``, a ``TIFF_CHUNK``
    array) into ``out`` (uint8, their bytes one after another) with the
    byte-serial codecs of native/tiff.cpp: compression 5 (LZW), 32773
    (PackBits), 7 (JPEG, ``tables`` the JPEGTables stream, ``colour`` 1
    YCbCr to RGB or 2 the ``channels`` components as stored, ``options``
    the expected sampling, native/tiff.h), 2, 3, 4 and 32771 (CCITT;
    ``options`` the T4Options tag; each chunk's ``height`` its rows) or
    50000 (Zstandard), ``state`` the image's TiffState (else one for this
    call); ``reverse`` reverses each byte's bits
    first (FillOrder 2). ValueError naming the chunk and the reason where
    libtiff refuses it; with ``tolerant`` a failed chunk keeps what its
    codec wrote before it failed and the call goes on (libtiff's
    TIFFRGBAImage reading); with ``carry`` each chunk starts from the
    bytes of the one before (one buffer for all, as libtiff's and
    Pillow's). Returns each chunk's status (0 decoded, 1 failed)."""
    chunks = np.array(chunks, TIFF_CHUNK)
    if (chunks.ndim != 1 or len(chunks) >= 1 << 31
            or out.dtype != np.uint8 or not out.flags.c_contiguous
            or out.size < int(chunks["need"].sum())):
        raise ValueError("decode_tiff: out cannot hold the chunks")
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.mmst_tiff_decode(int(compression), bytes(data), len(data),
                            chunks.ctypes.data, len(chunks), int(reverse),
                            int(tolerant), int(carry), bytes(tables),
                            len(tables), int(colour), int(channels),
                            int(options), state.handle if state else None,
                            out.ctypes.data_as(_u8p), err, _ERR_LEN):
        raise ValueError(err.value.decode(errors="replace"))
    return chunks["status"].copy()


def decode_tga_rle(data: bytes, depth: int, linesize: int, ysize: int,
                   bottom_up: bool) -> np.ndarray:
    """A TGA's run-length packets (``data``, from the first packet) as
    Pillow's TgaRleDecode.c reads them: (ysize, linesize) uint8 rows of
    ``depth`` bytes a pixel, the file's first row at the bottom where
    ``bottom_up``. ValueError where Pillow refuses (the data ends early, a
    run crosses a row's end). The caller bounds ysize * linesize."""
    lib = _library()
    data = bytes(data)
    out = np.zeros((ysize, linesize), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.mmst_tga_rle(data, len(data), int(depth), int(linesize),
                        int(ysize), int(bottom_up), out.ctypes.data_as(_u8p),
                        err, _ERR_LEN):
        raise ValueError(err.value.decode(errors="replace"))
    return out


def decode_pcx_rle(data: bytes, bytes_per_row: int, xsize: int,
                   ysize: int, bits: int) -> np.ndarray:
    """A PCX's run-length rows (``data`` from the first packet) as Pillow's
    PcxDecode.c reads them: (ysize, bytes_per_row) uint8, each row's planes
    moved together where that decoder moves them for an unpacker of
    ``bits`` a pixel. ValueError where
    Pillow refuses (the data ends before the last row, a run passes a
    row's end). The caller bounds ysize * bytes_per_row."""
    lib = _library()
    data = bytes(data)
    out = np.zeros((ysize, bytes_per_row), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    status = lib.mmst_pcx_rle(data, len(data), int(bytes_per_row), int(xsize),
                              int(ysize), int(bits),
                              out.ctypes.data_as(_u8p), err, _ERR_LEN)
    if status < 0:
        raise ValueError(err.value.decode(errors="replace"))
    if status == 1:
        raise ValueError("PCX: image file is truncated")
    if status == 2:
        raise ValueError("PCX: a run passes a row's end (buffer overrun)")
    return out


def decode_qoi(data: bytes, pixels: int, bands: int) -> np.ndarray:
    """A QOI's ops (``data`` from the first op) as Pillow's QoiDecoder
    applies them: (pixels, bands) uint8. ValueError where the data ends
    before the last pixel. The caller bounds pixels."""
    lib = _library()
    data = bytes(data)
    out = np.zeros((pixels, bands), np.uint8)
    if lib.mmst_qoi_decode(data, len(data), int(pixels), int(bands),
                           out.ctypes.data_as(_u8p)):
        raise ValueError("QOI: the data ends before the last pixel")
    return out


def cms_tetrahedral8(pixels: np.ndarray, clut: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 pixels through ``clut`` ((grid, grid, grid, 3)
    uint16) as LittleCMS's 8-bit worker runs an optimised transform: each
    byte as the word b * 257, TetrahedralInterp16, FROM_16_TO_8."""
    lib = _library()
    src = np.ascontiguousarray(pixels, np.uint8)
    table = np.ascontiguousarray(clut, np.uint16)
    if src.shape[-1] != 3 or table.ndim != 4 or table.shape[3] != 3 or len(
            set(table.shape[:3])) != 1:
        raise ValueError("cms_tetrahedral8: pixels of 3 bytes and a cube of "
                         "3 words a node")
    out = np.empty_like(src)
    lib.mmst_cms_tetrahedral8(
        src.ctypes.data_as(_u8p), src.size // 3,
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        table.shape[0], out.ctypes.data_as(_u8p))
    return out


def decode_zstd_frame(data: bytes, limit: int) -> bytes:
    """The content of the one Zstandard frame ``data`` holds, at most
    ``limit`` bytes; ValueError naming what is wrong where ``data`` is not
    one whole frame that decodes within the limit."""
    lib = _library()
    out = _u8p()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.mmst_zstd_frame(data, len(data), int(limit), ctypes.byref(out),
                           ctypes.byref(n), err, _ERR_LEN):
        raise ValueError(err.value.decode(errors="replace"))
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.mmst_zstd_free(out)


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """uint8 (H, W, 3) RGB as baseline 4:2:0 JFIF bytes at ``quality``."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes uint8 (H, W, 3), got "
                         f"{rgb.dtype} {rgb.shape}")
    lib = _library()
    out = _u8p()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.mmst_jpeg_encode(rgb.ctypes.data_as(_u8p), rgb.shape[1],
                            rgb.shape[0], int(quality), ctypes.byref(out),
                            ctypes.byref(n), err, _ERR_LEN):
        raise ValueError(f"JPEG: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.mmst_jpeg_free(out)


def decode_resize_batch(paths: List[str], resize_to: int,
                        n_threads: int = 4) -> np.ndarray:
    """Decode and resize a batch of image files to uint8 (N, S, S, 3).

    JPEGs go through the library's threads; every other file, a file the
    library could not read, and every file where the library does not
    build, through ``_decode_resize``, which reads each format with its own
    reader (a JPEG with this library's decoder) and raises, naming the
    file, where none reads it."""
    n = len(paths)
    out = np.empty((n, resize_to, resize_to, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    lib = _load_library()
    if lib is not None and n:
        names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        lib.mmst_decode_resize_batch(
            names, n, out.ctypes.data_as(_u8p), resize_to, n_threads,
            ok.ctypes.data_as(_u8p))
    for i in np.flatnonzero(ok == 0):
        from mastermetastyletransfer_tpu_torch.data.pipeline import (
            _decode_resize,
        )
        out[i] = _decode_resize(paths[i], resize_to)
    return out
