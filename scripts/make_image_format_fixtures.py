"""Write the Netpbm, GIF, TIFF, ICO, DIB, TGA, PCX, DCX and QOI fixtures
under tests/data/{pnm,gif,tiff,tiff_ccitt,ico,dib,tga,pcx,dcx,qoi}/ and
PIL's ``convert("RGB")`` pixels beside them
(pixels.npz in each, compressed, by file name without its extension),
from a fixed seed.

    python scripts/make_image_format_fixtures.py [--out tests/data]

The port reads these kinds with its own readers (utils/pnm.py,
native/gif.cpp, utils/tiff.py with native/tiff.cpp, utils/ico.py,
utils/bmp.read_dib); the CPU tests (tests/test_torch_image_formats.py,
tests/test_torch_tiff.py) hold them to PIL on these files, and
chip_smoke.py's ``codecs`` phase to the stored pixels on the machine with
the card, which has no PIL. PIL's save writes what it can: TIFF with no,
PackBits, LZW, Deflate, Adobe Deflate and JPEG compression in modes 1, L,
I;16, F, RGB, RGBA, P and CMYK; GIF; ICO with BMP and PNG entries; PPM,
PGM and PBM. The byte-level writers here (``struct``, with their own LZW
and PackBits encoders) write the rest: TIFF tiles, planar configuration
2, predictors 2 and 3, big-endian and BigTIFF files, FillOrder 2, 1-, 2-
and 4-bit palettes, min-is-white, 12-bit grey, JPEG (YCbCr) in tiles and
in strips each a JFIF of PIL's, YCbCr not JPEG in every subsampling
libtiff's TIFFRGBAImage reads (with ReferenceBlackWhite and
YCbCrCoefficients), associated and
unassociated alpha, a strip with no EOI, the old LSB-first LZW; GIF
interlaced, with a local palette, a first frame offset in, smaller or
larger than the screen, no colour table, a deferred clear and code sizes
2 to 8; every Netpbm magic, maxvals 1 to 65535, comments between tokens,
PFM in both byte orders; ICO entries at 1, 4, 8, 24 and 32 bits up to
256 pixels; DIB at every header size. Five files at COCO's 640x480
(``coco*``: a GIF, an LZW TIFF with predictor 2, a Deflate TIFF and a
JPEG TIFF) are chip_smoke.py's timing inputs, their pixels kept as
digests (``digests.json``); chip_smoke.py writes its 640x480 PPM itself.

Since then also (``KINDS_SEED``): ThunderScan, CIELab and old-style
JPEG TIFFs under tests/data/tiff/, and PCX, DCX and QOI files under
tests/data/{pcx,dcx,qoi}/ (PIL's save and byte-level writers: every
PCX layout Pillow opens, DCX page tables, QOI ops written byte by byte),
with 640x480 timing inputs of each (``coco_kinds_fixtures``).

tests/data/jpeg_damaged/ holds JPEGs cut short and damaged
(``jpeg_damaged_fixtures``) with two references' digests beside them
(``write_jpeg_damaged``): PIL's pixels, and the JAX package's batch
loader's staged image at one target per scale n/8; writing them needs
PIL, the JAX package's loader and the system's libjpeg.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

SEED = 27
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from scripts.make_image_fixtures import (  # noqa: E402
    _palette, bmp_file, bmp_rows, rle4, rle8,
)

KINDS = ("pnm", "gif", "tiff", "ico", "dib", "tga", "tiff_ccitt", "pcx",
         "dcx", "qoi")
# chip_smoke.py's 640 x 480 timing inputs (tests/data/<kind>/coco_*)
COCO = ("gif/coco.gif", "tiff/coco_lzw_pred2.tif", "tiff/coco_deflate.tif",
        "tiff/coco_jpeg.tif")


def smooth(rng: np.random.Generator, h: int, w: int, c: int = 3,
           noise: int = 12) -> np.ndarray:
    """A smooth random image (bilinear upsampling of coarse noise, in
    numpy) plus a little fine noise, uint8 (h, w, c)."""
    gh, gw = max(h // 12, 2), max(w // 12, 2)
    base = rng.integers(0, 256, (gh, gw, c)).astype(np.float64)
    y = np.linspace(0, gh - 1, h)
    x = np.linspace(0, gw - 1, w)
    y0 = np.minimum(y.astype(int), gh - 2)
    x0 = np.minimum(x.astype(int), gw - 2)
    fy, fx = (y - y0)[:, None, None], (x - x0)[None, :, None]
    img = (base[y0][:, x0] * (1 - fy) * (1 - fx)
           + base[y0 + 1][:, x0] * fy * (1 - fx)
           + base[y0][:, x0 + 1] * (1 - fy) * fx
           + base[y0 + 1][:, x0 + 1] * fy * fx)
    img += rng.integers(-noise, noise + 1, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

def lzw_gif(indices: np.ndarray, min_size: int, *, clear_every: int = 0,
            defer: bool = False, eoi: bool = True) -> bytes:
    """GIF's LZW (LSB-first codes, a clear code first) of a flat index
    array, in sub-blocks of at most 255 bytes and a terminator.
    ``clear_every`` emits a clear code after that many codes; ``defer``
    keeps coding at 12 bits once the table is full instead of clearing
    (the deferred clear); ``eoi`` ends with the end code. The code width
    follows the decoder's table (Pillow's GifDecode.c), so that every
    decoder reads the same codes."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0

    def emit(code: int, size: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    def reset():
        return {bytes([i]): i for i in range(clear)}, clear + 2, \
            min_size + 1, clear + 2, True

    table, nxt, size, dnext, first = reset()
    emit(clear, size)
    codes = 0
    data = bytes(np.asarray(indices, np.uint8).reshape(-1))
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        emit(table[w], size)
        codes += 1
        if not first and dnext < 4096:   # the decoder adds an entry
            if dnext == (1 << size) - 1 and size < 12:
                size += 1
            dnext += 1
        first = False
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
        elif not defer:
            emit(clear, size)
            table, nxt, size, dnext, first = reset()
        if clear_every and codes % clear_every == 0:
            emit(clear, size)
            table, nxt, size, dnext, first = reset()
        w = bytes([ch])
    if w:
        emit(table[w], size)
        if not first and dnext < 4096:
            if dnext == (1 << size) - 1 and size < 12:
                size += 1
            dnext += 1
    if eoi:
        emit(end, size)
    if nbits:
        out.append(acc & 0xFF)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + bytes(out[i:i + 255])
                      for i in range(0, len(out), 255))
    return bytes([min_size]) + blocks + b"\0"


def _table(pal) -> tuple:
    """(flag bits, bytes) of a colour table padded to a power of two."""
    pal = np.asarray(pal, np.uint8).reshape(-1, 3)
    bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
    padded = np.zeros((1 << bits, 3), np.uint8)
    padded[:len(pal)] = pal
    return 0x80 | (bits - 1), padded.tobytes()


def gif_file(indices: np.ndarray, *, screen=None, at=(0, 0),
             global_pal=None, local_pal=None, interlace: bool = False,
             min_size: int = 8, transparency=None, background: int = 0,
             comment: bool = False, later_frame: bool = False,
             **lzw) -> bytes:
    """A GIF89a of one frame (two with ``later_frame``): the frame's (h, w)
    indices at ``at`` on a ``screen`` (w, h) (the frame's size by
    default), with a global and/or a local colour table, a graphic
    control extension for ``transparency``, a comment and a NETSCAPE
    loop extension with ``comment``."""
    h, w = indices.shape
    sw, sh = screen or (w + at[0], h + at[1])
    flags, gtab = (0, b"") if global_pal is None else _table(global_pal)
    out = bytearray(b"GIF89a" + struct.pack("<HH", sw, sh)
                    + bytes([flags, background, 0]) + gtab)
    if comment:
        out += b"!\xfe" + bytes([11]) + b"a comment!!" + b"\0"
        out += (b"!\xff\x0bNETSCAPE2.0" + bytes([3, 1, 0, 0]) + b"\0")
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1, 10, 0, transparency]) + b"\0"
    lflags, ltab = (0, b"") if local_pal is None else _table(local_pal)
    rows = indices
    if interlace:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = indices[order]
        lflags |= 0x40
    out += (b"," + struct.pack("<HHHH", at[0], at[1], w, h) + bytes([lflags])
            + ltab + lzw_gif(rows, min_size, **lzw))
    if later_frame:
        out += (b"!\xf9\x04" + bytes([8, 10, 0, 0]) + b"\0" + b","
                + struct.pack("<HHHH", 0, 0, w, h) + b"\0"
                + lzw_gif(np.zeros_like(indices), min_size))
    return bytes(out + b";")


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

def lzw_tiff(data: bytes, *, old: bool = False, eoi: bool = True) -> bytes:
    """TIFF's LZW of ``data``: a clear code first, 9-12-bit codes written
    MSB-first with libtiff's early change (``old``: LSB-first and no early
    change, the form libtiff's LZWDecodeCompat reads), a clear code before
    the table fills, the end code last unless ``eoi`` is False."""
    out, acc, nbits = bytearray(), 0, 0

    def emit(code: int, size: int) -> None:
        nonlocal acc, nbits
        if old:
            acc |= code << nbits
            nbits += size
            while nbits >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nbits -= 8
        else:
            acc = (acc << size) | code
            nbits += size
            while nbits >= 8:
                out.append((acc >> (nbits - 8)) & 0xFF)
                nbits -= 8
            acc &= (1 << nbits) - 1

    def width(free: int) -> int:
        # the decoder reads a code a step behind this table, and widens
        # once its own table reaches the mask (less one, libtiff's early
        # change, in the MSB-first form)
        for size in (9, 10, 11):
            if free < (1 << size) + (1 if old else 0):
                return size
        return 12

    table = {bytes([i]): i for i in range(256)}
    free = 258
    emit(256, 9)
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        emit(table[w], width(free))
        table[wc] = free
        free += 1
        if free >= 4093:
            emit(256, width(free))
            table = {bytes([i]): i for i in range(256)}
            free = 258
        w = bytes([ch])
    if w:
        emit(table[w], width(free))
        free += 1
    if eoi:
        emit(257, width(free))
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF if not old else acc & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes replicated, the rest literal
    in pieces of at most 128."""
    out, i, n = bytearray(), 0, len(data)
    lit = bytearray()

    def flush():
        for k in range(0, len(lit), 128):
            piece = lit[k:k + 128]
            out.append(len(piece) - 1)
            out.extend(piece)
        lit.clear()

    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            flush()
            out.extend([(257 - (j - i)) & 0xFF, data[i]])
            i = j
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def _pack_rows(samples: np.ndarray, bps: int, big_endian: bool) -> np.ndarray:
    """(rows, cols, spp) samples as (rows, row bytes): MSB-first bit
    packing below 8 bits (each row byte-aligned), whole samples in the
    file's byte order at 8 bits and above."""
    rows = samples.shape[0]
    flat = np.ascontiguousarray(samples).reshape(rows, -1)
    if bps in (8, 16, 32, 64) and flat.dtype.kind == "f":
        dt = np.dtype(f"{'>' if big_endian else '<'}f{bps // 8}")
        return flat.astype(dt).view(np.uint8).reshape(rows, -1)
    if bps in (16, 32):
        dt = np.dtype(f"{'>' if big_endian else '<'}u{bps // 8}")
        return flat.astype(np.int64).astype(dt).view(np.uint8).reshape(rows, -1)
    if bps == 8:
        return flat.astype(np.uint8)
    vals = flat.astype(np.uint64)
    n = vals.shape[1]
    bits = ((vals[:, :, None] >> np.arange(bps - 1, -1, -1, dtype=np.uint64))
            & 1).astype(np.uint8).reshape(rows, n * bps)
    return np.packbits(bits, axis=1)


def _predict(samples: np.ndarray, predictor: int, bps: int,
             big_endian: bool) -> np.ndarray:
    """The rows' bytes with the predictor applied: 2 the horizontal
    difference of each sample (modulo its width), 3 the floating-point
    one (each row's bytes in planes, most significant first, then the
    byte differences across the row)."""
    rows, cols, spp = samples.shape
    if predictor == 2:
        dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bps]
        s = samples.astype(np.int64).astype(dt)
        d = s.copy()
        d[:, 1:] = s[:, 1:] - s[:, :-1]
        return _pack_rows(d, bps, big_endian)
    if predictor == 3:
        be = samples.astype(f">f{bps // 8}").view(np.uint8).reshape(
            rows, cols * spp, bps // 8)
        planes = be.transpose(0, 2, 1).reshape(rows, -1).astype(np.int16)
        d = planes.copy()
        d[:, spp:] = planes[:, spp:] - planes[:, :-spp]
        return (d & 0xFF).astype(np.uint8)
    return _pack_rows(samples, bps, big_endian)


def writer_case(rng) -> bytes:
    """One seeded layout of the byte-level writer."""
    h, w = (int(v) for v in rng.integers(1, 48, 2))
    comp = int(rng.choice([1, 5, 8, 32773, 32946]))
    kw = dict(compression=comp, big_endian=bool(rng.random() < 0.4),
              bigtiff=bool(rng.random() < 0.2),
              tile=(16, 32) if rng.random() < 0.3 else None,
              rows_per_strip=int(rng.integers(1, h + 2)))
    pred = comp in (5, 8, 32946) and rng.random() < 0.5
    kind = int(rng.integers(0, 6))
    if kind == 0:   # RGB(A) at 8 or 16 bits, chunky or planar
        bps = int(rng.choice([8, 16]))
        extra = [(), (1,), (2,)][int(rng.integers(0, 3))]
        s = rng.integers(0, 1 << bps, (h, w, 3 + len(extra)))
        return tiff_file(s, bps=bps, extra=extra, predictor=2 if pred
                            else 1, planar=int(rng.choice([1, 2])), **kw)
    if kind == 1:   # grey and min-is-white at 1-16 bits
        bps = int(rng.choice([1, 2, 4, 8, 16]))
        s = rng.integers(0, 1 << bps, (h, w, 1))
        return tiff_file(s, bps=bps, photometric=int(rng.integers(0, 2)),
                            predictor=2 if pred and bps >= 8 else 1, **kw)
    if kind == 2:   # palettes
        bps = int(rng.choice([1, 2, 4, 8]))
        return tiff_file(rng.integers(0, 1 << bps, (h, w, 1)), bps=bps,
                            photometric=3, colormap=rng.integers(
                                0, 65536, (3, 1 << bps)), **kw)
    if kind == 3:   # CMYK
        bps = int(rng.choice([8, 16]))
        return tiff_file(rng.integers(0, 1 << bps, (h, w, 4)), bps=bps,
                            photometric=5, predictor=2 if pred else 1, **kw)
    if kind == 5:   # YCbCr, not JPEG: libtiff's RGBA route
        sub = [(1, 1), (2, 2), (2, 1), (1, 2), (4, 4), (4, 2), (4, 1),
               None][int(rng.integers(0, 8))]
        ref = ([(int(rng.integers(0, 20)), 1), (int(rng.integers(200, 300)),
                                                1), (128, 1), (255, 1),
                (128, 1), (int(rng.integers(200, 300)), 1)]
               if rng.random() < 0.3 else None)
        vs = (sub or (2, 2))[1]
        return ycbcr_tiff(rng, h, w, sub, ref=ref,
                          rows_per_strip=-(-kw["rows_per_strip"] // vs) * vs,
                          compression=comp if comp != 1 else 5,
                          big_endian=kw["big_endian"])
    f = rng.normal(100, 150, (h, w, 1)).astype(np.float32)
    return tiff_file(f, bps=32, photometric=1, sample_format=3,
                     predictor=3 if pred else 1, **kw)


def ycbcr_tiff(rng, h: int, w: int, sub=(2, 2), *, ref=None, luma=None,
               planar: int = 1, rows_per_strip=None, **kw) -> bytes:
    """A YCbCr TIFF (photometric 6, 8-bit) of random samples, not JPEG:
    chunky in the subsampling's blocks (hs x vs luma samples, then Cb and
    Cr) or planar at 1x1, with a YCbCrSubSampling tag unless ``sub`` is
    None (libtiff's default 2x2), ReferenceBlackWhite ``ref`` and
    YCbCrCoefficients ``luma`` as (numerator, denominator) pairs."""
    hs, vs = sub or (2, 2)
    rps = rows_per_strip or h
    tags = dict(kw.pop("tags", {}))
    if sub:
        tags[530] = (3, list(sub))
    if ref:
        tags[532] = (5, list(ref))
    if luma:
        tags[529] = (5, list(luma))
    if planar == 2:
        return tiff_file(rng.integers(0, 256, (h, w, 3)), photometric=6,
                         planar=2, rows_per_strip=rps, tags=tags, **kw)
    bh, bw = -(-h // vs), -(-w // hs)
    blocks = rng.integers(0, 256, (bh, bw * (hs * vs + 2), 1))
    tags.update({256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]),
                 277: (3, [3]), 278: (4, [rps])})
    return tiff_file(blocks, photometric=6, rows_per_strip=-(-rps // vs),
                     tags=tags, **kw)


def _jpeg(chunk: np.ndarray, quality: int) -> bytes:
    """A chunk of 8-bit RGB samples as a JFIF (YCbCr 4:2:0), PIL's."""
    from PIL import Image

    buf = io.BytesIO()
    chunk = chunk.astype(np.uint8)
    Image.fromarray(chunk[..., 0] if chunk.shape[2] == 1 else chunk).save(
        buf, "JPEG", quality=quality)
    return buf.getvalue()


def _compress(raw: bytes, compression: int, **kw) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return lzw_tiff(raw, **kw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 32773:
        return packbits(raw)
    if compression == 34925:   # one xz stream a strip, as tif_lzma.c
        import lzma

        return lzma.compress(raw, format=lzma.FORMAT_XZ, **kw)
    if compression == 50000:   # one frame a strip (fixtures only)
        import zstandard

        return zstandard.ZstdCompressor(**kw).compress(raw)
    raise ValueError(compression)


_REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 7: "s", 11: "f", 16: "Q"}


def tiff_file(samples: np.ndarray, *, bps: int = 8, photometric: int = 2,
              compression: int = 1, predictor: int = 1,
              big_endian: bool = False, bigtiff: bool = False, tile=None,
              rows_per_strip=None, planar: int = 1, fill_order: int = 1,
              sample_format: int = 1, extra=(), colormap=None,
              orientation=None, old_lzw: bool = False, eoi: bool = True,
              tags=None, gap: int = 0, codec=None, chunk_hook=None) -> bytes:
    """A one-page TIFF of (h, w, spp) samples, written tag by tag: strips
    of ``rows_per_strip`` rows or ``tile`` = (width, length) tiles (edge
    tiles padded), chunky or planar (``planar`` 2: each sample a plane of
    its own), compressed each on its own, FillOrder 2 (each byte's bits
    reversed after compression), big-endian or BigTIFF, with a colour
    map, extra samples, an orientation and any other ``tags`` (tag ->
    (type, values)). ``gap`` bytes come before the first strip or tile
    (an odd gap leaves them at odd offsets), ``codec`` are the
    compressor's options, ``chunk_hook(i, blob)`` may replace chunk i's
    bytes (a damaged strip or tile)."""
    h, w, spp = samples.shape
    order = ">" if big_endian else "<"
    planes = ([samples[:, :, k:k + 1] for k in range(spp)] if planar == 2
              else [samples])
    chunks = []
    if tile:
        tw, tl = tile
        for p in planes:
            padded = np.zeros((-(-h // tl) * tl, -(-w // tw) * tw,
                               p.shape[2]), p.dtype)
            padded[:h, :w] = p
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    chunks.append(padded[y:y + tl, x:x + tw])
    else:
        rps = rows_per_strip or h
        for p in planes:
            for y in range(0, h, rps):
                chunks.append(p[y:y + rps])
    blobs = []
    for c in chunks:
        if compression == 7:   # each strip or tile a JPEG of its own
            blobs.append(_jpeg(c, 85))
            continue
        raw = _predict(c, predictor, bps, big_endian).tobytes()
        blob = _compress(raw, compression, **(
            {"old": old_lzw, "eoi": eoi} if compression == 5 else
            codec or {}))
        if fill_order == 2:
            blob = blob.translate(_REVERSED)
        blobs.append(blob)
    entries = {
        256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp),
        259: (3, [compression]), 262: (3, [photometric]),
        277: (3, [spp]), 284: (3, [planar]),
    }
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if sample_format != 1:
        entries[339] = (3, [sample_format] * spp)
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(np.asarray(colormap).reshape(-1)))
    if orientation:
        entries[274] = (3, [orientation])
    if tile:
        entries[322], entries[323] = (4, [tile[0]]), (4, [tile[1]])
    else:
        entries[278] = (4, [rows_per_strip or h])
    entries.update(tags or {})
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    head = 16 if bigtiff else 8
    body = bytearray(gap)
    offsets = []
    if chunk_hook:
        blobs = [chunk_hook(i, b) for i, b in enumerate(blobs)]
    for b in blobs:
        offsets.append(head + len(body))
        body += b
        if (len(body) - gap) % 2:
            body += b"\0"
    entries[off_tag] = (16 if bigtiff else 4, offsets)
    entries[cnt_tag] = (16 if bigtiff else 4, [len(b) for b in blobs])
    ifd_at = head + len(body)
    size = 20 if bigtiff else 12
    inline = 8 if bigtiff else 4
    n = len(entries)
    data_at = ifd_at + (8 if bigtiff else 2) + n * size + (8 if bigtiff else 4)
    ifd, extra_data = bytearray(), bytearray()
    ifd += struct.pack(order + ("Q" if bigtiff else "H"), n)
    for tag in sorted(entries):
        typ, values = entries[tag]
        if typ in (2, 7):
            payload = bytes(values)
            count = len(payload)
        elif typ == 5:
            payload = b"".join(struct.pack(order + "II", *v) for v in values)
            count = len(values)
        else:
            payload = struct.pack(order + _TYPES[typ] * len(values),
                                  *[int(v) for v in values])
            count = len(values)
        if len(payload) <= inline:
            field = payload.ljust(inline, b"\0")
        else:
            field = struct.pack(order + ("Q" if bigtiff else "I"),
                                data_at + len(extra_data))
            extra_data += payload
            if len(extra_data) % 2:
                extra_data += b"\0"
        ifd += struct.pack(order + ("HHQ" if bigtiff else "HHI"), tag, typ,
                           count) + field
    ifd += bytes(8 if bigtiff else 4)
    if bigtiff:
        header = (b"MM" if big_endian else b"II") + struct.pack(
            order + "HHHQ", 43, 8, 0, ifd_at)
    else:
        header = (b"MM" if big_endian else b"II") + struct.pack(
            order + "HI", 42, ifd_at)
    return bytes(header + body + ifd + extra_data)


# ---------------------------------------------------------------------------
# Netpbm
# ---------------------------------------------------------------------------

def pnm_file(magic: bytes, samples: np.ndarray, maxval=None, *,
             plain_sep: bytes = b" ", header_sep=(b"\n",) * 4,
             scale: float = 1.0) -> bytes:
    """A Netpbm file: ``magic``, width, height and maxval (or PFM's
    scale) separated by ``header_sep``, then the samples: plain decimal
    (P1-P3) or raw (bits packed MSB-first for P4, big-endian 16-bit above
    a maxval of 255, float32 rows bottom to top for Pf)."""
    h, w = samples.shape[:2]
    head = magic + header_sep[0] + str(w).encode() + header_sep[1] + \
        str(h).encode()
    if magic == b"Pf":
        head += header_sep[2] + repr(scale).encode() + header_sep[3]
        order = "<f4" if scale < 0 else ">f4"
        return head + samples[::-1].astype(order).tobytes()
    if magic not in (b"P1", b"P4"):
        head += header_sep[2] + str(maxval).encode()
    head += header_sep[3]
    flat = samples.reshape(-1)
    if magic in (b"P1", b"P2", b"P3"):
        return head + plain_sep.join(str(int(v)).encode() for v in flat)
    if magic == b"P4":
        return head + np.packbits(samples.astype(np.uint8), axis=1).tobytes()
    dt = np.uint8 if maxval < 256 else ">u2"
    return head + flat.astype(dt).tobytes()


def pnm_fixtures(rng) -> dict:
    img = smooth(rng, 19, 23)
    grey = img[..., 1]
    bits = (grey > 128).astype(np.uint8)
    out = {}
    for name, mode, fmt in (("pil_p4", "1", "PPM"), ("pil_p5", "L", "PPM"),
                            ("pil_p6", "RGB", "PPM"),
                            ("pil_16bit", "I;16", "PPM"),
                            ("pil_float", "F", "PPM")):
        src = img if mode == "RGB" else grey
        im = _pil_image(src, mode)
        buf = io.BytesIO()
        im.save(buf, fmt)
        out[name] = buf.getvalue()
    out["p1_plain_comments"] = pnm_file(
        b"P1", bits, plain_sep=b"", header_sep=(b" # a comment\n", b"\t",
                                                 b"", b"\n#x\n"))
    out["p4_odd_width"] = pnm_file(b"P4", bits[:, :21])
    out["p2_maxval_100"] = pnm_file(b"P2", grey * 100 // 255, 100,
                                    plain_sep=b"\n")
    out["p2_maxval_1000"] = pnm_file(b"P2", grey.astype(int) * 1000 // 255, 1000,
                                     plain_sep=b" #c\n")
    out["p3_plain"] = pnm_file(b"P3", img, 255, plain_sep=b"  ")
    out["p3_maxval_65535"] = pnm_file(b"P3", img.astype(int) * 257 - 3
                                      * (img > 0), 65535)
    for m in (1, 100, 255, 256, 1000, 65535):
        vals = (grey.astype(np.int64) * m // 255)
        out[f"p5_maxval_{m}"] = pnm_file(b"P5", vals, m)
        out[f"p6_maxval_{m}"] = pnm_file(b"P6", img.astype(np.int64) * m
                                         // 255, m)
    out["p6_comment_in_token"] = pnm_file(
        b"P6", img, 255, header_sep=(b"\n#c\n", b" #x\r", b"\n", b"\n"))
    f = (grey.astype(np.float32) - 40) * 1.7
    f[0, :4] = (np.nan, np.inf, -np.inf, 255.5)
    out["pf_little_endian"] = pnm_file(b"Pf", f, scale=-1.0)
    out["pf_big_endian"] = pnm_file(b"Pf", f, scale=2.5)
    cmyk = np.dstack([img, grey[..., None]])
    out["p0cmyk"] = pnm_file(b"P0CMYK", cmyk, 255)
    out["pycmyk_maxval_1000"] = pnm_file(b"PyCMYK", cmyk.astype(int) * 3,
                                         1000)
    out["pyrgba"] = pnm_file(b"PyRGBA", cmyk, 255)
    out["pyp"] = pnm_file(b"PyP", grey, 255)
    return out


def _pil_image(src: np.ndarray, mode: str):
    from PIL import Image

    if mode == "1":
        return Image.fromarray(src).convert("1")
    if mode == "I;16":
        return Image.fromarray(src.astype(np.uint16) * 251)
    if mode == "F":
        return Image.fromarray(src.astype(np.float32) * 1.5 - 20)
    if mode == "I":
        return Image.fromarray((src.astype(np.int32) - 60) * 3)
    if mode == "P":
        return Image.fromarray(src).quantize(37)
    if mode in ("RGBA", "CMYK"):
        return Image.fromarray(np.dstack([src, src[..., :1] // 2 + 100]),
                               mode)
    if mode == "LA":
        return Image.fromarray(np.dstack([src[..., 0], src[..., 1]]), "LA")
    return Image.fromarray(src).convert(mode)


# ---------------------------------------------------------------------------
# GIF fixtures
# ---------------------------------------------------------------------------

def gif_fixtures(rng) -> dict:
    from PIL import Image

    img = smooth(rng, 27, 35)
    out = {}
    q = Image.fromarray(img).quantize(200)
    for name, im, kw in (
            ("pil_palette", q, {}),
            ("pil_grey", Image.fromarray(img[..., 0]), {}),
            ("pil_interlaced", q, {"interlace": True}),
            ("pil_transparent", q, {"transparency": 5}),
            ("pil_animated", q, {"save_all": True, "append_images": [
                Image.fromarray(img[::-1]).quantize(16)]})):
        buf = io.BytesIO()
        im.save(buf, "GIF", **kw)
        out[name] = buf.getvalue()
    pal = rng.integers(0, 256, (256, 3))
    idx = (img[..., 0] // 16).astype(np.uint8)
    out["interlaced"] = gif_file(idx, global_pal=pal[:16], min_size=4,
                                 interlace=True)
    out["local_palette"] = gif_file(idx, global_pal=pal[:16], min_size=4,
                                    local_pal=pal[100:116])
    out["offset_frame"] = gif_file(idx[:9, :11], screen=(30, 20), at=(7, 5),
                                   global_pal=pal[:16], min_size=4,
                                   transparency=3)
    out["offset_frame_no_transparency"] = gif_file(
        idx[:9, :11], screen=(30, 20), at=(7, 5), global_pal=pal[:16],
        min_size=4, background=9)
    out["frame_past_screen"] = gif_file(idx, screen=(20, 12), at=(4, 3),
                                        global_pal=pal[:16], min_size=4)
    out["no_colour_table"] = gif_file(idx, min_size=4)
    out["grey_ramp_table"] = gif_file(
        idx, global_pal=np.repeat(np.arange(16)[:, None], 3, 1), min_size=4)
    out["short_palette"] = gif_file(idx, global_pal=pal[:5], min_size=4)
    big = rng.integers(0, 256, (70, 90)).astype(np.uint8)
    out["deferred_clear"] = gif_file(big, global_pal=pal, defer=True)
    out["clear_every_40"] = gif_file(idx, global_pal=pal[:16], min_size=4,
                                     clear_every=40)
    out["no_end_code"] = gif_file(idx, global_pal=pal[:16], min_size=4,
                                  eoi=False)
    out["extensions"] = gif_file(idx, global_pal=pal[:16], min_size=4,
                                 comment=True, transparency=1,
                                 later_frame=True)
    for size in range(2, 9):
        out[f"code_size_{size}"] = gif_file(
            (img[..., 0].astype(int) % (1 << size)).astype(np.uint8),
            global_pal=pal[:1 << size],
            min_size=size)
    return out


# ---------------------------------------------------------------------------
# TIFF fixtures
# ---------------------------------------------------------------------------

PIL_TIFF_MODES = ("1", "L", "I;16", "F", "RGB", "RGBA", "P", "CMYK")
PIL_TIFF_COMPRESSIONS = (None, "packbits", "tiff_lzw", "tiff_deflate",
                         "tiff_adobe_deflate")


def pil_tiff(src: np.ndarray, mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    _pil_image(src, mode).save(buf, "TIFF", **kw)
    return buf.getvalue()


def tiff_fixtures(rng) -> dict:
    img = smooth(rng, 19, 21)
    out = {}
    for mode in PIL_TIFF_MODES:
        src = img if mode in ("RGB", "RGBA", "P", "CMYK") else img[..., 1]
        for comp in PIL_TIFF_COMPRESSIONS:
            name = f"pil_{mode.replace(';', '')}_{comp or 'raw'}".lower()
            out[name] = pil_tiff(src, mode, compression=comp)
    for mode in ("RGB", "L", "CMYK"):
        src = img if mode != "L" else img[..., 1]
        out[f"pil_{mode.lower()}_jpeg"] = pil_tiff(
            src, mode, compression="jpeg", quality=80)
    s8 = img.astype(np.int64)
    s16 = s8 * 257 + rng.integers(0, 257, img.shape)
    alpha = s8[..., :1] // 2 + 100
    out["tiles_lzw"] = tiff_file(s8, compression=5, tile=(16, 16))
    out["tiles_planar_deflate_16bit"] = tiff_file(
        s16, bps=16, compression=8, tile=(16, 32), planar=2)
    out["planar_rgb_raw"] = tiff_file(s8, planar=2, rows_per_strip=7)
    out["planar_rgba_lzw"] = tiff_file(
        np.dstack([s8, alpha]), extra=(2,), planar=2, compression=5)
    out["lzw_predictor2_8bit"] = tiff_file(s8, compression=5, predictor=2,
                                           rows_per_strip=5)
    out["deflate_predictor2_16bit"] = tiff_file(
        s16, bps=16, compression=32946, predictor=2)
    f = (s8[..., :1] * 1.5 - 30).astype(np.float32)
    out["lzw_predictor3_float"] = tiff_file(
        f, bps=32, photometric=1, sample_format=3, compression=5,
        predictor=3)
    out["big_endian_rgb16_lzw"] = tiff_file(s16, bps=16, compression=5,
                                            big_endian=True)
    out["big_endian_float"] = tiff_file(f, bps=32, photometric=1,
                                        sample_format=3, big_endian=True)
    out["bigtiff_rgb"] = tiff_file(s8, bigtiff=True, compression=8)
    g = s8[..., 1:2]
    for b in (1, 2, 4):
        cmap = rng.integers(0, 65536, (3, 1 << b))
        out[f"palette_{b}bit_lzw"] = tiff_file(
            g >> (8 - b), bps=b, photometric=3, colormap=cmap, compression=5)
    out["palette_4bit_raw"] = tiff_file(
        g >> 4, bps=4, photometric=3,
        colormap=rng.integers(0, 65536, (3, 16)))
    out["fill_order2_1bit_lzw"] = tiff_file(g >> 7, bps=1, photometric=1,
                                            compression=5, fill_order=2)
    out["fill_order2_4bit_packbits"] = tiff_file(
        g >> 4, bps=4, photometric=1, compression=32773, fill_order=2)
    out["fill_order2_8bit_raw"] = tiff_file(g, photometric=1, fill_order=2)
    out["min_is_white_8bit_deflate"] = tiff_file(g, photometric=0,
                                                 compression=8)
    out["min_is_white_2bit_raw"] = tiff_file(g >> 6, bps=2, photometric=0)
    out["grey_12bit_raw"] = tiff_file(s16[..., 1:2] >> 4, bps=12,
                                      photometric=1)
    out["grey_12bit_lzw"] = tiff_file(s16[..., 1:2] >> 4, bps=12,
                                      photometric=1, compression=5)
    out["signed_16bit_lzw"] = tiff_file(g * 3 - 300, bps=16, photometric=1,
                                        sample_format=2, compression=5)
    out["signed_32bit_raw"] = tiff_file(g * 5 - 300, bps=32, photometric=1,
                                        sample_format=2)
    out["associated_alpha_8bit"] = tiff_file(
        np.dstack([s8 * alpha // 255, alpha]), extra=(1,), compression=5)
    out["associated_alpha_16bit"] = tiff_file(
        np.dstack([s16 * alpha // 255, alpha * 257]), bps=16, extra=(1,),
        compression=8)
    out["unassociated_alpha_16bit"] = tiff_file(
        np.dstack([s16, alpha * 257]), bps=16, extra=(2,), compression=5)
    out["extra_samples_rgbxx"] = tiff_file(
        np.dstack([s8, alpha, alpha]), extra=(0, 0), compression=32773)
    out["cmyk_16bit_deflate"] = tiff_file(
        np.dstack([s16, s16[..., :1]]), bps=16, photometric=5,
        compression=8)
    out["grey_alpha_lzw"] = tiff_file(np.dstack([g, alpha]), photometric=1,
                                      extra=(2,), compression=5)
    out["lzw_no_end_code"] = tiff_file(s8, compression=5, eoi=False,
                                       rows_per_strip=8)
    out["lzw_old_style"] = tiff_file(s8, compression=5, old_lzw=True,
                                     rows_per_strip=8)
    out["orientation_6"] = tiff_file(s8, compression=5, orientation=6)
    out["orientation_3_raw"] = tiff_file(s8, orientation=3)
    out["jpeg_tiles_ycbcr"] = tiff_file(s8, photometric=6, compression=7,
                                        tile=(16, 16))
    out["ycbcr_lzw_2x2_default"] = ycbcr_tiff(rng, 19, 21, None,
                                              compression=5,
                                              rows_per_strip=6)
    out["ycbcr_deflate_4x2_refbw"] = ycbcr_tiff(
        rng, 19, 21, (4, 2), compression=8, rows_per_strip=8,
        ref=[(15, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])
    out["ycbcr_packbits_1x1_bt709"] = ycbcr_tiff(
        rng, 19, 21, (1, 1), compression=32773,
        luma=[(2126, 10000), (7152, 10000), (722, 10000)])
    out["ycbcr_planar_lzw"] = ycbcr_tiff(rng, 19, 21, (1, 1), planar=2,
                                         compression=5, rows_per_strip=7)
    out["jpeg_strips_ycbcr"] = tiff_file(s8, photometric=6, compression=7,
                                         rows_per_strip=8)
    return out


# ---------------------------------------------------------------------------
# TIFF's CCITT, LZMA and Zstandard strips, its YCbCr tiles, predictor and
# orientation, planar JPEG (from their own seed, so the files above stay
# as they were)
# ---------------------------------------------------------------------------

CODECS_SEED = 28


def pil_ccitt(bits: np.ndarray, compression: str, tiffinfo=None) -> bytes:
    """A bilevel image (True black) as PIL's save writes it with a CCITT
    compression (libtiff's encoder): ``tiffinfo`` may set RowsPerStrip
    (278), T4Options (292), FillOrder (266) and Photometric (262)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(~bits.astype(bool)).save(
        buf, "TIFF", compression=compression, tiffinfo=tiffinfo or {})
    return buf.getvalue()


def strips_of(data: bytes) -> list:
    """The strips (or tiles) of a little-endian TIFF, by its offsets and
    byte counts."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        offsets = im.tag_v2.get(273) or im.tag_v2.get(324)
        counts = im.tag_v2.get(279) or im.tag_v2.get(325)
    return [data[o:o + c] for o, c in zip(offsets, counts)]


def fax_pattern(rng, h: int, w: int) -> np.ndarray:
    """A page-like bilevel image: bars, a box, text-like dots and noise."""
    bits = np.zeros((h, w), bool)
    bits[h // 5:h // 5 + 3, 2:w - 2] = True
    bits[h // 2:, w // 3:w // 3 + 2] = True
    bits[h // 2:h // 2 + 8, w // 2:w // 2 + 9] ^= True
    bits |= rng.random((h, w)) < 0.06
    return bits


def thunderscan_tiff(rng) -> bytes:
    """A 4-bit grey TIFF in ThunderScan compression (32809): every pixel a
    raw code (0xC0 | value)."""
    g = rng.integers(0, 16, (6, 9, 1))
    codes = bytes(0xC0 | int(v) for v in g.reshape(-1))
    return tiff_file(g, bps=4, photometric=1, tags={259: (3, [32809])},
                     chunk_hook=lambda i, b: codes)


def ojpeg_tiff(rng) -> bytes:
    """An old-style JPEG TIFF (compression 6) whose JPEGInterchangeFormat
    holds a whole JFIF, the strip's own bytes."""
    s = rng.integers(0, 256, (8, 8, 3))
    jpg = _jpeg(s, 90)
    plain = tiff_file(s, photometric=6, tags={259: (3, [6])},
                      chunk_hook=lambda i, b: jpg)
    at = strips_at(plain)[0]
    return tiff_file(s, photometric=6, tags={
        259: (3, [6]), 513: (4, [at]), 514: (4, [len(jpg)])},
        chunk_hook=lambda i, b: jpg)


def strips_at(data: bytes) -> list:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return list(im.tag_v2.get(273))


def unread_code_tiff(rng, code: int, photometric: int = 1) -> bytes:
    """A TIFF of compression ``code`` whose strips are the raw samples:
    SGILog, WebP, NeXT, JBIG or a code Pillow does not know, each of which
    PIL refuses."""
    spp = 3 if photometric == 2 else 1
    return tiff_file(rng.integers(0, 256, (6, 8, spp)),
                     photometric=photometric, tags={259: (3, [code])})


def ycbcr_tiles_tiff(rng, h: int, w: int, sub=(2, 2), tile=(16, 16), *,
                     compression: int = 5, chunk_hook=None, **kw) -> bytes:
    """A YCbCr TIFF (8-bit, not JPEG) in tiles of random samples, each
    tile in the subsampling's blocks (hs x vs luma samples, Cb, Cr) as
    TIFFTileSize lays them out."""
    hs, vs = sub
    tw, tl = tile
    bw, bh = -(-tw // hs), -(-tl // vs)
    block = hs * vs + 2
    nx, ny = -(-w // tw), -(-h // tl)
    blocks = rng.integers(0, 256, (ny * bh, nx * bw * block, 1))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]),
            277: (3, [3]), 530: (3, list(sub)), 322: (4, [tw]),
            323: (4, [tl])}
    tags.update(kw.pop("tags", {}))
    return tiff_file(blocks, photometric=6, compression=compression,
                     tile=(bw * block, bh), tags=tags, chunk_hook=chunk_hook,
                     **kw)


def codec_tiff_fixtures(rng) -> dict:
    """The TIFF fixtures of CCITT (PIL's save: MH, RLE-W, T.4 1-D
    and 2-D with and without fill bits, T.6; strips; both fill orders,
    WhiteIsZero and BlackIsZero; RLE-W strips at odd offsets, a T.6 strip
    cut short), LZMA and Zstandard (PIL's save in five modes; predictor 2,
    tiles, planar, FillOrder 2, a 64 MiB xz dictionary, Zstandard frames
    with a content size and checksum, of several blocks, raw and RLE
    blocks), YCbCr in tiles (each codec, a tile whose codec fails), with a
    predictor, with each orientation, and planar JPEG (RGB, grey and
    alpha)."""
    out = {}
    bits = fax_pattern(rng, 29, 45)
    cases = (("mh", "tiff_ccitt", {}), ("mh_strips", "tiff_ccitt", {278: 7}),
             ("rlew", "tiff_raw_16", {278: 7}),
             ("g3_1d", "group3", {278: 10}),
             ("g3_2d", "group3", {292: 1, 278: 10}),
             ("g3_fill", "group3", {292: 4}),
             ("g3_2d_fill", "group3", {292: 5, 278: 8}),
             ("g3_uncompressed_option", "group3", {292: 2}),
             ("g4", "group4", {}), ("g4_strips", "group4", {278: 6}))
    for name, comp, info in cases:
        out[f"ccitt_{name}"] = pil_ccitt(bits, comp, info)
        if comp != "tiff_raw_16":   # PIL refuses RLE-W of FillOrder 2
            out[f"ccitt_{name}_fill2_white0"] = pil_ccitt(
                bits, comp, {**info, 266: 2, 262: 0})
    wide = fax_pattern(rng, 12, 1000)
    out["ccitt_g4_wide"] = pil_ccitt(wide, "group4")
    out["ccitt_g3_2d_wide"] = pil_ccitt(wide, "group3", {292: 1})
    # RLE-W strips at odd offsets: libtiff aligns each row to the file's
    # 16-bit words, where the encoder aligned it to the strip's
    packed = np.packbits(bits, axis=1)[..., None]
    rlew = strips_of(pil_ccitt(bits, "tiff_raw_16", {278: 7}))
    for gap in (1, 3):
        out[f"ccitt_rlew_gap{gap}"] = tiff_file(
            packed, bps=1, photometric=1, rows_per_strip=7, gap=gap,
            tags={256: (4, [45]), 259: (3, [32771])},
            chunk_hook=lambda i, b: rlew[i])
    g4 = strips_of(pil_ccitt(bits, "group4", {278: 10}))
    out["ccitt_g4_cut_strip"] = tiff_file(
        packed, bps=1, photometric=1, rows_per_strip=10,
        tags={256: (4, [45]), 259: (3, [4])},
        chunk_hook=lambda i, b: g4[i][:len(g4[i]) // 2] if i == 1 else g4[i])
    img = smooth(rng, 19, 21)
    for mode in ("RGB", "L", "1", "P", "I;16"):
        src = img if mode in ("RGB", "P") else img[..., 1]
        for comp in ("lzma", "zstd"):
            out[f"pil_{mode.replace(';', '').lower()}_{comp}"] = pil_tiff(
                src, mode, compression=comp)
    s8 = img.astype(np.int64)
    s16 = s8 * 257 + rng.integers(0, 257, img.shape)
    out["lzma_predictor2_16bit"] = tiff_file(
        s16, bps=16, compression=34925, predictor=2, rows_per_strip=6)
    out["lzma_tiles_fill2"] = tiff_file(s8, compression=34925,
                                        tile=(16, 16), fill_order=2)
    out["lzma_dict_64mib"] = tiff_file(s8, compression=34925,
                                       codec={"preset": 9})
    out["zstd_predictor2_8bit"] = tiff_file(s8, compression=50000,
                                            predictor=2, rows_per_strip=5)
    out["zstd_checksum_size"] = tiff_file(s8, compression=50000, codec={
        "write_checksum": True, "write_content_size": True, "level": 19})
    out["zstd_planar_tiles"] = tiff_file(s16, bps=16, compression=50000,
                                         tile=(16, 32), planar=2)
    big = smooth(rng, 160, 288)    # 138 KB: two blocks
    big[140:] = rng.integers(0, 256, (20, 288, 3))     # raw blocks
    big[130:140] = 77                                  # an RLE run
    out["zstd_blocks"] = tiff_file(big.astype(np.int64), compression=50000,
                                   codec={"level": 3})
    out["ycbcr_tiles_lzw_2x2"] = ycbcr_tiles_tiff(rng, 29, 37, (2, 2))
    out["ycbcr_tiles_deflate_4x2"] = ycbcr_tiles_tiff(
        rng, 29, 37, (4, 2), compression=8, tile=(32, 16))
    out["ycbcr_tiles_packbits_1x1"] = ycbcr_tiles_tiff(
        rng, 21, 19, (1, 1), compression=32773)
    out["ycbcr_tiles_zstd_2x1"] = ycbcr_tiles_tiff(
        rng, 29, 37, (2, 1), compression=50000)
    out["ycbcr_tiles_lzma_4x4"] = ycbcr_tiles_tiff(
        rng, 29, 37, (4, 4), compression=34925)
    out["ycbcr_tiles_bad_tile"] = ycbcr_tiles_tiff(
        rng, 29, 37, (2, 2), chunk_hook=lambda i, b: b[:len(b) // 3]
        if i in (1, 4) else b)
    out["ycbcr_lzw_predictor2_2x2"] = ycbcr_tiff(
        rng, 19, 21, (2, 2), compression=5, rows_per_strip=6,
        tags={317: (3, [2])})
    out["ycbcr_deflate_predictor2_1x1"] = ycbcr_tiff(
        rng, 19, 21, (1, 1), compression=8, tags={317: (3, [2])})
    out["ycbcr_tiles_zstd_predictor2"] = ycbcr_tiles_tiff(
        rng, 29, 37, (1, 1), compression=50000, tags={317: (3, [2])})
    for k in range(2, 9):
        out[f"ycbcr_orientation_{k}"] = ycbcr_tiff(
            rng, 19, 21, (2, 2), compression=5, rows_per_strip=6,
            tags={274: (3, [k])})
    out["jpeg_planar_rgb"] = tiff_file(s8, compression=7, planar=2,
                                       rows_per_strip=8)
    out["jpeg_planar_grey_alpha"] = tiff_file(
        np.dstack([s8[..., :1], s8[..., 2:]]), compression=7, planar=2,
        photometric=1, extra=(2,))
    return out


def coco_poster() -> np.ndarray:
    """A 640 x 480 timing image of flat bands (runs of 16 to 40 pixels),
    in integers only, so that these files stay small."""
    y, x = np.mgrid[0:480, 0:640]
    r = (x // 40) * 16
    g = (y // 30) * 16
    b = (((x // 16) ^ (y // 16)) & 3) * 64
    return np.dstack([r, g, b]).astype(np.uint8)


def coco_codec_fixtures() -> dict:
    """chip_smoke.py's timing inputs of these kinds at 640 x 480: a T.6
    TIFF of a dithered page, an LZMA and a Zstandard TIFF (PIL's save)
    and an RLE TGA, of flat bands (``coco_poster``)."""
    from PIL import Image

    img = coco_poster()
    out = {}
    src = coco_source()
    page = (src[..., 0].astype(np.int64) + src[..., 2]) % 97 < 30
    out["tiff/coco_g4"] = pil_ccitt(page, "group4")
    for comp in ("lzma", "zstd"):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "TIFF", compression=comp)
        out[f"tiff/coco_{comp}"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TGA", rle=True)
    out["tga/coco_rle"] = buf.getvalue()
    return out


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

def tga_rle(rows: list, depth: int, *, cross: bool = False) -> bytes:
    """Run-length packets of pixel rows (each bytes, ``depth`` bytes a
    pixel): runs of equal pixels, literals of the rest, none longer than
    128; ``cross`` lets literals run on past a row's end, as TgaRleDecode
    reads them."""
    px = [r[i:i + depth] for r in rows for i in range(0, len(r), depth)]
    per_row = len(rows[0]) // depth
    out, i = bytearray(), 0
    while i < len(px):
        row_end = (i // per_row + 1) * per_row
        limit = len(px) if cross else row_end
        j = i + 1
        while j < min(limit, row_end, i + 128) and px[j] == px[i]:
            j += 1
        if j - i >= 2:
            out += bytes([0x80 | (j - i - 1)]) + px[i]
        else:
            j = i + 1
            while j < min(limit, i + 128) and not (
                    j + 1 < limit and px[j] == px[j + 1]
                    and (j + 1) // per_row == j // per_row):
                j += 1
            out += bytes([j - i - 1]) + b"".join(px[i:j])
        i = j
    return bytes(out)


def tga_file(pixels: np.ndarray, itype: int, depth: int, *, cmap=None,
             map_depth: int = 24, map_start: int = 0, flags: int = 0,
             id_section: bytes = b"", cross: bool = False) -> bytes:
    """A TGA of (h, w, bytes a pixel) uint8 samples as stored (BGR order,
    16-bit little-endian, palette indices), rows from the bottom unless
    ``flags`` has bit 5; type ``itype`` (RLE where bit 3 is set), a
    colour map of ``map_depth`` bits from entry ``map_start``."""
    h, w, k = pixels.shape
    rows = [pixels[y].tobytes() for y in range(h)]
    if not flags & 0x20:
        rows = rows[::-1]
    if depth == 1:
        rows = [np.packbits(pixels[y, :, 0] > 0).tobytes() for y in (
            range(h) if flags & 0x20 else range(h - 1, -1, -1))]
    body = (tga_rle(rows, k, cross=cross) if itype & 8
            else b"".join(rows))
    cm = b""
    if cmap is not None:
        cm = np.asarray(cmap, np.uint8).tobytes()
    head = struct.pack("<BBBHHBHHHHBB", len(id_section), int(cmap is not None),
                       itype, map_start if cmap is not None else 0,
                       len(cm) // (map_depth // 8) if cmap is not None else 0,
                       map_depth if cmap is not None else 0, 0, 0, w, h,
                       depth, flags)
    return head + id_section + cm + body


def tga_fixtures(rng) -> dict:
    """PIL's save in modes L, LA, P, RGB and RGBA, raw and RLE, bottom-up
    and top-down, and 1 raw; the byte-level writer's 16-bit true colour
    (raw and RLE), colour maps of 16 and 24 bits from an offset entry,
    colour-mapped RLE, a grey image with a colour map, an id section,
    each horizontal flip, literals running past a row's end."""
    from PIL import Image

    img = smooth(rng, 19, 21)
    img[5:9, 3:12] = 40   # runs
    out = {}
    for mode in ("L", "LA", "P", "RGB", "RGBA"):
        src = _pil_image(img, mode) if mode != "LA" else Image.fromarray(
            np.dstack([img[..., 1], img[..., 0]]), "LA")
        for rle in (False, True):
            for orient in (-1, 1):
                buf = io.BytesIO()
                src.save(buf, "TGA", rle=rle, orientation=orient)
                name = (f"pil_{mode.lower()}_{'rle' if rle else 'raw'}"
                        f"{'_top' if orient == 1 else ''}")
                out[name] = buf.getvalue()
    buf = io.BytesIO()
    _pil_image(img, "1").save(buf, "TGA")
    out["pil_1_raw"] = buf.getvalue()
    v16 = rng.integers(0, 65536, (19, 21)).astype("<u2")
    v16[4:8] = v16[4, 0]
    p16 = v16.view(np.uint8).reshape(19, 21, 2)
    out["truecolor_16bit_raw"] = tga_file(p16, 2, 16)
    out["truecolor_16bit_rle"] = tga_file(p16, 10, 16, flags=0x20)
    idx = rng.integers(0, 40, (19, 21, 1)).astype(np.uint8)
    idx[10:12] = 7
    cm24 = rng.integers(0, 256, (36, 3))
    out["colormap_24bit_start4"] = tga_file(idx, 1, 8, cmap=cm24,
                                            map_start=4)
    cm16 = rng.integers(0, 65536, 40).astype("<u2").view(np.uint8)
    out["colormap_16bit_rle"] = tga_file(idx, 9, 8, cmap=cm16, map_depth=16)
    out["grey_with_colormap"] = tga_file(idx, 3, 8, cmap=cm24[:30],
                                         map_start=10)
    bgr = img[..., ::-1].copy()
    out["id_section_hflip"] = tga_file(bgr, 2, 24, id_section=b"port " * 9,
                                       flags=0x10)
    out["rle_hflip_top"] = tga_file(bgr, 10, 24, flags=0x30)
    out["rle_literals_cross_rows"] = tga_file(
        rng.integers(0, 256, (7, 5, 3)).astype(np.uint8), 10, 24, cross=True)
    out["grey_rle_cross_rows"] = tga_file(img[..., 1:2], 11, 8, cross=True)
    bgra = np.dstack([bgr, img[..., :1]])
    out["truecolor_32bit_rle_top"] = tga_file(bgra, 10, 32, flags=0x20)
    return out


# ---------------------------------------------------------------------------
# ICO and DIB
# ---------------------------------------------------------------------------

def dib_file(samples: np.ndarray, bits: int, **kw) -> bytes:
    """A headerless bitmap: a BMP of ``bmp_file`` without its file
    header."""
    h, w = samples.shape[:2]
    return bmp_file(bmp_rows(samples, bits), w, h, bits, **kw)[14:]


def ico_file(entries) -> bytes:
    """An ICO of (width byte, height byte, colours, bpp, image bytes)
    entries; a bitmap entry's DIB carries twice its height and the AND
    mask after its rows."""
    head = struct.pack("<HHH", 0, 1, len(entries))
    at = 6 + 16 * len(entries)
    table, body = b"", b""
    for wb, hb, colors, bpp, data in entries:
        table += struct.pack("<BBBBHHII", wb, hb, colors, 0, 1, bpp,
                             len(data), at + len(body))
        body += data
    return head + table + body


def ico_bitmap(samples: np.ndarray, bits: int, mask: np.ndarray, **kw):
    """A DIB for an ICO entry: height doubled, the rows, then the AND
    mask's 1-bit rows padded to 32 bits, bottom-up."""
    h, w = samples.shape[:2]
    rows = bmp_rows(samples, bits)
    stride = (w + 31) // 32 * 4
    m = np.packbits(mask.astype(np.uint8), axis=1)
    m = np.pad(m, ((0, 0), (0, stride - m.shape[1])))[::-1].tobytes()
    dib = bmp_file(rows + m, w, 2 * h, bits, **kw)[14:]
    return dib


def ico_fixtures(rng) -> dict:
    from PIL import Image

    img = smooth(rng, 48, 48)
    out = {}
    for fmt in ("png", "bmp"):
        buf = io.BytesIO()
        Image.fromarray(np.dstack([img, img[..., :1]])).save(
            buf, "ICO", sizes=[(16, 16), (32, 32), (48, 48)],
            bitmap_format=fmt)
        out[f"pil_{fmt}_entries"] = buf.getvalue()
    mask = rng.integers(0, 2, (32, 32))
    e = img[:32, :32]
    entries = []
    for bits, colors in ((1, 2), (4, 16), (8, 0)):
        idx = (e[..., 0] >> (8 - bits)).astype(np.uint8)
        pal = _palette(rng, 1 << bits)
        entries.append((32, 32, colors % 256, bits, ico_bitmap(
            idx, bits, mask, palette=pal)))
        out[f"bitmap_{bits}bit"] = ico_file([entries[-1]])
    bgr = e[..., ::-1]
    out["bitmap_24bit"] = ico_file([(32, 32, 0, 24, ico_bitmap(
        bgr, 24, mask))])
    bgra = np.dstack([bgr, e[..., :1]])
    out["bitmap_32bit"] = ico_file([(32, 32, 0, 32, ico_bitmap(
        bgra, 32, np.zeros_like(mask)))])
    png_buf = io.BytesIO()
    Image.fromarray(coco_source()[:256, 100:356]).save(png_buf, "PNG")
    out["png_256_beside_bitmaps"] = ico_file(
        entries + [(0, 0, 0, 32, png_buf.getvalue())])
    small = io.BytesIO()
    Image.fromarray(e[:20, :24]).save(small, "PNG")
    out["png_size_disagrees"] = ico_file([(16, 16, 0, 32,
                                           small.getvalue())])
    out["same_size_depths"] = ico_file(entries[::-1])
    return out


def dib_fixtures(rng) -> dict:
    img = smooth(rng, 13, 17)
    bgr = img[..., ::-1]
    idx = (img[..., 0] >> 4).astype(np.uint8)
    out = {}
    for header in (12, 40, 52, 56, 64, 108, 124):
        out[f"header_{header}_24bit"] = dib_file(bgr, 24, header=header)
    out["palette_4bit"] = dib_file(idx, 4, palette=_palette(rng, 16),
                                   colors=16)
    out["palette_8bit_core"] = dib_file(
        idx * 7, 8, header=12, palette=_palette(rng, 256, quad=False))
    out["bitfields_16bit"] = bmp_file(
        bmp_rows(np.frombuffer(rng.integers(0, 256, 13 * 17 * 2).astype(
            np.uint8).tobytes(), np.uint8).reshape(13, 17 * 2), 8),
        17, 13, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F))[14:]
    out["rle8"] = bmp_file(rle8(idx * 9), 17, 13, 8, compression=1,
                           palette=_palette(rng, 256), colors=256)[14:]
    out["rle4"] = bmp_file(rle4(idx), 17, 13, 4, compression=2,
                           palette=_palette(rng, 16), colors=16)[14:]
    out["top_down_32bit"] = dib_file(np.dstack([bgr, bgr[..., :1]]), 32,
                                     top_down=True)
    return out


def coco_source() -> np.ndarray:
    """The 640 x 480 (COCO's size) timing image, in integers only: two
    ramps and a checker."""
    y, x = np.mgrid[0:480, 0:640]
    r = x * 255 // 639
    g = y * 255 // 479
    b = (((x // 16) ^ (y // 16)) & 15) * 16
    return np.dstack([r, g, b]).astype(np.uint8)


def coco_fixtures(rng) -> dict:
    """chip_smoke.py's timing inputs at 640 x 480: a GIF of 64 colours,
    an LZW TIFF with predictor 2 (16-row strips), a Deflate TIFF and a
    JPEG TIFF (PIL's save). Their pixels are kept as digests
    (digests.json), not in pixels.npz."""
    from PIL import Image

    img = coco_source()
    y, x = np.mgrid[0:480, 0:640]
    idx = ((x // 20 + (y // 20) * 3) % 64).astype(np.uint8)
    pal = rng.integers(0, 256, (64, 3))
    out = {"gif/coco": gif_file(idx, global_pal=pal, min_size=6),
           "tiff/coco_lzw_pred2": tiff_file(
               img.astype(np.int64), compression=5, predictor=2,
               rows_per_strip=16)}
    for name, kw in (("coco_deflate", {"compression": "tiff_adobe_deflate"}),
                     ("coco_jpeg", {"compression": "jpeg", "quality": 90})):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "TIFF", **kw)
        out[f"tiff/{name}"] = buf.getvalue()
    return out


DAMAGED_SEED = 29
DAMAGED_HW = (72, 104)          # the small sources' size
TRAINER_CUT_HW = (480, 640)     # chip_smoke.py's trainer contents' size
TRAINER_CUT_TARGET = 512        # and its staging size (decoded at 8/8)


def _pil_jpeg(img: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _markers(data: bytes) -> list:
    """(offset, code) of each marker (FF then neither 00 nor FF)."""
    return [(i, data[i + 1]) for i in range(len(data) - 1)
            if data[i] == 0xFF and data[i + 1] not in (0x00, 0xFF)]


def _simd_differs(data: bytes, n: int) -> bool:
    """Whether libjpeg-turbo's SIMD IDCTs and its C ones (JSIMD_FORCENONE)
    give other pixels for the bytes at n/8: a damaged block's coefficients
    out of their normal range."""
    import subprocess

    from scripts import jpeg_recovery_oracle as oracle

    code = ("import sys, hashlib\nsys.path.insert(0, %r)\n"
            "from scripts import jpeg_recovery_oracle as o\n"
            "px, _ = o.decode(sys.stdin.buffer.read(), %d)\n"
            "print(None if px is None else "
            "hashlib.sha256(px.tobytes()).hexdigest())\n" % (ROOT, n))
    plain = subprocess.run([sys.executable, "-c", code], input=data,
                           capture_output=True, check=True,
                           env={**os.environ, "JSIMD_FORCENONE": "1"})
    simd, _ = oracle.decode(data, n)
    return simd is not None and plain.stdout.decode().strip() != \
        hashlib.sha256(simd.tobytes()).hexdigest()


def jpeg_damaged_fixtures() -> dict:
    """{name: bytes}: JPEGs cut short or damaged the ways libjpeg recovers
    from, from DAMAGED_SEED. Cut sequential (restart markers every two
    MCUs), progressive and arithmetic-coded files, inside a scan, a
    marker segment (a DHT or SOS between scans, a COM after the scan) and
    a marker; restart markers missing, renumbered to each of
    jpeg_resync_to_restart's actions, and stray markers inside an
    interval (an RSTn, TEM, EOI; one in arithmetic-coded data); a scan
    repeated (a bogus progression libjpeg decodes) and one breaking the
    progression's rules (refused); bytes flipped in the scans of a 4:2:0,
    a progressive and a grey file, the 4:2:0 ones chosen where libjpeg's
    SIMD and C IDCTs disagree at 2/8 and 4/8. Two of chip_smoke.py's
    trainer size (``trainer_cut_*``: a cut file with restart markers and
    a cut progressive one) too."""
    from scripts import make_jpeg_fixtures as mjf

    rng = np.random.default_rng(DAMAGED_SEED)
    h, w = DAMAGED_HW
    rst = _pil_jpeg(smooth(rng, h, w), quality=90, subsampling=2,
                    restart_marker_blocks=2)
    prog = _pil_jpeg(smooth(rng, h, w), quality=90, subsampling=2,
                     progressive=True)
    plain = _pil_jpeg(smooth(rng, h, w), quality=95, subsampling=0)
    gray = _pil_jpeg(np.ascontiguousarray(smooth(rng, h, w)[..., 1]),
                     quality=75)
    arith = mjf.libjpeg_file(smooth(rng, h, w), arith=True, restart=3,
                             sampling="2x2,1x1,1x1")
    arith_prog = mjf.libjpeg_file(smooth(rng, h, w), arith=True, scans="p")
    out = {}
    rsts = [i for i, m in _markers(rst) if 0xD0 <= m <= 0xD7]
    out["cut_seq_restart_scan"] = rst[:len(rst) * 11 // 20]
    out["cut_seq_restart_marker"] = rst[:rsts[len(rsts) // 2] + 1]
    out["cut_seq_eoi_marker"] = plain[:-1]
    com = b"\xff\xfe\x00\x40" + bytes(range(0x20, 0x5e))
    with_com = plain[:-2] + com + plain[-2:]
    out["cut_seq_com_after_scan"] = with_com[:len(with_com) - 30]
    scans = mjf.scans_of(prog)
    out["cut_prog_scan"] = prog[:(scans[3][0] + scans[3][1]) // 2]
    dht = [i for i, m in _markers(prog) if m == 0xC4 and i > scans[2][0]]
    out["cut_prog_dht"] = prog[:dht[0] + 9]
    out["cut_prog_sos"] = prog[:scans[4][0] + 7]
    out["cut_arith_scan"] = arith[:len(arith) * 3 // 5]
    out["cut_arith_prog_scan"] = arith_prog[:len(arith_prog) * 2 // 3]
    k = rsts[len(rsts) // 3]
    out["rst_missing"] = rst[:k] + rst[k + 2:]
    for name, step in (("rst_next", 1), ("rst_far", 4), ("rst_behind", -1)):
        b = bytearray(rst)
        b[k + 1] = 0xD0 + ((b[k + 1] - 0xD0 + step) & 7)
        out[name] = bytes(b)
    mid = (rsts[2] + rsts[3]) // 2
    for name, code in (("stray_rst", 0xD5), ("stray_tem", 0x01)):
        out[name] = rst[:mid] + bytes([0xFF, code]) + rst[mid:]
    at = len(plain) * 2 // 3
    out["stray_eoi"] = plain[:at] + b"\xff\xd9" + plain[at:]
    at = len(arith) // 2
    out["arith_stray_rst"] = arith[:at] + b"\xff\xd3" + arith[at:]
    a, b = scans[3]
    out["bogus_progression"] = prog[:b] + prog[a:b] + prog[b:]
    out["refused_progression"] = prog[:a + 9] + b"\x31" + prog[a + 10:]

    def flipped(data: bytes, seed: int) -> bytes:
        r = np.random.default_rng(seed)
        start = data.index(b"\xff\xda") + 10
        d = bytearray(data)
        for _ in range(3):
            d[int(r.integers(start, len(d) - 2))] ^= int(r.integers(1, 256))
        return bytes(d)

    flip_src = _pil_jpeg(smooth(rng, h, w), quality=50, subsampling=2)
    seed = DAMAGED_SEED
    for n in (2, 4):   # (not the same file twice)
        seed = next(s for s in range(seed, seed + 400)
                    if _simd_differs(flipped(flip_src, s), n))
        out[f"flip_420_simd_n{n}"] = flipped(flip_src, seed)
        seed += 1
    out["flip_prog"] = flipped(prog, DAMAGED_SEED)
    out["flip_gray"] = flipped(gray, DAMAGED_SEED + 1)
    th, tw = TRAINER_CUT_HW
    big = _pil_jpeg(smooth(rng, th, tw), quality=75, subsampling=2,
                    restart_marker_rows=1)
    out["trainer_cut_restart"] = big[:len(big) * 3 // 5]
    big = _pil_jpeg(smooth(rng, th, tw), quality=75, subsampling=2,
                    progressive=True)
    out["trainer_cut_progressive"] = big[:len(big) * 3 // 5]
    return out


def damaged_targets(name: str) -> list:
    """The staging sizes a damaged fixture is held at: one a scale n/8,
    n = 1..8, for the JAX loader's loop at the source's size; the trainer
    files at chip_smoke.py's."""
    from scripts import make_jpeg_fixtures as mjf

    if name.startswith("trainer_"):
        return [TRAINER_CUT_TARGET]
    h, w = DAMAGED_HW
    return mjf.prescale_targets(w, h)


def write_jpeg_damaged(out_dir: str) -> None:
    """The damaged JPEGs and digests.json beside them: per file PIL's
    verdict and pixels (``pil``: shape and sha256 of ``convert("RGB")``,
    null where PIL refuses the file) and the JAX loader's
    (``decode_resize_batch``, libjpeg with its fallback to PIL) at each of
    ``damaged_targets`` (``loader``: target to the sha256 of the staged
    image, null where it raises)."""
    from PIL import Image

    from mastermetastyletransfer_tpu.data.native_loader import (
        decode_resize_batch,
    )

    os.makedirs(out_dir, exist_ok=True)
    for old in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, old))
    digests = {}
    for name, data in jpeg_damaged_fixtures().items():
        path = os.path.join(out_dir, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        try:
            with Image.open(io.BytesIO(data)) as im:
                px = np.asarray(im.convert("RGB"))
            pil = {"shape": list(px.shape),
                   "sha256": hashlib.sha256(px.tobytes()).hexdigest()}
        except Exception:  # noqa: BLE001 - any refusal of PIL's
            pil = None
        loader = {}
        for target in damaged_targets(name):
            try:
                batch = decode_resize_batch([path], target)[0]
                loader[str(target)] = hashlib.sha256(
                    batch.tobytes()).hexdigest()
            except Exception:  # noqa: BLE001 - PIL's refusal, any kind
                loader[str(target)] = None
        digests[name] = {"pil": pil, "loader": loader}
    with open(os.path.join(out_dir, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(digests)} damaged JPEGs and digests.json to "
          f"{out_dir}")


# ---------------------------------------------------------------------------
# ThunderScan and CIELab TIFF, PCX, DCX and QOI
# ---------------------------------------------------------------------------

KINDS_SEED = 31


def thunder_row(values, *, kinds=("run", "d2", "d3", "raw")) -> bytes:
    """One row of 4-bit values in ThunderScan codes (tif_thunder.c): runs
    of the last pixel (a count of 1 to 63), three 2-bit deltas (-1, 0, 1;
    the skip code where fewer are left), two 3-bit deltas (-3 to 3) or a
    raw value, the first that fits among ``kinds`` taken."""
    out, last, i, n = bytearray(), 0, 0, len(values)
    while i < n:
        v = int(values[i])
        run = 0
        while i + run < n and int(values[i + run]) == last and run < 63:
            run += 1
        if "run" in kinds and run >= 2:
            out.append(run)
            i += run
            continue
        d2 = {0: 0, 1: 1, -1: 3}
        prev, codes = last, []
        for k in range(3):
            if i + k >= n or int(values[i + k]) - prev not in d2:
                break
            codes.append(d2[int(values[i + k]) - prev])
            prev = int(values[i + k])
        if "d2" in kinds and len(codes) >= 2:
            codes += [2] * (3 - len(codes))   # the skip code
            out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
            i += sum(c != 2 for c in codes)
            last = prev
            continue
        d3 = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
        codes, prev = [], last
        for k in range(2):
            if i + k >= n or int(values[i + k]) - prev not in d3:
                break
            codes.append(d3[int(values[i + k]) - prev])
            prev = int(values[i + k])
        if "d3" in kinds and codes:
            codes += [4] * (2 - len(codes))   # the skip code
            out.append(0x80 | codes[0] << 3 | codes[1])
            i += sum(c != 4 for c in codes)
            last = prev
            continue
        out.append(0xC0 | v)
        last = v
        i += 1
    return bytes(out)


def thunder_tiff(values: np.ndarray, *, rows_per_strip=None, tail=b"",
                 kinds=("run", "d2", "d3", "raw"), **kw) -> bytes:
    """A 4-bit TIFF of (h, w) values in ThunderScan compression (32809),
    each strip its rows' codes and then ``tail`` (bit-reversed for
    ``fill_order`` 2)."""
    h, w = values.shape
    rps = rows_per_strip or h
    strips = [b"".join(thunder_row(r, kinds=kinds)
                       for r in values[y:y + rps]) + tail
              for y in range(0, h, rps)]
    if kw.get("fill_order") == 2:
        strips = [b.translate(_REVERSED) for b in strips]
    return tiff_file(values[..., None].astype(np.int64), bps=4,
                     rows_per_strip=rps, tags={259: (3, [32809])},
                     chunk_hook=lambda i, b: strips[i], **kw)


def thunder_fixtures(rng) -> dict:
    """ThunderScan TIFFs: every code kind (runs up to 63, 2- and 3-bit
    deltas with their skip codes, raw values), odd widths, several strips
    of several rows, a run ending a row, bytes after a strip's last row,
    min-is-white, a 4-bit palette, FillOrder 2."""
    out = {"thunderscan_raw": thunderscan_tiff(rng)}
    v = (smooth(rng, 13, 21)[..., 0] // 16).astype(np.int64)
    v[2, :] = 9                     # a run that ends its row
    v[5, 3:17] = 4
    out["thunderscan_codes"] = thunder_tiff(v, photometric=1)
    out["thunderscan_strips_odd"] = thunder_tiff(
        v[:, :17], rows_per_strip=4, photometric=1)
    out["thunderscan_deltas_only"] = thunder_tiff(
        np.cumsum(rng.integers(-1, 2, (9, 15)), 1) % 16, photometric=1,
        kinds=("d2", "d3", "raw"))
    out["thunderscan_d3_raw"] = thunder_tiff(
        rng.integers(0, 16, (7, 11)), photometric=0, kinds=("d3", "raw"))
    out["thunderscan_long_runs"] = thunder_tiff(
        np.repeat(rng.integers(0, 16, (6, 1)), 150, 1), photometric=1)
    out["thunderscan_tail_bytes"] = thunder_tiff(
        v[:6, :9], rows_per_strip=3, photometric=1, tail=b"\xc5\x07\x41")
    cmap = rng.integers(0, 65536, (3, 16))
    out["thunderscan_palette"] = thunder_tiff(
        v[:, :19], photometric=3, colormap=cmap, rows_per_strip=5)
    out["thunderscan_fill_order2"] = thunder_tiff(
        v[:8, :7], photometric=1, fill_order=2)
    return out


def jpeg_scan_parts(jpg: bytes):
    """A baseline JPEG's header through its SOS, and its scan's entropy-
    coded segments (split at its RSTn markers, which are dropped)."""
    i = 2
    while True:
        m = jpg[i + 1]
        i += 2 + struct.unpack(">H", jpg[i + 2:i + 4])[0]
        if m == 0xDA:
            break
    head, segs, start, j = jpg[:i], [], i, i
    while j < len(jpg) - 1:   # one step a byte of the scan
        if jpg[j] == 0xFF and 0xD0 <= jpg[j + 1] <= 0xD9:
            segs.append(jpg[start:j])
            if jpg[j + 1] == 0xD9:
                break
            start = j = j + 2
            continue
        j += 1
    return head, segs


def ojpeg_file(img: np.ndarray, *, photometric: int = 6, rows_per_strip=None,
               layout: str = "whole", jpeg_kw=None, tags=None,
               jif_extra: int = 0) -> bytes:
    """An old-style JPEG TIFF (compression 6) of (h, w, 3) or (h, w)
    samples, PIL's JPEG of them in its JPEGInterchangeFormat (tags 513 and
    514, the JPEG placed after the directory), its strips by ``layout``:
    "whole" each strip the whole JPEG again, "split" the interchange
    format the JPEG's header through SOS and each strip one of its
    restart intervals' data (markers dropped: libtiff writes its own),
    "whole_split" the whole JPEG and the intervals. ``jif_extra`` is
    added to the length tag."""
    from PIL import Image

    h, w = img.shape[:2]
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, "JPEG", **(jpeg_kw or {}))
    jpg = buf.getvalue()
    head, segs = jpeg_scan_parts(jpg)
    jif, strips = {"whole": (jpg, [jpg] * -(-h // (rows_per_strip or h))),
                   "split": (head, segs),
                   "whole_split": (jpg, segs)}[layout]
    samples = np.zeros((h, w, 3 if img.ndim == 3 else 1), np.int64)

    def build(at):
        t = {259: (3, [6]), 513: (4, [at]),
             514: (4, [len(jif) + jif_extra])}
        t.update(tags or {})
        return tiff_file(samples, photometric=photometric,
                         rows_per_strip=rows_per_strip, tags=t,
                         chunk_hook=lambda i, b: strips[i] if i < len(
                             strips) else b"\0")
    return build(len(build(0))) + jif


def ojpeg_fixtures(rng) -> dict:
    """Old-style JPEG TIFFs with a JPEGInterchangeFormat: the whole JPEG
    in it and in the strip; its header in it and each strip a restart
    interval's data (libtiff's own RSTn between them), at 4:2:0, 4:2:2 and
    4:4:4; the whole JPEG and the intervals; grey in strips; photometric
    RGB (taken for YCbCr); a YCbCrSubsampling tag the JPEG overrides; a
    length past the file's end; and strips of two intervals each with one
    given, whose second strip libjpeg fails on (its restart marker)."""
    img = smooth(rng, 45, 37)
    rst = {"restart_marker_rows": 1}
    out = {"ojpeg_whole": ojpeg_file(img),
           "ojpeg_split_420": ojpeg_file(img, rows_per_strip=16,
                                         layout="split", jpeg_kw=rst),
           "ojpeg_split_422": ojpeg_file(
               img, rows_per_strip=8, layout="split",
               jpeg_kw={**rst, "subsampling": 1}),
           "ojpeg_split_444": ojpeg_file(
               img, rows_per_strip=8, layout="split",
               jpeg_kw={**rst, "subsampling": 0}),
           "ojpeg_whole_split": ojpeg_file(img, rows_per_strip=16,
                                           layout="whole_split", jpeg_kw=rst),
           "ojpeg_grey_split": ojpeg_file(img[..., 1], photometric=1,
                                          rows_per_strip=8, layout="split",
                                          jpeg_kw=rst),
           "ojpeg_photometric_rgb": ojpeg_file(img[:21, :30],
                                               photometric=2),
           "ojpeg_subsampling_tag_21": ojpeg_file(
               img, tags={530: (3, [2, 1])}),
           "ojpeg_length_past_end": ojpeg_file(img[:9, :13], jif_extra=999),
           "ojpeg_strip_fails": ojpeg_file(img, rows_per_strip=32,
                                           layout="split", jpeg_kw=rst),
           "ojpeg_fixture": ojpeg_tiff(rng)}
    return out


def cielab_fixtures(rng) -> dict:
    """CIELab TIFFs (photometric 8, 8-bit L, a, b): chunky and planar,
    raw, LZW, PackBits and Deflate, strips and tiles, an orientation,
    and a ramp over a and b at three lightnesses."""
    img = smooth(rng, 23, 29).astype(np.int64)
    out = {"cielab_raw": tiff_file(img, photometric=8),
           "cielab_planar_raw": tiff_file(img, photometric=8, planar=2),
           "cielab_lzw_strips": tiff_file(img, photometric=8, compression=5,
                                          rows_per_strip=5),
           "cielab_packbits": tiff_file(img, photometric=8,
                                        compression=32773),
           "cielab_planar_deflate": tiff_file(img, photometric=8,
                                              compression=8, planar=2,
                                              rows_per_strip=7),
           "cielab_tiles_lzw": tiff_file(img, photometric=8, compression=5,
                                         tile=(16, 16)),
           "cielab_orientation_6": tiff_file(img, photometric=8,
                                             orientation=6)}
    a, b = np.meshgrid(np.arange(0, 256, 8), np.arange(0, 256, 8),
                       indexing="ij")
    ramp = np.concatenate([np.dstack([np.full_like(a, v), a, b])
                           for v in (0, 128, 255)], 1)
    out["cielab_ab_ramp"] = tiff_file(ramp, photometric=8, compression=5)
    return out


def pcx_rle(rows: np.ndarray, *, zero_runs: bool = False) -> bytes:
    """PCX's run-length packets of (h, bytes) rows: runs of 2 to 63 equal
    bytes, and single bytes of 0xC0 and above, as a count byte and the
    value, the rest literal; no run crosses a row's end. ``zero_runs``
    puts an empty run (0xC0, 0) before each row."""
    out = bytearray()
    for row in rows:
        if zero_runs:
            out += b"\xc0\x00"
        i, n = 0, len(row)
        while i < n:
            k = 1
            while i + k < n and row[i + k] == row[i] and k < 63:
                k += 1
            if k > 1 or row[i] >= 0xC0:
                out += bytes([0xC0 | k, row[i]])
            else:
                out.append(row[i])
            i += k
    return bytes(out)


def pcx_planes(planes: list, stride: int) -> np.ndarray:
    """(h, planes x stride) rows of a PCX: each plane's (h, bytes) rows
    padded to ``stride`` bytes, one after another."""
    h = planes[0].shape[0]
    out = np.zeros((h, len(planes) * stride), np.uint8)
    for k, p in enumerate(planes):
        out[:, k * stride:k * stride + p.shape[1]] = p
    return out


def pcx_file(rows: np.ndarray, width: int, *, version: int = 5,
             bits: int = 8, planes: int = 1, stride=None, origin=(0, 0),
             palette16: bytes = bytes(48), palette256=None, tail: bytes = b"",
             zero_runs: bool = False, body=None) -> bytes:
    """A PCX of (h, planes x stride) rows (``pcx_planes``): its 128-byte
    header (the bounding box from ``origin``, ``stride`` the header's
    bytes a plane's row, by default the rows' own), the rows' packets (or
    ``body``), ``tail``, then a 256-colour palette (12 and 768 bytes)."""
    h = rows.shape[0]
    x0, y0 = origin
    field = rows.shape[1] // planes if stride is None else stride
    head = struct.pack("<BBBBHHHHHH48sBBHHHH54s", 10, version, 1, bits, x0,
                       y0, x0 + width - 1, y0 + h - 1, 72, 72, palette16, 0,
                       planes, field, 1, width, h, bytes(54))
    data = head + (pcx_rle(rows, zero_runs=zero_runs) if body is None
                   else body) + tail
    if palette256 is not None:
        data += b"\x0c" + bytes(np.asarray(palette256, np.uint8).reshape(-1))
    return data


def _bitplanes(idx: np.ndarray, n: int) -> list:
    return [np.packbits((idx >> k) & 1, axis=1) for k in range(n)]


def pcx_fixtures(rng) -> dict:
    """PIL's save in modes 1, L, P and RGB, and the byte-level writer's
    1-bit files of versions 0 and 2, 2 and 4 bit planes (a width of 3,
    whose planes Pillow's decoder moves, and a header stride Pillow pads),
    8-bit grey without a palette, with a grey ramp and with a palette
    whose marker is not 12, a 256-colour palette, RGB at odd widths with
    the header's stride kept, padded and given otherwise, a bounding box
    away from the origin, empty runs, bytes after the last row."""
    from PIL import Image

    img = smooth(rng, 23, 37)
    out = {}
    for mode in ("1", "L", "P", "RGB"):
        buf = io.BytesIO()
        _pil_image(img, mode).save(buf, "PCX")
        out[f"pil_{mode.lower()}"] = buf.getvalue()
    grey = img[..., 1]
    pal16 = bytes(rng.integers(0, 256, 48, dtype=np.uint8))
    for version in (0, 2):
        bits = np.packbits(grey[:, :21] > 120, axis=1)
        out[f"mono_version{version}"] = pcx_file(
            pcx_planes([bits], 4), 21, version=version, bits=1)
    for n, w in ((2, 13), (4, 21), (4, 3)):
        idx = (img[..., 0][:, :w] // (256 >> n)).astype(np.uint8)
        stride = (w + 7) // 8
        stride += stride % 2
        out[f"planes{n}_1bit_w{w}"] = pcx_file(
            pcx_planes(_bitplanes(idx, n), stride), w, bits=1, planes=n,
            palette16=pal16)
    idx = (img[..., 2][:, :11] // 16).astype(np.uint8)
    out["planes4_stride_kept_odd"] = pcx_file(
        pcx_planes(_bitplanes(idx, 4), 2), 11, bits=1, planes=4,
        palette16=pal16, stride=1)
    out["grey_no_palette"] = pcx_file(pcx_planes([grey[:, :30]], 30), 30)
    ramp = np.repeat(np.arange(256, dtype=np.uint8), 3)
    out["grey_ramp_palette"] = pcx_file(pcx_planes([grey], 38), 37,
                                        palette256=ramp)
    pal = rng.integers(0, 256, 768, dtype=np.uint8)
    out["palette_256"] = pcx_file(pcx_planes([grey], 38), 37, palette256=pal)
    body = pcx_file(pcx_planes([grey], 38), 37)
    out["palette_marker_not_12"] = body + b"\x0b" + bytes(pal)
    rgb = [img[..., k][:, :9] for k in range(3)]
    out["rgb_w9_padded"] = pcx_file(pcx_planes(rgb, 10), 9, planes=3)
    out["rgb_w9_stride_kept"] = pcx_file(pcx_planes(rgb, 9), 9, planes=3)
    out["rgb_w9_stride_other"] = pcx_file(pcx_planes(rgb, 10), 9, planes=3,
                                          stride=50)
    out["rgb_origin_5_3"] = pcx_file(
        pcx_planes([img[..., k] for k in range(3)], 38), 37, planes=3,
        origin=(5, 3))
    out["grey_zero_runs_tail"] = pcx_file(
        pcx_planes([grey[:9]], 38), 37, zero_runs=True, tail=b"\xc5\x01\x02")
    return out


def dcx_file(pages: list, *, order=None) -> bytes:
    """A DCX of PCX ``pages``: the magic, the page table ended by a 0,
    then the pages (in ``order``, the table still in page order)."""
    order = list(range(len(pages))) if order is None else order
    at = 4 + 4 * (len(pages) + 1)
    offsets, body = [0] * len(pages), b""
    for k in order:
        offsets[k] = at + len(body)
        body += pages[k]
    return struct.pack(f"<I{len(pages) + 1}I", 0x3ADE68B1, *offsets,
                       0) + body


def dcx_fixtures(rng) -> dict:
    """DCX files: one page, two pages (the first RGB, the second grey),
    pages stored out of order, and a first page of 256 colours whose
    palette Pillow looks for at the end of the whole file."""
    img = smooth(rng, 17, 25)
    grey = img[..., 1]
    rgb = pcx_file(pcx_planes([img[..., k] for k in range(3)], 26), 25,
                   planes=3)
    mono = pcx_file(pcx_planes([grey], 26), 25)
    pal = rng.integers(0, 256, 768, dtype=np.uint8)
    return {"one_page": dcx_file([rgb]),
            "two_pages": dcx_file([rgb, mono]),
            "pages_out_of_order": dcx_file([mono, rgb], order=[1, 0]),
            "palette_at_file_end": dcx_file([mono, pcx_file(
                pcx_planes([grey[:5]], 26), 25, palette256=pal)])}


def qoi_file(width: int, height: int, ops: bytes, channels: int = 4, *,
             end: bool = True) -> bytes:
    """A QOI: the 14-byte header, ``ops``, and the end marker."""
    return (b"qoif" + struct.pack(">IIBB", width, height, channels, 0) + ops
            + (b"\0" * 7 + b"\1" if end else b""))


def qoi_fixtures(rng) -> dict:
    """PIL's save in RGB and RGBA, and ops written byte by byte: an index
    op at an empty slot, a run first (of the starting pixel, which Pillow
    does not store), a run past the last pixel, a channels byte of 7
    (RGBA), differences and luma that wrap, no end marker."""
    from PIL import Image

    img = smooth(rng, 19, 27)
    img[4:9, 2:20] = (10, 200, 30)   # runs and repeats
    alpha = (np.arange(27)[None, :] * 9 + np.arange(19)[:, None] * 5) % 256
    out = {}
    for mode, px in (("rgb", img), ("rgba", np.dstack([img, alpha]))):
        buf = io.BytesIO()
        Image.fromarray(px.astype(np.uint8)).save(buf, "QOI")
        out[f"pil_{mode}"] = buf.getvalue()
    ops = bytes([0xC2, 0x05, 0xFE, 250, 3, 128, 0x7F, 0x40, 0x80 | 63,
                 0xFF, 7, 80, 160, 9, 0x35, 0x9F, 0x0F, 0xC7, 0x35,
                 0xFE, 1, 2, 3, 0x00, 0x3F])
    out["ops_every_kind"] = qoi_file(5, 4, ops, 4)
    out["ops_rgb_channels"] = qoi_file(5, 4, ops, 3)
    out["channels_7"] = qoi_file(5, 4, ops, 7)
    out["run_past_the_end"] = qoi_file(3, 2, bytes([0xFE, 9, 9, 9, 0xFD]))
    out["no_end_marker"] = qoi_file(2, 2, bytes([0xFF, 1, 2, 3, 4, 0xC2]),
                                    end=False)
    return out


def coco_kinds_fixtures() -> dict:
    """chip_smoke.py's timing inputs of these kinds at 640 x 480: a
    ThunderScan TIFF (a banded page's 16 grey levels), a CIELab TIFF
    (LZW), an old-style JPEG TIFF (strips of one restart interval, 4:2:0,
    quality 90), an RGB PCX, a DCX of it and a QOI (``coco_poster``'s
    bands; PIL's save for the PCX and the QOI)."""
    from PIL import Image

    img = coco_poster()
    grey = (img.astype(np.int64).sum(2) // 3) // 16
    lab = img.astype(np.int64)
    out = {"tiff/coco_thunderscan": thunder_tiff(grey, rows_per_strip=32,
                                                 photometric=1),
           "tiff/coco_cielab": tiff_file(lab, photometric=8, compression=5,
                                         rows_per_strip=16),
           "tiff/coco_ojpeg": ojpeg_file(
               coco_source(), rows_per_strip=16, layout="split",
               jpeg_kw={"quality": 90, "restart_marker_rows": 1})}
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PCX")
    out["pcx/coco"] = buf.getvalue()
    out["dcx/coco"] = dcx_file([buf.getvalue()])
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "QOI")
    out["qoi/coco"] = buf.getvalue()
    return out


EXTENSIONS = {"pnm": "pnm", "gif": "gif", "tiff": "tif", "ico": "ico",
              "dib": "dib", "tga": "tga", "tiff_ccitt": "tif", "pcx": "pcx",
              "dcx": "dcx", "qoi": "qoi"}


def all_fixtures() -> dict:
    """{kind: {name: bytes}}, every file of every kind, from SEED."""
    rng = np.random.default_rng(SEED)
    out = {"pnm": pnm_fixtures(rng), "gif": gif_fixtures(rng),
           "tiff": tiff_fixtures(rng), "ico": ico_fixtures(rng),
           "dib": dib_fixtures(rng)}
    for key, data in coco_fixtures(rng).items():
        kind, name = key.split("/")
        out[kind][name] = data
    rng = np.random.default_rng(CODECS_SEED)
    # the CCITT files apart: a T.6 strip that ends early leaves rows of
    # Pillow's strip buffer unwritten, which a damaged copy's pixels show
    out["tiff_ccitt"] = {}
    for name, data in codec_tiff_fixtures(rng).items():
        out["tiff_ccitt" if name.startswith("ccitt_") else "tiff"][name] = data
    out["tga"] = tga_fixtures(rng)
    for key, data in coco_codec_fixtures().items():
        kind, name = key.split("/")
        out[kind][name] = data
    rng = np.random.default_rng(KINDS_SEED)
    out["tiff"].update(thunder_fixtures(rng))
    out["tiff"].update(cielab_fixtures(rng))
    out["tiff"].update(ojpeg_fixtures(rng))
    out["pcx"] = pcx_fixtures(rng)
    out["dcx"] = dcx_fixtures(rng)
    out["qoi"] = qoi_fixtures(rng)
    for key, data in coco_kinds_fixtures().items():
        kind, name = key.split("/")
        out[kind][name] = data
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data"))
    args = ap.parse_args(argv)
    from PIL import Image

    write_jpeg_damaged(os.path.join(args.out, "jpeg_damaged"))
    for kind, files in all_fixtures().items():
        d = os.path.join(args.out, kind)
        os.makedirs(d, exist_ok=True)
        for old in os.listdir(d):
            os.remove(os.path.join(d, old))
        pixels, digests = {}, {}
        for name, data in files.items():
            with open(os.path.join(d, f"{name}.{EXTENSIONS[kind]}"),
                      "wb") as f:
                f.write(data)
            with Image.open(io.BytesIO(data)) as im:
                px = np.asarray(im.convert("RGB"))
            if name.startswith("coco"):
                digests[name] = {"shape": list(px.shape),
                                 "sha256": hashlib.sha256(
                                     px.tobytes()).hexdigest()}
            else:
                pixels[name] = px
        np.savez_compressed(os.path.join(d, "pixels.npz"), **pixels)
        if digests:
            with open(os.path.join(d, "digests.json"), "w") as f:
                json.dump(digests, f, indent=1, sort_keys=True)
                f.write("\n")
        print(f"wrote {len(files)} {kind.upper()} files and pixels.npz "
              f"to {d}")


if __name__ == "__main__":
    main()
