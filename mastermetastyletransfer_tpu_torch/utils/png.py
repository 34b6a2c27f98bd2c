"""The port's PNG reader and writer, with the standard library and numpy
(the machine with the card has no PIL).

``read_png`` reads every PNG that PIL's ``convert("RGB")`` reads, bit for
bit: colour type 0 (grey) at 1, 2, 4, 8 and 16 bits, 2 (RGB) at 8 and 16,
3 (palette) at 1, 2, 4 and 8, 4 (grey + alpha) and 6 (RGBA) at 8 and 16,
non-interlaced or Adam7, all five row filters. PIL's conversions are kept:
the alpha channel and any tRNS chunk are dropped, grey is replicated (1-bit
as 0 or 255, 2- and 4-bit scaled by 85 and 17), a palette is looked up
(padded with black past its entries), 16-bit grey ("I;16") clips at 255
and the other 16-bit kinds keep their high byte. Another depth or colour
type, a filter method other than 0, and a file above PIL's
decompression-bomb limit (``MAX_PIXELS``) raise ``ValueError``, the last
before its image data is inflated. The chunks are read as Pillow reads
them: those before the image data with their CRCs checked, the IDAT
chunks unchecked until the image is whole, and what follows only as far
as load_end reads it, so that a file Pillow decodes with a damaged
ending is decoded too.
``png_bytes`` writes 8-bit RGB; the trainer's dumps go through it.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CID = re.compile(rb"\w\w\w\w")   # PngImagePlugin.is_cid
# colour type -> channels in the image data
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# colour type -> the bit depths PIL reads it at (PngImagePlugin._MODES)
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# PIL refuses an image above twice Image.MAX_IMAGE_PIXELS as a
# decompression bomb; so do the port's readers (native/jpeg.cpp's kMaxPixels)
MAX_PIXELS = 2 * 89_478_485


class OpenRefusal(ValueError):
    """A refusal where Pillow's plugin fails in its ``_open`` with one of
    the exceptions ``Image.open`` passes over (SyntaxError, IndexError,
    TypeError, struct.error; KeyError and EOFError, which ImageFile turns
    into SyntaxError): Pillow then tries its next plugin, and so does
    ``data.pipeline.decode_image``. Every other refusal is the verdict."""


def _chunks(data: bytes):
    """(kind, body) of each chunk before the first IDAT, its CRC checked,
    as PngImageFile._open reads them; then ("IDAT", position of its
    header)."""
    pos = len(_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise OpenRefusal("PNG: truncated chunk")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if not _CID.match(kind):
            raise OpenRefusal(f"PNG: broken chunk {kind!r}")
        if kind in (b"IDAT", b"IEND"):   # IEND: Pillow's _open stops there
            yield kind, pos
            return
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("PNG: truncated chunk")
        if pos + 12 + n > len(data):
            raise OpenRefusal("PNG: truncated chunk (its checksum)")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise OpenRefusal(f"PNG: bad CRC in chunk {kind!r}")
        yield kind, body
        pos += 12 + n


def _image_data(data: bytes, pos: int, need: int) -> bytes:
    """The first ``need`` inflated bytes of the IDAT chunks from the one
    whose header is at ``pos``, read as Pillow reads them
    (PngImageFile.load_read, ImageFile.load): 64 KiB pieces of each chunk,
    each inflated in turn, until the image is whole; the IDAT chunks'
    CRCs are not checked. A chunk that is not IDAT, or the file's end,
    before then is a truncated image. Once the image is whole, what
    follows is read as load_end reads it: chunk headers from where the
    last piece ended, each chunk's body skipped, until IEND or a header
    that is not one; only a body that runs past the file's end is an
    error."""
    inflater = zlib.decompressobj()
    parts, got = [], 0
    at, left = pos + 8, int.from_bytes(data[pos:pos + 4], "big")
    while got < need:
        if left == 0:   # the next chunk's header, its CRC skipped
            at += 4
            if data[at + 4:at + 8] != b"IDAT":
                raise ValueError("PNG: truncated image data")
            left = int.from_bytes(data[at:at + 4], "big")
            at += 8
            continue
        piece = data[at:at + min(left, 65536)]
        if not piece:
            raise ValueError("PNG: truncated image data")
        at, left = at + len(piece), left - len(piece)
        try:
            out = inflater.decompress(piece, need - got)
        except zlib.error as e:
            raise ValueError(f"PNG: bad image data ({e})") from None
        parts.append(out)
        got += len(out)
    while True:   # load_end
        at += 4
        head = data[at:at + 8]
        if len(head) < 8 or not _CID.match(head[4:]) or head[4:] == b"IEND":
            break
        n = int.from_bytes(head[:4], "big")
        at += 8 + n
        if at > len(data):
            raise ValueError(f"PNG: truncated chunk {head[4:]!r}")
    return b"".join(parts)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2) of (h, 1 + stride) bytes:
    0 none, 1 Sub, 2 Up, 3 Average, 4 Paeth, every row by its own. Rows
    of the first three only (what ``png_bytes`` and most writers give)
    are undone a row at a time, the others by ``_unfilter_sweep``."""
    kinds = raw[:, 0].astype(np.int32)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {int(kinds.max())}")
    w = stride // bpp
    filt = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if (kinds >= 3).any():
        return _unfilter_sweep(filt, kinds)
    return _unfilter_rows(filt, kinds)


def _unfilter_rows(filt: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """None, Sub and Up rows of (h, w, bpp) filtered bytes: each row is its
    bytes, their cumulative sum (Sub) or the row above plus them (Up), a
    row at a time (h steps). The http phase of chip_smoke.py times it
    against ``_unfilter_sweep`` on its PNG body (PERF.md)."""
    h, w, bpp = filt.shape
    out = np.zeros((h + 1, w, bpp), np.int32)   # a zero row above
    for r in range(h):
        f = filt[r]
        row = (f + out[r] if kinds[r] == 2 else
               np.cumsum(f, axis=0) if kinds[r] == 1 else f)
        out[r + 1] = row & 0xFF
    return out[1:].astype(np.uint8)


def _unfilter_sweep(filt: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Rows of any filter in (h, w, bpp) filtered bytes. Each reconstructed
    byte depends on its left, upper and upper-left neighbours, so the bytes
    are rebuilt an anti-diagonal of pixels at a time (h + w - 1 steps,
    each vectorized)."""
    h, w, bpp = filt.shape
    out = np.zeros((h + 1, w + 1, bpp), np.int32)   # a zero row and column
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(d, h - 1) + 1)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        k = kinds[r][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def _passes(w: int, h: int, interlace: bool):
    """(x0, y0, dx, dy, pass width, pass height) of each non-empty pass:
    the whole image, or Adam7's seven (PNG spec 8.2)."""
    out = []
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def _samples(rows: np.ndarray, pw: int, depth: int,
             channels: int) -> np.ndarray:
    """A pass's unfiltered rows (ph, row bytes) as (ph, pw, channels)
    samples: packed 1-, 2- and 4-bit ones unpacked from each byte's high
    bits down, 16-bit ones big-endian."""
    ph = rows.shape[0]
    if depth == 16:
        return (rows.reshape(ph, pw, channels, 2).astype(np.uint16)
                @ np.array([256, 1], np.uint16))
    if depth == 8:
        return rows.reshape(ph, pw, channels)
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(ph, -1)[:, :pw, None]


def _to_rgb(px: np.ndarray, depth: int, ctype: int, palette) -> np.ndarray:
    """PIL's convert("RGB") of the image's samples (H, W, channels)."""
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        full = np.zeros((256, 3), np.uint8)   # PIL pads the palette with 0
        full[:len(palette)] = palette[:256]
        return full[px[:, :, 0]]
    if depth == 16:
        # "I;16" clips to 255; LA;16B, RGB;16B, RGBA;16B keep the high byte
        px = (np.minimum(px, 255) if ctype == 0 else px >> 8).astype(np.uint8)
    elif depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))  # 1: 255, 2: 85, 4: 17
    if ctype in (0, 4):
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def read_png(data: bytes) -> np.ndarray:
    """A PNG's pixels as uint8 (H, W, 3) RGB, as PIL's convert("RGB")
    gives them."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG (no signature)")
    header, palette, idat = None, None, 0
    for kind, body in _chunks(data):
        if kind == b"IEND":
            if header is None:
                break
            raise ValueError("PNG: no image data")
        if kind == b"IHDR":
            if len(body) < 13:
                raise ValueError("PNG: truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3],
                                    np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat = body
    if header is None:
        raise OpenRefusal("PNG: no IHDR chunk")
    w, h, depth, ctype, _, filt, interlace = header
    if ctype not in _CHANNELS:
        raise OpenRefusal(f"PNG: unknown colour type {ctype}")
    if depth not in _DEPTHS[ctype]:
        raise OpenRefusal(f"PNG: colour type {ctype} at {depth} bits is not "
                          "read")
    if filt:
        raise OpenRefusal(f"PNG: unknown filter method {filt}")
    if w * h > MAX_PIXELS:
        raise ValueError(f"PNG of {w}x{h} pixels is above the limit of "
                         f"{MAX_PIXELS} (a decompression bomb)")
    channels = _CHANNELS[ctype]
    bits = depth * channels
    passes = _passes(w, h, bool(interlace))
    need = sum(ph * (1 + (pw * bits + 7) // 8)
               for *_, pw, ph in passes)
    raw = np.frombuffer(_image_data(data, idat, need), np.uint8)
    px = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy, pw, ph in passes:
        stride = (pw * bits + 7) // 8
        rows = raw[at:at + ph * (stride + 1)].reshape(ph, stride + 1)
        at += ph * (stride + 1)
        # the filters' byte step: a pixel's bytes, at least 1
        bpp = max(bits // 8, 1)
        rows = _unfilter(rows, ph, stride, bpp).reshape(ph, stride)
        px[y0::dy, x0::dx] = _samples(rows, pw, depth, channels)
    return _to_rgb(px, depth, ctype, palette)


def png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of uint8 (H, W, 3): filter 0 on every row, one
    IDAT, zlib's default compression."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)], 1)
    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def save_png(path: str, img01: np.ndarray) -> None:
    """A float RGB image in [0, 1] as an 8-bit PNG (values scaled by 255,
    clipped, truncated, as the JAX package quantizes them for PIL)."""
    with open(path, "wb") as f:
        f.write(png_bytes(np.clip(img01 * 255, 0, 255).astype(np.uint8)))
