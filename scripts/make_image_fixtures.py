"""Write the PNG and BMP fixtures under tests/data/png/ and tests/data/bmp/
with numpy and zlib, and PIL's decoded pixels beside them (pixels.npz in
each, compressed), from a fixed seed.

    python scripts/make_image_fixtures.py [--out tests/data]

PIL writes no Adam7 PNG, no 1-, 2-, 4- or 16-bit PNG of most colour types
and no RLE, 16-bit, bitfield, core-header or top-down BMP; ``png_file``
and ``bmp_file`` below write every kind that PIL reads (numpy and zlib
alone: chip_smoke.py writes its trainer phase's PNG and BMP files with
them on the machine with the card). chip_smoke.py's
``codecs`` phase holds the port's readers to the stored pixels on the
machine with the card, which has no PIL; the CPU tests
(tests/test_torch_codecs.py) check that PIL still decodes each file to
them. One file per reader route: PNG grey at 1, 2, 4 and 16 bits, palette
at 1, 2 and 4, 16-bit grey + alpha, RGB and RGBA, Adam7 at 8 and 16 bits;
BMP palettes at 1, 4 and 8 bits (core and INFO headers), RLE8 and RLE4
(with deltas, absolute runs and an early end of line), 16-bit 5-5-5 and
5-6-5 bit fields, 32-bit bit fields, V4 and V5 headers, top-down rows.
"""

from __future__ import annotations

import argparse
import io
import os
import struct
import zlib

import numpy as np

SEED = 30
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """PNG row filters (spec 9.2) of (h, row bytes), row r by kinds[r]."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for r, row in enumerate(rows.astype(np.int64)):
        k = int(kinds[r])
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if k == 1:
            f = row - left
        elif k == 2:
            f = row - prev
        elif k == 3:
            f = row - (left + prev) // 2
        elif k == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            f = row - np.where((pa <= pb) & (pa <= pc), left,
                               np.where(pb <= pc, prev, upleft))
        else:
            f = row
        out.append(bytes([k]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, channels) samples as (h, row bytes): packed from each byte's
    high bits down below 8 bits, big-endian at 16."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, -1).astype(np.uint8)
    per = 8 // depth
    pad = -flat.shape[1] % per
    flat = np.pad(flat, ((0, 0), (0, pad))).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return np.bitwise_or.reduce(flat << shifts, axis=2).astype(np.uint8)


def png_file(samples: np.ndarray, depth: int, ctype: int, *,
             palette: bytes = None, interlace: bool = False,
             seed: int = 0) -> bytes:
    """A PNG of (H, W, channels) samples at ``depth`` bits, colour type
    ``ctype``, rows filtered by a seeded draw of the five filters,
    non-interlaced or Adam7."""
    h, w = samples.shape[:2]
    samples = samples.reshape(h, w, -1)
    bits = depth * _CHANNELS[ctype]
    bpp = max(bits // 8, 1)
    rng = np.random.default_rng(seed)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub, depth)
        data += _filter_rows(rows, bpp, rng.integers(0, 5, rows.shape[0]))
    out = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def bmp_file(pixels: bytes, w: int, h: int, bits: int, *,
             header: int = 40, compression: int = 0, palette: bytes = b"",
             colors: int = 0, masks=None, top_down: bool = False) -> bytes:
    """A BMP of ``pixels`` (its rows, already in the file's order and
    padding, or RLE data) behind a ``header``-byte header (12: OS/2 core,
    40: INFO, 52, 56, 64, 108: V4, 124: V5); ``masks`` (r, g, b[, a]) for
    BI_BITFIELDS, after a 40-byte header or inside a longer one."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, compression, len(pixels), 2835, 2835,
                           colors, 0)
        extra = b""
        if masks is not None:
            extra = struct.pack(f"<{len(masks)}I", *masks)
        if header == 40:
            info += extra
        else:
            info = (info + extra).ljust(header, b"\0")
    offset = 14 + len(info) + len(palette)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + info + palette + pixels)


def bmp_rows(samples: np.ndarray, bits: int, top_down: bool = False) -> bytes:
    """Rows of (H, W[, bytes]) samples for a BMP: packed like PNG's below
    8 bits (indices), bottom-up unless top_down, each padded to 4 bytes."""
    h = samples.shape[0]
    rows = _pack(samples.reshape(h, samples.shape[1], -1), bits) \
        if bits < 8 else samples.reshape(h, -1).astype(np.uint8)
    stride = (rows.shape[1] + 3) // 4 * 4
    rows = np.pad(rows, ((0, 0), (0, stride - rows.shape[1])))
    return (rows if top_down else rows[::-1]).tobytes()


def rle8(idx: np.ndarray) -> bytes:
    """RLE8 data of (H, W) indices, bottom-up: runs of equal indices as
    encoded runs, an absolute run where a row's indices all differ for a
    stretch, end of line, end of bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        x = 0
        while x < len(row):
            n = 1
            while x + n < len(row) and row[x + n] == row[x] and n < 255:
                n += 1
            if n >= 2 or len(row) - x < 3:
                out += bytes([n, row[x]])
                x += n
                continue
            m = 3   # an absolute run: at least 3 pixels
            while (x + m < len(row) and m < 255
                   and row[x + m] != row[x + m - 1]):
                m += 1
            out += bytes([0, m]) + bytes(row[x:x + m].tolist())
            if m % 2:
                out += b"\0"
            x += m
        out += b"\0\0"
    return bytes(out + b"\0\1")


def rle4(idx: np.ndarray) -> bytes:
    """RLE4 data of (H, W) 4-bit indices, bottom-up, encoded runs of one
    or two alternating indices, end of line, end of bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        x = 0
        while x < len(row):
            n = min(len(row) - x, 1 + int(row[x]) % 7)
            a, b = int(row[x]), int(row[x + 1]) if n > 1 else 0
            out += bytes([n, a << 4 | b])
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _palette(rng, n: int, quad: bool = True) -> bytes:
    cols = rng.integers(0, 256, (n, 3), np.uint8)
    if not quad:
        return cols.tobytes()
    return np.concatenate([cols, np.zeros((n, 1), np.uint8)], 1).tobytes()


def _smooth(rng, h: int, w: int) -> np.ndarray:
    from PIL import Image

    base = rng.integers(0, 256, (max(h // 8, 2), max(w // 8, 2), 3),
                        np.uint8)
    return np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR))


def png_fixtures() -> dict:
    rng = np.random.default_rng(SEED)
    img = _smooth(rng, 29, 37)
    grey = img[:, :, 1]
    out = {}
    for d in (1, 2, 4):
        out[f"grey_{d}bit"] = png_file(grey >> (8 - d), d, 0, seed=d)
        out[f"palette_{d}bit"] = png_file(
            grey >> (8 - d), d, 3, palette=_palette(rng, 1 << d, False),
            seed=d + 10)
    g16 = grey.astype(np.uint16) * 13 + rng.integers(0, 13, grey.shape)
    out["grey_16bit"] = png_file(g16, 16, 0, seed=20)
    px16 = img.astype(np.uint16) * 257 + rng.integers(0, 257, img.shape)
    out["grey_alpha_16bit"] = png_file(
        np.dstack([g16 * 20, px16[:, :, 2]]), 16, 4, seed=21)
    out["rgb_16bit"] = png_file(px16, 16, 2, seed=22)
    out["rgba_16bit"] = png_file(np.dstack([px16, px16[:, :, :1]]), 16, 6,
                                 seed=23)
    out["adam7_rgb"] = png_file(img, 8, 2, interlace=True, seed=24)
    out["adam7_palette_2bit"] = png_file(
        grey >> 6, 2, 3, palette=_palette(rng, 4, False), interlace=True,
        seed=25)
    out["adam7_rgba_16bit"] = png_file(np.dstack([px16, px16[:, :, :1]]),
                                       16, 6, interlace=True, seed=26)
    return out


def bmp_fixtures() -> dict:
    rng = np.random.default_rng(SEED + 1)
    h, w = 23, 29
    img = _smooth(rng, h, w)
    idx8 = (img[:, :, 0] // 4).astype(np.uint8)
    idx4 = idx8 // 4
    idx1 = (idx8 > 32).astype(np.uint8)
    out = {
        "palette_1bit": bmp_file(bmp_rows(idx1, 1), w, h, 1,
                                 palette=_palette(rng, 2)),
        "palette_4bit": bmp_file(bmp_rows(idx4, 4), w, h, 4,
                                 palette=_palette(rng, 16)),
        "palette_8bit": bmp_file(bmp_rows(idx8, 8), w, h, 8,
                                 palette=_palette(rng, 64), colors=64),
        "core_palette_8bit": bmp_file(bmp_rows(idx8, 8), w, h, 8, header=12,
                                      palette=_palette(rng, 256, False)),
        "rle8": bmp_file(rle8(idx8), w, h, 8, compression=1,
                         palette=_palette(rng, 64), colors=64),
        "rle4": bmp_file(rle4(idx4), w, h, 4, compression=2,
                         palette=_palette(rng, 16)),
    }
    px = img.astype(np.uint32)
    p555 = (px[:, :, 0] >> 3) << 10 | (px[:, :, 1] >> 3) << 5 | px[:, :, 2] >> 3
    p565 = (px[:, :, 0] >> 3) << 11 | (px[:, :, 1] >> 2) << 5 | px[:, :, 2] >> 3
    out["rgb_555"] = bmp_file(bmp_rows(p555.astype("<u2").view(np.uint8)
                                       .reshape(h, -1), 8), w, h, 16)
    out["bitfields_565"] = bmp_file(
        bmp_rows(p565.astype("<u2").view(np.uint8).reshape(h, -1), 8), w, h,
        16, compression=3, masks=(0xF800, 0x7E0, 0x1F))
    rgba = np.dstack([img, img[:, :, :1]]).astype(np.uint8)
    out["v4_bitfields_rgba"] = bmp_file(
        bmp_rows(rgba.reshape(h, -1), 8), w, h, 32, header=108,
        compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    out["v5_top_down_24bit"] = bmp_file(
        bmp_rows(img[:, :, ::-1].reshape(h, -1), 8, top_down=True), w, h,
        24, header=124, top_down=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "data"))
    args = ap.parse_args(argv)
    from PIL import Image

    for kind, files in (("png", png_fixtures()), ("bmp", bmp_fixtures())):
        d = os.path.join(args.out, kind)
        os.makedirs(d, exist_ok=True)
        pixels = {}
        for name, data in files.items():
            with open(os.path.join(d, f"{name}.{kind}"), "wb") as f:
                f.write(data)
            with Image.open(io.BytesIO(data)) as im:
                pixels[name] = np.asarray(im.convert("RGB"))
        np.savez_compressed(os.path.join(d, "pixels.npz"), **pixels)
        print(f"wrote {len(files)} {kind.upper()} files and pixels.npz "
              f"to {d}")


if __name__ == "__main__":
    main()
