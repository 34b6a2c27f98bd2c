"""The port's BMP reader, with numpy (the machine with the card has no PIL).

``read_bmp`` reads every BMP that PIL's ``convert("RGB")`` reads, bit for
bit, as Pillow's BmpImagePlugin reads it: OS/2 core (12-byte), INFO
(40-byte), V2, V3, OS/2 2.x (64-byte), V4 and V5 headers; palettes at 1, 4
and 8 bits (a palette that is the grey ramp, or black and white at 2
colours, read as grey as Pillow reads it), RLE8 and RLE4 (Pillow's
BmpRleDecoder, each write bounded by the image), 16-bit 5-5-5, 24-bit and
32-bit rows, and BI_BITFIELDS at 16 (5-6-5, 5-5-5), 24 and 32 bits in the
layouts Pillow takes; rows bottom-up, or top-down under a negative height.
What Pillow refuses (2-bit pixels, other bit fields, JPEG or PNG inside,
an RLE bitmap that ends before its last pixel, a truncated file) raises
``ValueError``, and so does a file above PIL's decompression-bomb limit
(``MAX_PIXELS``), before anything of its size is allocated.
"""

from __future__ import annotations

import numpy as np

from mastermetastyletransfer_tpu_torch.utils.png import MAX_PIXELS, OpenRefusal

# Pillow's BIT2MODE: pixel depth -> its raw mode (compression 0)
_RAW_MODES = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR",
              32: "BGRX"}
# Pillow's BI_BITFIELDS layouts: (bits, masks) -> raw mode
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
# raw mode -> bits a pixel, and for the 24/32-bit ones the bytes of R, G, B
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16,
             "BGR;16": 16, "BGR": 24}
_BYTES = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "XBGR": (3, 2, 1),
          "BGXR": (3, 1, 0), "ABGR": (3, 2, 1), "RGBA": (0, 1, 2),
          "BGRA": (2, 1, 0), "BGAR": (3, 1, 0)}
_HEADERS = (40, 52, 56, 64, 108, 124)


def _u16(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 2], "little")


def _u32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _short(what: str):
    return ValueError(f"BMP: truncated file ({what})")


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """Pillow's BmpRleDecoder on the bytes from ``pos``: the (w * h)
    indices in file row order. Pillow appends to a growing buffer and keeps
    its first w * h bytes; here a write past them is dropped, so the buffer
    never exceeds the image. A bitmap that ends (end of bitmap, end of
    file) before its last pixel is refused, as Pillow refuses it ("not
    enough image data")."""
    total = w * h
    out = np.zeros(total, np.uint8)
    n = x = 0   # Pillow's len(data) and its x

    def put(values) -> None:
        nonlocal n
        k = len(values)
        if n < total:
            out[n:min(n + k, total)] = values[:total - n]
        n += k

    end = len(data)
    while n < total:
        if pos + 2 > end:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:   # an encoded run, cut at the row's end
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                put(np.resize(np.array([byte >> 4, byte & 15], np.uint8),
                              count))
            else:
                put(np.full(count, byte, np.uint8))
            x += count
        elif byte == 0:   # end of line: zeros to the next row
            if n % w:
                put(np.zeros(w - n % w, np.uint8))
            x = 0
        elif byte == 1:   # end of bitmap
            break
        elif byte == 2:   # delta: Pillow reads two bytes, then takes the next two
            if pos + 2 > end:
                break
            pos += 2
            if pos + 2 > end:
                raise _short("an RLE delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            skip = right + up * w
            n += skip   # zeros, already there
            x = n % w
        else:   # an absolute run
            nbytes = byte // 2 if rle4 else byte
            run = np.frombuffer(data[pos:pos + nbytes], np.uint8)
            pos += len(run)
            if rle4:
                put(np.stack([run >> 4, run & 15], 1).reshape(-1))
            else:
                put(run)
            if len(run) < nbytes:
                break
            x += byte
            if pos % 2:   # to a 16-bit boundary of the file
                pos += 1
    if n < total:
        raise ValueError("BMP: the RLE bitmap ends before its last pixel")
    return out


def _unpack(rows: np.ndarray, raw: str, w: int) -> np.ndarray:
    """(h, row bytes) of a raw mode as (h, w) indices or grey, or (h, w, 3)
    RGB."""
    h = rows.shape[0]
    bits = _RAW_BITS.get(raw, 32)
    if bits < 8:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
        vals = vals.reshape(h, -1)[:, :w]
        return vals * np.uint8(255) if raw == "1" else vals
    if bits == 8:
        return rows[:, :w]
    if bits == 16:
        v = rows[:, :2 * w].reshape(h, w, 2).astype(np.uint32)
        v = v[:, :, 0] | v[:, :, 1] << 8
        fields = (((11, 5), (5, 6), (0, 5)) if raw == "BGR;16"
                  else ((10, 5), (5, 5), (0, 5)))
        return np.stack([((v >> s) & ((1 << k) - 1)) * 255 // ((1 << k) - 1)
                         for s, k in fields], 2).astype(np.uint8)
    px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
    return px[:, :, list(_BYTES[raw])]


def read_bmp(data: bytes) -> np.ndarray:
    """A BMP file's pixels as uint8 (H, W, 3) RGB, as PIL's
    convert("RGB") gives them."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP (no BM signature)")
    if len(data) < 18:
        raise _short("its file header")
    return bitmap(data, 14, _u32(data, 10))[0]


def dib_accept(prefix: bytes) -> bool:
    """BmpImagePlugin._dib_accept: a header size that Pillow reads."""
    return len(prefix) >= 4 and _u32(prefix, 0) in (12,) + _HEADERS


def read_dib(data: bytes) -> np.ndarray:
    """A headerless BMP (Pillow's DIB plugin) as uint8 (H, W, 3) RGB, as
    PIL's convert("RGB") gives it."""
    if not dib_accept(data[:4]):
        raise ValueError("not a DIB (no header size that is read)")
    return bitmap(data)[0]


def bitmap(data: bytes, start: int = 0, offset: int = 0,
           halve: bool = False):
    """The bitmap whose header starts at ``start`` of ``data`` as uint8
    (H, W, 3) RGB, as Pillow's ``BmpImageFile._bitmap`` reads it: a BMP's
    at 14, with the file header's pixel ``offset``, or a headerless DIB
    (Pillow's DIB plugin, an ICO's bitmap entry) with ``offset`` 0, the
    pixels then right after the header, its bit field masks and its
    palette. Positions (the RLE decoder's 16-bit alignment among them)
    are of ``data`` as a whole, as Pillow's file pointer gives them.
    ``halve`` reads the top half of the declared height, an ICO entry's
    XOR bitmap (Pillow's ``int(height / 2)``); the bomb limit applies to
    the declared size. Returns the pixels and the offset they start at.
    """
    if len(data) < start + 4:   # Pillow: a struct.error in its _open
        raise OpenRefusal("BMP: the file ends before its bitmap header")
    hsize = _u32(data, start)
    head = data[start + 4:start + hsize]
    if len(head) < hsize - 4:
        raise _short("its bitmap header")
    pos = start + hsize   # where Pillow's file pointer stands after the header
    masks = None
    if hsize == 12:   # OS/2 1.x / BITMAPCOREHEADER
        w, h, bits = _u16(head, 0), _u16(head, 2), _u16(head, 6)
        compression, colors, pad, top_down = 0, 0, 3, False
    elif hsize in _HEADERS:
        top_down = head[7] == 0xFF
        w = _u32(head, 0)
        h = 2 ** 32 - _u32(head, 4) if top_down else _u32(head, 4)
        bits, compression = _u16(head, 10), _u32(head, 12)
        colors, pad = _u32(head, 28), 4
        if compression == 3:
            if len(head) >= 48:
                masks = tuple(_u32(head, 36 + 4 * i)
                              for i in range(4 if len(head) >= 52 else 3))
            else:   # a 40-byte header: three masks after it
                if pos + 12 > len(data):
                    raise OpenRefusal("BMP: the file ends before its bit "
                                      "field masks")
                masks = tuple(_u32(data, pos + 4 * i) for i in range(3))
                pos += 12
            masks = masks + (0,) * (4 - len(masks))
    else:
        raise ValueError(f"BMP: a header of {hsize} bytes is not read")
    colors = colors or 1 << bits
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    full_h = h
    if halve:
        h //= 2
    if bits not in _RAW_MODES:
        raise ValueError(f"BMP: {bits}-bit pixels are not read")
    raw, rle = _RAW_MODES[bits], False
    if compression == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _MASK_MODES:
            raise ValueError(f"BMP: bit fields {masks} at {bits} bits are "
                             "not read")
        raw = _MASK_MODES[key]
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        raise ValueError(f"BMP: compression {compression} is not read")
    if raw in ("P;1", "P;4", "P") and not 0 < colors <= 65536:
        raise ValueError(f"BMP: a palette of {colors} colours")
    if w == 0 or full_h == 0:   # ImageFile refuses an image of no pixels
        raise OpenRefusal(f"BMP of {w}x{full_h} pixels")
    if w * full_h > MAX_PIXELS:
        raise ValueError(f"BMP of {w}x{full_h} pixels is above the limit of "
                         f"{MAX_PIXELS} (a decompression bomb)")
    palette = None
    if raw in ("P;1", "P;4", "P"):
        table = data[pos:pos + pad * colors]
        pos += len(table)
        grey = (0, 255) if colors == 2 else range(colors)
        if all(table[i * pad:i * pad + 3] == bytes([v & 255]) * 3
               for i, v in enumerate(grey)):
            raw = "1" if colors == 2 else "L"   # Pillow drops the palette
        else:
            entries = np.frombuffer(table[:len(table) // pad * pad],
                                    np.uint8).reshape(-1, pad)[:256, 2::-1]
            palette = np.zeros((256, 3), np.uint8)   # black past its end
            palette[:len(entries)] = entries
    offset = offset or pos   # Pillow: the file's position where it is 0
    if rle:
        if raw == "1":
            raise ValueError("BMP: an RLE bitmap of a black and white "
                             "palette is not read")
        px = _rle(data, offset, w, h, compression == 2).reshape(h, w)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        need = (w * _RAW_BITS.get(raw, 32) + 7) // 8
        if need > stride:
            raise ValueError(f"BMP: {bits}-bit rows read as {raw}")
        if offset + stride * (h - 1) + need > len(data):
            raise _short("its pixels")
        body = np.frombuffer(data, np.uint8, stride * (h - 1) + need, offset)
        rows = np.pad(body, (0, stride - need)).reshape(h, stride)
        px = _unpack(rows, raw, w)
    if not top_down:
        px = px[::-1]
    if palette is not None:
        return palette[px], offset
    if px.ndim == 2:
        return np.repeat(px[:, :, None], 3, axis=2), offset
    return np.ascontiguousarray(px), offset
