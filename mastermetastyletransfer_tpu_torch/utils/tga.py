"""The port's TGA reader, with numpy and the native library (the machine
with the card has no PIL).

``read_tga`` reads a Targa file as PIL's ``Image.open(...).convert("RGB")``
gives it. Pillow's TgaImagePlugin is the specification:

* ``_open`` (``open_tga``): the 18-byte header's checks (colour-map type 0
  or 1, a positive size, a depth of 1, 8, 16, 24 or 32 bits), the mode of
  the image type (1 and 9 colour-mapped, or grey without a map; 2 and 10
  true colour; 3 and 11 grey), the orientation (bottom-up unless bit 5
  of the descriptor is set; bit 4 flips each row, done after the load),
  the id section skipped, a colour map of 16, 24 or 32 bits read after
  ``start`` zero entries; a refusal here is an ``OpenRefusal``, and
  Pillow tries its next plugin. The pair (type, depth) may have no
  decoder (``MODES``): the file then opens, and its load refuses it.
  The decompression-bomb check (``MAX_PIXELS``) follows, as in
  ``Image.open``;
* the load: raw rows of the raw mode, or ``TgaRleDecode.c``'s packets
  (``native/tga.cpp``: a run may not cross a row's end, a literal may),
  the data cut short refused ("image file is truncated"); then the colour
  map as ``Image.load`` puts it: an L or LA image becomes P or PA, a 1,
  RGB or RGBA image with a map is refused, as is a map of more than 256
  entries or of 32 bits (a raw mode ``putpalette`` does not take);
  entries past the map are black;
* the modes to RGB as Pillow converts them (``BGRA;15Z``'s five bits each
  scaled by 255 / 31, alpha dropped, ``1`` to 0/255).

A file whose data cannot hold its declared size is refused before
anything of that size is allocated: raw rows must be there, and run-
length data needs at least one packet of 1 + depth bytes for every 128
pixels.
"""

from __future__ import annotations

import numpy as np

from mastermetastyletransfer_tpu_torch.utils.png import MAX_PIXELS, OpenRefusal

# TgaImagePlugin.MODES: (image type & 7, depth) -> raw mode
MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
         (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}
_BITS = {"P": 8, "1": 1, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24,
         "BGRA": 32}
# the colour map's depth -> (bytes an entry, its raw mode)
_MAPS = {16: (2, "BGRA;15Z"), 24: (3, "BGR"), 32: (4, "BGRA")}


def _fail(why: str) -> ValueError:
    return ValueError(f"TGA: {why}")


def _u16(b: bytes, i: int) -> int:
    return b[i] | b[i + 1] << 8


class Header:
    """TgaImageFile._open on the file's bytes."""

    def __init__(self, data: bytes):
        if len(data) < 18:   # s[16], s[17] or i16(s, 12) past the bytes
            raise OpenRefusal(f"TGA: a header of {len(data)} bytes")
        id_len, cmt, itype = data[0], data[1], data[2]
        self.depth, flags = data[16], data[17]
        self.width, self.height = _u16(data, 12), _u16(data, 14)
        if (cmt not in (0, 1) or self.width <= 0 or self.height <= 0
                or self.depth not in (1, 8, 16, 24, 32)):
            raise OpenRefusal("TGA: not a TGA file")
        if itype in (3, 11):
            self.mode = {1: "1", 16: "LA"}.get(self.depth, "L")
        elif itype in (1, 9):
            self.mode = "P" if cmt else "L"
        elif itype in (2, 10):
            self.mode = "RGB" if self.depth == 24 else "RGBA"
        else:
            raise OpenRefusal(f"TGA: unknown TGA mode (image type {itype})")
        orientation = flags & 0x30
        self.flip_h = orientation in (0x10, 0x30)
        self.bottom_up = orientation in (0, 0x10)
        self.rle = bool(itype & 8)
        pos = min(18 + id_len, len(data))   # the id section, read short
        self.palette = None
        if cmt:
            start, size, mapdepth = _u16(data, 3), _u16(data, 5), data[7]
            if mapdepth not in _MAPS:
                raise OpenRefusal(f"TGA: unknown TGA map depth {mapdepth}")
            k, rawmode = _MAPS[mapdepth]
            entries = data[pos:pos + k * size]
            pos += len(entries)
            self.palette = (rawmode, bytes(k * start) + entries)
        self.offset = pos
        self.rawmode = MODES.get((itype & 7, self.depth))
        if self.width * self.height > MAX_PIXELS:   # Image.open's bomb check
            raise _fail(f"an image of {self.width}x{self.height} pixels is "
                        f"above the limit of {MAX_PIXELS} (a decompression "
                        "bomb)")


def open_tga(data: bytes) -> Header:
    """What Pillow's TGA plugin opens: the header, or ``OpenRefusal``."""
    return Header(data)


def _unpack(rows: np.ndarray, rawmode: str, width: int) -> np.ndarray:
    """Pillow's unpacker of the raw mode: (h, width, bands) samples of the
    image's mode (1 and L and P one band, LA two, RGB(A) three or four)."""
    if rawmode == "1":
        bits = np.unpackbits(rows, axis=1)[:, :width]
        return (bits * np.uint8(255))[..., None]
    if rawmode in ("L", "P"):
        return rows[:, :width, None]
    if rawmode == "LA":
        return rows[:, :2 * width].reshape(-1, width, 2)
    if rawmode == "BGRA;15Z":
        v = rows[:, :2 * width].reshape(-1, width, 2).astype(np.uint16)
        v = v[..., 0] | v[..., 1] << 8
        five = [((v >> s) & 31).astype(np.uint32) * 255 // 31
                for s in (10, 5, 0)]
        return np.stack(five, -1).astype(np.uint8)
    k = 3 if rawmode == "BGR" else 4
    return rows[:, :k * width].reshape(-1, width, k)[..., 2::-1]


def _palette(rawmode: str, raw: bytes) -> np.ndarray:
    """ImagingObject putpalette of a TGA colour map: (256, 3) RGB, black
    past its entries."""
    if rawmode == "BGRA":
        raise _fail("a colour map of 32 bits (unrecognized raw mode)")
    k = 2 if rawmode == "BGRA;15Z" else 3
    n = len(raw) // k
    if n > 256:
        raise _fail(f"a colour map of {n} entries (invalid palette size)")
    out = np.zeros((256, 3), np.uint8)
    if n:
        out[:n] = _unpack(np.frombuffer(raw[:n * k], np.uint8)[None],
                          rawmode, n)[0]
    return out


def read_tga(data: bytes) -> np.ndarray:
    """A TGA file's pixels as uint8 (H, W, 3) RGB, as PIL's
    convert("RGB") gives them."""
    from mastermetastyletransfer_tpu_torch.data import native_loader

    head = open_tga(data)
    if head.rawmode is None:
        raise _fail("cannot load this image (no decoder for image type "
                    f"{data[2] & 7} at {head.depth} bits)")
    w, h = head.width, head.height
    if head.mode == "L" and head.rawmode == "P":
        raise _fail("unknown raw mode P for mode L")
    linesize = (_BITS[head.rawmode] * w + 7) // 8
    body = data[head.offset:]
    depth = head.depth // 8   # Pillow's bytes a pixel for the packets
    if not head.rle:
        if len(body) < linesize * h:
            raise _fail("image file is truncated")
        rows = np.frombuffer(body, np.uint8, linesize * h).reshape(h, linesize)
        if head.bottom_up:
            rows = rows[::-1]
    else:
        if depth == 0 or len(body) < -(-w * h * (1 + depth) // 128):
            raise _fail("image file is truncated")
        rows = native_loader.decode_tga_rle(body, depth, linesize, h,
                                            head.bottom_up)
    px = _unpack(rows, head.rawmode, w)
    if head.palette is not None:   # Image.load's putpalette
        if head.mode not in ("L", "LA", "P"):
            raise _fail(f"a colour map on a {head.mode} image (wrong mode)")
        rgb = _palette(*head.palette)[px[..., 0]]
    elif px.shape[2] >= 3:
        rgb = px[..., :3]
    else:
        rgb = np.repeat(px[..., :1], 3, axis=2)
    if head.flip_h:
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb)
