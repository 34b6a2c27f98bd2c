"""The port's ICO reader, with numpy (the machine with the card has no PIL).

``read_ico`` reads the image that Pillow's IcoImagePlugin opens, as PIL's
``convert("RGB")`` gives it. ``IcoFile`` sorts the directory's entries by
colour depth, then, stably, by area, largest first (a width or height byte
of 0 is 256), and the image is the first entry of that order. A PNG entry
is read by ``utils/png.read_png`` at its own size, whatever the directory
says. Any other entry is a headerless bitmap (``utils/bmp.bitmap``): the
top half of its declared height, the XOR image; its AND mask (or, where
the directory gives 32 bits, the bitmap's fourth bytes) sets only an
alpha that ``convert("RGB")`` drops, but Pillow reads it, so a mask that
the file is too short to hold, or that starts before the file, is refused
as Pillow refuses it. So is what Pillow refuses in the directory or the
entry, and an entry above PIL's decompression-bomb limit, before anything
of its size is allocated. Pillow's ICO plugin loads the image in its
``_open``, so all its refusals are made there: an ``OpenRefusal`` where
Pillow's exception passes the file on to its next plugin (a short
directory or entry, a bad PNG chunk, a bitmap of no pixels).
"""

from __future__ import annotations

import math

import numpy as np

from mastermetastyletransfer_tpu_torch.utils.bmp import bitmap
from mastermetastyletransfer_tpu_torch.utils.png import OpenRefusal, read_png

MAGIC = b"\0\0\1\0"
_PNG = b"\x89PNG\r\n\x1a\n"


def _fail(why: str) -> ValueError:
    return ValueError(f"ICO: {why}")


def _u16(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 2], "little")


def _u32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _entry(data: bytes) -> tuple:
    """(width, height, bpp, size, offset) of the entry Pillow opens; the
    refusals here are IcoFile's IndexError and struct.error, which pass
    the file on to Pillow's next plugin."""
    if len(data) < 6:
        raise OpenRefusal("ICO: truncated header")
    count = _u16(data, 4)
    if len(data) < 6 + 16 * count:
        raise OpenRefusal("ICO: truncated directory")
    if count == 0:
        raise OpenRefusal("ICO: no images")
    entries = []
    for i in range(count):   # one step an entry of the directory
        s = data[6 + 16 * i:22 + 16 * i]
        width, height, colors, bpp = s[0] or 256, s[1] or 256, s[2], _u16(s, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append((depth, width * height, width, height, bpp,
                        _u32(s, 8), _u32(s, 12)))
    entries.sort(key=lambda e: e[0])
    entries.sort(key=lambda e: e[1], reverse=True)
    return entries[0][2:]


def read_ico(data: bytes) -> np.ndarray:
    """An ICO file's image as uint8 (H, W, 3) RGB, as PIL's
    convert("RGB") gives it."""
    if data[:4] != MAGIC:
        raise _fail("not an ICO file")
    _, _, bpp, size, offset = _entry(data)
    if data[offset:offset + 8] == _PNG:
        return read_png(data[offset:])
    if offset + 4 > len(data):   # the DIB plugin's struct.error
        raise OpenRefusal("ICO: truncated entry")
    rgb, start = bitmap(data, offset, halve=True)
    h, w = rgb.shape[:2]
    if bpp == 32:   # the alpha: every fourth byte from the pixels on
        if start + 4 * w * h > len(data):
            raise _fail("truncated alpha")
    else:   # the AND mask: 1-bit rows padded to 32 bits, at the entry's end
        stride = (w + 31) // 32 * 4
        at = offset + size - stride * h
        if at < 0:
            raise _fail("the mask starts before the file")
        mask = data[at:at + stride * h]
        if h and len(mask) < stride * (h - 1) + (w + 7) // 8:
            raise _fail("truncated mask")
    return rgb
