"""The port's PCX and DCX readers, with numpy and the native library (the
machine with the card has no PIL).

``read_pcx`` and ``read_dcx`` read a Paintbrush file, and the first page
of an Intel DCX, as PIL's ``Image.open(...).convert("RGB")`` gives them.
Pillow's PcxImagePlugin and DcxImagePlugin are the specification:

* ``PcxImageFile._open`` on the 68 bytes at the image's start: the magic
  and version byte and the bounding box as ``utils/plugins.py`` checks
  them (an empty box, or bytes too short for the header, pass the bytes
  on: ``OpenRefusal``), then the mode of bits and planes: 1 x 1 is
  mode 1; 1 bit in 2 or 4 planes a palette of the header's 16 entries,
  each pixel's bits one a plane (raw modes P;2L and P;4L); version 5 at 8
  bits in 1 plane grey, or a palette where the file's last 769 bytes are
  12 and 256 entries that are not the grey ramp; version 5 at 8 bits in
  3 planes RGB, one plane a colour (RGB;L); anything else is refused
  ("unknown PCX mode");
* the stride: a plane's bytes (width x bits, rounded up to a byte), one
  more where it is odd and the header gives another; the data from 128
  bytes past the image's start, ``planes x stride`` bytes a row, decoded
  by PcxDecode.c's runs (``native/pcx.cpp``: a run passing a row's end,
  or data that ends before the last row, is refused; each row's planes
  moved together as that decoder moves them, a width apart, or for bit
  planes (width + 7) / 8 bytes, where the unpackers read them so);
* DCX: the magic, then up to 1024 page offsets ended by a 0 (a table that
  runs off the file, or holds no page, passes the bytes on), and the
  first page's PCX at its offset; the 256-colour palette is still looked
  for at the end of the whole file.

An image above PIL's decompression-bomb limit is refused, and so is one
whose data cannot hold its rows (a run of 2 bytes gives at most 63), both
before anything of its size is allocated.
"""

from __future__ import annotations

import struct

import numpy as np

from mastermetastyletransfer_tpu_torch.utils.plugins import takes
from mastermetastyletransfer_tpu_torch.utils.png import MAX_PIXELS, OpenRefusal

_GREY = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
# the unpackers' bits a pixel (Pillow's decoder state's bits)
_BITS = {"1": 1, "P;2L": 2, "P;4L": 4, "L": 8, "P": 8, "RGB;L": 24}


def _fail(kind: str, why: str) -> ValueError:
    return ValueError(f"{kind}: {why}")


class Header:
    """PcxImageFile._open on the image that starts at ``start``."""

    def __init__(self, data: bytes, start: int, kind: str):
        s = data[start:start + 68]
        if not takes("PCX", s):   # the magic, the header, the bounding box
            raise OpenRefusal(f"{kind}: not a PCX file, or a bad PCX "
                              "image size")
        x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
        version, bits, planes = s[1], s[3], s[65]
        provided = struct.unpack_from("<H", s, 66)[0]
        self.palette = None
        if bits == 1 and planes == 1:
            self.rawmode = "1"
        elif bits == 1 and planes in (2, 4):
            self.rawmode = f"P;{planes}L"
            self.palette = s[16:64]
        elif version == 5 and bits == 8 and planes == 1:
            self.rawmode = "L"
            tail = data[-769:]   # seek(-769, SEEK_END) of the file's bytes
            if len(tail) == 769 and tail[0] == 12 and tail[1:] != _GREY:
                self.rawmode = "P"
                self.palette = tail[1:]
        elif version == 5 and bits == 8 and planes == 3:
            self.rawmode = "RGB;L"
        else:
            raise _fail(kind, f"unknown PCX mode (version {version}, {bits} "
                              f"bits, {planes} planes)")
        self.width, self.height = x1 + 1 - x0, y1 + 1 - y0
        stride = (self.width * bits + 7) // 8
        if provided != stride:
            stride += stride % 2
        self.bytes = planes * stride
        self.offset = start + 128
        if self.width * self.height > MAX_PIXELS:   # Image.open's bomb check
            raise _fail(kind, f"an image of {self.width}x{self.height} "
                              f"pixels is above the limit of {MAX_PIXELS} "
                              "(a decompression bomb)")


def _unpack(rows: np.ndarray, rawmode: str, width: int) -> np.ndarray:
    """Pillow's unpacker of the raw mode on decoded rows: (h, width, 3)
    RGB where the mode is RGB, else (h, width) values (1: 0 or 255)."""
    if rawmode == "1":
        return np.unpackbits(rows, axis=1)[:, :width] * np.uint8(255)
    if rawmode in ("L", "P"):
        return rows[:, :width]
    if rawmode == "RGB;L":
        return np.stack([rows[:, k * width:(k + 1) * width]
                         for k in range(3)], -1)
    planes = int(rawmode[2])   # P;2L, P;4L: bit planes (width + 7) / 8 apart
    s = (width + 7) // 8
    out = np.zeros((rows.shape[0], width), np.uint8)
    for k in range(planes):
        bits = np.unpackbits(rows[:, k * s:(k + 1) * s], axis=1)[:, :width]
        out |= bits << k
    return out


def _read(data: bytes, head: Header, kind: str) -> np.ndarray:
    from mastermetastyletransfer_tpu_torch.data import native_loader

    body = data[head.offset:]
    if 63 * len(body) < 2 * head.height * head.bytes:
        raise _fail(kind, "image file is truncated")
    try:
        rows = native_loader.decode_pcx_rle(body, head.bytes, head.width,
                                            head.height,
                                            _BITS[head.rawmode])
    except ValueError as e:
        raise _fail(kind, str(e).removeprefix("PCX: ")) from None
    px = _unpack(rows, head.rawmode, head.width)
    if px.ndim == 3:
        return np.ascontiguousarray(px)
    if head.palette is not None:
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(head.palette, np.uint8).reshape(-1, 3)
        palette[:len(entries)] = entries
        return palette[px]
    return np.repeat(px[..., None], 3, axis=2)


def read_pcx(data: bytes) -> np.ndarray:
    """A PCX file's pixels as uint8 (H, W, 3) RGB, as PIL's convert("RGB")
    gives them."""
    return _read(data, Header(data, 0, "PCX"), "PCX")


def read_dcx(data: bytes) -> np.ndarray:
    """A DCX file's first page as uint8 (H, W, 3) RGB, as PIL's
    convert("RGB") gives it."""
    offsets = []
    for i in range(1024):   # DcxImageFile._open: the page table
        entry = data[4 + 4 * i:8 + 4 * i]
        if len(entry) < 4:
            raise OpenRefusal("DCX: the page table runs off the file")
        offset = struct.unpack("<I", entry)[0]
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise OpenRefusal("DCX: no pages")
    return _read(data, Header(data, offsets[0], "DCX"), "DCX")
