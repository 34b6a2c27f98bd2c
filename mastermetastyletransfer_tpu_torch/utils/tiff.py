"""The port's TIFF reader, with numpy and the native library (the machine
with the card has no PIL and no libtiff).

``read_tiff`` reads the first page of a TIFF as PIL's ``convert("RGB")``
gives it. Pillow's TiffImagePlugin is the specification of what is read:

* the header (both byte orders, classic and BigTIFF, and the two invalid
  forms Pillow takes) and IFD 0 as ``ImageFileDirectory_v2`` loads it: an
  entry whose data lies past the file's end stops the loading and keeps
  the entries before it; each tag's values as Pillow types them (a
  single-valued tag its first value, BYTE data as bytes);
* ``_setup``: the mode and raw mode from Pillow's ``OPEN_INFO`` (``_OPEN``
  below: photometrics 0, 1, 2, 3, 5, 6 and 8 at 1 to 32 bits, alpha
  associated or not, extra samples, both fill orders), Pillow's defaults
  and checks, the orientation;
* uncompressed files (compression 1) as Pillow reads them itself: its
  strips or tiles ("tiles" of its raw decoder, ordered by offset, the
  later of two with one extent winning), their byte counts ignored, each
  plane of a planar file through the one-band unpacker its raw mode's
  letter names;
* every other compression as libtiff decodes it for Pillow
  (``TiffDecode.c``): strips or tiles of the byte counts libtiff reads,
  decoded by LZW and PackBits (``native/tiff.cpp``), CCITT Modified
  Huffman, RLE-W, T.4 and T.6 (``native/fax.cpp``: libtiff's state kept
  from strip to strip, its "no EOL" mode among it), Deflate (zlib, the
  standard library's), LZMA (liblzma, the library the standard library's
  ``lzma`` wraps, through ctypes as tif_lzma.c drives it; a dictionary
  declared far beyond the strip cut to what the strip needs), Zstandard
  (``native/zstd.cpp``, from RFC 8878, as tif_zstd.c drives libzstd) or
  JPEG (``native/jpeg.cpp`` through ``native/tiff.cpp``: the tables
  libjpeg holds, JPEGTables first, then each strip's own; libtiff's
  checks of a frame's size, components and sampling; YCbCr turned to RGB
  where Pillow asks libtiff for RGB, else the components as stored; a
  frame's first full scan read to its end only), FillOrder 2 reversed
  first; the predictor undone (2: horizontal, 3: floating point) and the
  samples swapped to the host's order as libtiff does; then Pillow's
  unpacker on each row (its native-order raw modes where Pillow names
  them, a planar file's planes into the bands); YCbCr that is not JPEG
  as libtiff's TIFFRGBAImage gives it to Pillow (strips or tiles, the
  subsampling's blocks as its put functions step through them,
  TIFFYCbCrToRGB's tables, the predictor undone where a strip decoded
  whole, a strip or tile whose codec fails kept as far as it got);
* the modes to RGB as Pillow converts them (``I;16``, ``I`` and ``F``
  clamped, ``1`` to 0/255, a palette black past its entries, CMYK through
  cmyk2rgb, alpha dropped, associated alpha divided out by the unpacker),
  and the Orientation tag applied as ``exif_transpose`` applies it.

What Pillow or libtiff refuses raises ``ValueError``, and so does what is
not ported yet: the compressions Pillow reads that are not named above
(ThunderScan, old-style JPEG) and CIELab (which Pillow converts through
LittleCMS), each named. An image above PIL's decompression-bomb limit
(``MAX_PIXELS``) is refused before anything of its size is allocated,
and so is one whose strips or tiles lie past the file's end, one that
declares more strips or tiles than its byte counts give (libtiff: a
strip of 0 bytes; above a million, a short tag), and a tile above
Pillow's 2 GiB. Strips and tiles are decoded some at a time
(``_BATCH_BYTES``), as Pillow decodes them one at a time, so tiles that
reach far past a small image are never held all at once.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
import struct
import zlib
from fractions import Fraction

import numpy as np

from mastermetastyletransfer_tpu_torch.utils.png import MAX_PIXELS
from mastermetastyletransfer_tpu_torch.utils.pnm import mode_to_rgb

# TiffImagePlugin.PREFIXES
PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
            b"MM\x00\x2b", b"II\x2b\x00")
# TiffImagePlugin.COMPRESSION_INFO
COMPRESSIONS = {
    1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw",
    6: "tiff_jpeg", 7: "jpeg", 8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
    32773: "packbits", 32809: "tiff_thunderscan", 32946: "tiff_deflate",
    34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma",
    50000: "zstd", 50001: "webp"}
READ_COMPRESSIONS = (1, 2, 3, 4, 5, 7, 8, 32771, 32773, 32946, 34925, 50000)
_CCITT = (2, 3, 4, 32771)
# the codecs through libtiff's predictor module
_PREDICTED = (5, 8, 32946, 34925, 50000)
# TiffImagePlugin.OPEN_INFO: (photometric, sample format, fill order, bits,
# extra samples, mode, raw mode, byte orders: I little-endian, M big)
_OPEN_ROWS = (
    (0, (1,), 1, (1,), (), "1", "1;I", "IM"),
    (0, (1,), 2, (1,), (), "1", "1;IR", "IM"),
    (1, (1,), 1, (1,), (), "1", "1", "IM"),
    (1, (1,), 2, (1,), (), "1", "1;R", "IM"),
    (0, (1,), 1, (2,), (), "L", "L;2I", "IM"),
    (0, (1,), 2, (2,), (), "L", "L;2IR", "IM"),
    (1, (1,), 1, (2,), (), "L", "L;2", "IM"),
    (1, (1,), 2, (2,), (), "L", "L;2R", "IM"),
    (0, (1,), 1, (4,), (), "L", "L;4I", "IM"),
    (0, (1,), 2, (4,), (), "L", "L;4IR", "IM"),
    (1, (1,), 1, (4,), (), "L", "L;4", "IM"),
    (1, (1,), 2, (4,), (), "L", "L;4R", "IM"),
    (0, (1,), 1, (8,), (), "L", "L;I", "IM"),
    (0, (1,), 2, (8,), (), "L", "L;IR", "IM"),
    (1, (1,), 1, (8,), (), "L", "L", "IM"),
    (1, (2,), 1, (8,), (), "L", "L", "IM"),
    (1, (1,), 2, (8,), (), "L", "L;R", "IM"),
    (1, (1,), 1, (12,), (), "I;16", "I;12", "I"),
    (0, (1,), 1, (16,), (), "I;16", "I;16", "I"),
    (1, (1,), 1, (16,), (), "I;16", "I;16", "I"),
    (1, (1,), 1, (16,), (), "I;16B", "I;16B", "M"),
    (1, (1,), 2, (16,), (), "I;16", "I;16R", "I"),
    (1, (2,), 1, (16,), (), "I", "I;16S", "I"),
    (1, (2,), 1, (16,), (), "I", "I;16BS", "M"),
    (0, (3,), 1, (32,), (), "F", "F;32F", "I"),
    (0, (3,), 1, (32,), (), "F", "F;32BF", "M"),
    (1, (1,), 1, (32,), (), "I", "I;32N", "I"),
    (1, (2,), 1, (32,), (), "I", "I;32S", "I"),
    (1, (2,), 1, (32,), (), "I", "I;32BS", "M"),
    (1, (3,), 1, (32,), (), "F", "F;32F", "I"),
    (1, (3,), 1, (32,), (), "F", "F;32BF", "M"),
    (1, (1,), 1, (8, 8), (2,), "LA", "LA", "IM"),
    (2, (1,), 1, (8, 8, 8), (), "RGB", "RGB", "IM"),
    (2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R", "IM"),
    (2, (1,), 1, (8, 8, 8, 8), (), "RGBA", "RGBA", "IM"),
    (2, (1,), 1, (8, 8, 8, 8), (0,), "RGB", "RGBX", "IM"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0), "RGB", "RGBXX", "IM"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0), "RGB", "RGBXXX", "IM"),
    (2, (1,), 1, (8, 8, 8, 8), (1,), "RGBA", "RGBa", "IM"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0), "RGBA", "RGBaX", "IM"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0), "RGBA", "RGBaXX", "IM"),
    (2, (1,), 1, (8, 8, 8, 8), (2,), "RGBA", "RGBA", "IM"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0), "RGBA", "RGBAX", "IM"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0), "RGBA", "RGBAXX", "IM"),
    (2, (1,), 1, (8, 8, 8, 8), (999,), "RGBA", "RGBA", "IM"),
    (2, (1,), 1, (16, 16, 16), (), "RGB", "RGB;16L", "I"),
    (2, (1,), 1, (16, 16, 16), (), "RGB", "RGB;16B", "M"),
    (2, (1,), 1, (16, 16, 16, 16), (), "RGBA", "RGBA;16L", "I"),
    (2, (1,), 1, (16, 16, 16, 16), (), "RGBA", "RGBA;16B", "M"),
    (2, (1,), 1, (16, 16, 16, 16), (0,), "RGB", "RGBX;16L", "I"),
    (2, (1,), 1, (16, 16, 16, 16), (0,), "RGB", "RGBX;16B", "M"),
    (2, (1,), 1, (16, 16, 16, 16), (1,), "RGBA", "RGBa;16L", "I"),
    (2, (1,), 1, (16, 16, 16, 16), (1,), "RGBA", "RGBa;16B", "M"),
    (2, (1,), 1, (16, 16, 16, 16), (2,), "RGBA", "RGBA;16L", "I"),
    (2, (1,), 1, (16, 16, 16, 16), (2,), "RGBA", "RGBA;16B", "M"),
    (3, (1,), 1, (1,), (), "P", "P;1", "IM"),
    (3, (1,), 2, (1,), (), "P", "P;1R", "IM"),
    (3, (1,), 1, (2,), (), "P", "P;2", "IM"),
    (3, (1,), 2, (2,), (), "P", "P;2R", "IM"),
    (3, (1,), 1, (4,), (), "P", "P;4", "IM"),
    (3, (1,), 2, (4,), (), "P", "P;4R", "IM"),
    (3, (1,), 1, (8,), (), "P", "P", "IM"),
    (3, (1,), 1, (8, 8), (0,), "P", "PX", "IM"),
    (3, (1,), 1, (8, 8), (2,), "PA", "PA", "IM"),
    (3, (1,), 2, (8,), (), "P", "P;R", "IM"),
    (5, (1,), 1, (8, 8, 8, 8), (), "CMYK", "CMYK", "IM"),
    (5, (1,), 1, (8, 8, 8, 8, 8), (0,), "CMYK", "CMYKX", "IM"),
    (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0), "CMYK", "CMYKXX", "IM"),
    (5, (1,), 1, (16, 16, 16, 16), (), "CMYK", "CMYK;16L", "I"),
    (5, (1,), 1, (16, 16, 16, 16), (), "CMYK", "CMYK;16B", "M"),
    (6, (1,), 1, (8,), (), "L", "L", "IM"),
    (6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX", "IM"),
    (8, (1,), 1, (8, 8, 8), (), "LAB", "LAB", "IM"),
)
_OPEN = {(order * 2, photo, sf, fo, bps, extra): (mode, raw)
         for photo, sf, fo, bps, extra, mode, raw, orders in _OPEN_ROWS
         for order in (o.encode() for o in orders)}
_MAX_SAMPLES = 6   # TiffImagePlugin.MAX_SAMPLESPERPIXEL

# (mode, raw mode) -> bits a pixel, for every unpacker Pillow has that a
# TIFF can reach (a missing pair is Pillow's "unknown raw mode")
_UNPACKERS = {
    ("1", "1"): 1, ("1", "1;I"): 1, ("1", "1;R"): 1, ("1", "1;IR"): 1,
    ("L", "L"): 8, ("L", "L;I"): 8, ("L", "L;R"): 8,
    ("L", "L;2"): 2, ("L", "L;2I"): 2, ("L", "L;2R"): 2, ("L", "L;2IR"): 2,
    ("L", "L;4"): 4, ("L", "L;4I"): 4, ("L", "L;4R"): 4, ("L", "L;4IR"): 4,
    ("P", "P"): 8, ("P", "P;R"): 8, ("P", "P;1"): 1, ("P", "P;2"): 2,
    ("P", "P;4"): 4, ("P", "PX"): 16, ("PA", "PA"): 16, ("LA", "LA"): 16,
    ("I;16", "I;16"): 16, ("I;16", "I;16N"): 16, ("I;16", "I;16R"): 16,
    ("I;16", "I;12"): 12, ("I;16B", "I;16B"): 16, ("I;16B", "I;16N"): 16,
    ("I", "I"): 32, ("I", "I;16S"): 16, ("I", "I;16BS"): 16,
    ("I", "I;32N"): 32, ("I", "I;32S"): 32, ("I", "I;32BS"): 32,
    ("F", "F"): 32, ("F", "F;32F"): 32, ("F", "F;32BF"): 32,
    ("RGB", "RGB"): 24, ("RGB", "RGB;R"): 24, ("RGB", "RGBX"): 32,
    ("RGB", "RGBXX"): 40, ("RGB", "RGBXXX"): 48,
    ("RGB", "RGB;16L"): 48, ("RGB", "RGB;16B"): 48, ("RGB", "RGB;16N"): 48,
    ("RGB", "RGBX;16L"): 64, ("RGB", "RGBX;16B"): 64,
    ("RGB", "RGBX;16N"): 64,
    ("RGBA", "RGBA"): 32, ("RGBA", "RGBAX"): 40, ("RGBA", "RGBAXX"): 48,
    ("RGBA", "RGBa"): 32, ("RGBA", "RGBaX"): 40, ("RGBA", "RGBaXX"): 48,
    ("RGBA", "RGBA;16L"): 64, ("RGBA", "RGBA;16B"): 64,
    ("RGBA", "RGBA;16N"): 64, ("RGBA", "RGBa;16L"): 64,
    ("RGBA", "RGBa;16B"): 64, ("RGBA", "RGBa;16N"): 64,
    ("CMYK", "CMYK"): 32, ("CMYK", "CMYKX"): 40, ("CMYK", "CMYKXX"): 48,
    ("CMYK", "CMYK;16L"): 64, ("CMYK", "CMYK;16B"): 64,
    ("CMYK", "CMYK;16N"): 64, ("LAB", "LAB"): 24,
    # one band of a planar file (Pillow's raw route: its raw mode's letter)
    ("RGB", "R"): 8, ("RGB", "G"): 8, ("RGB", "B"): 8,
    ("RGBA", "R"): 8, ("RGBA", "G"): 8, ("RGBA", "B"): 8, ("RGBA", "A"): 8,
    ("CMYK", "C"): 8, ("CMYK", "M"): 8, ("CMYK", "Y"): 8, ("CMYK", "K"): 8,
    ("LAB", "L"): 8, ("LAB", "A"): 8, ("LAB", "B"): 8,
}
_BAND = {("RGB", "R"): 0, ("RGB", "G"): 1, ("RGB", "B"): 2,
         ("RGBA", "R"): 0, ("RGBA", "G"): 1, ("RGBA", "B"): 2,
         ("RGBA", "A"): 3, ("CMYK", "C"): 0, ("CMYK", "M"): 1,
         ("CMYK", "Y"): 2, ("CMYK", "K"): 3, ("LAB", "L"): 0,
         ("LAB", "A"): 1, ("LAB", "B"): 2}
_BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "I": 1, "F": 1,
          "LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4, "LAB": 3}
# TiffTags' single-valued tags among those read here
_SINGLE = {256, 257, 259, 262, 266, 274, 277, 278, 282, 283, 284, 296, 317,
           322, 323, 347}
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 13: 4, 16: 8}
_TYPE_FMT = {3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 11: "f", 12: "d",
             13: "L", 16: "Q"}
# raw modes of bit-reversed bytes -> the raw mode of the reversed bytes
_BIT_REVERSED = {"1;R": "1", "1;IR": "1;I", "L;R": "L", "L;2R": "L;2",
                 "L;2IR": "L;2I", "L;4R": "L;4", "L;4IR": "L;4I",
                 "P;R": "P", "RGB;R": "RGB", "I;16R": "I;16"}
_REVERSE = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)


def accept(prefix: bytes) -> bool:
    """TiffImagePlugin._accept."""
    return prefix[:4] in PREFIXES


def _fail(why: str) -> ValueError:
    return ValueError(f"TIFF: {why}")


class _Ifd:
    """IFD 0 as ImageFileDirectory_v2.load reads it: (type, data) a tag."""

    def __init__(self, data: bytes):
        ifh = data[:8]
        if len(ifh) < 3:
            raise _fail("truncated header")
        if ifh[2] == 43:
            ifh += data[8:16]
        if not accept(ifh):
            raise _fail(f"not a TIFF file (header {ifh!r} not valid)")
        self.prefix = ifh[:2]
        self.order = ">" if self.prefix == b"MM" else "<"
        self.big = ifh[2] == 43
        fmt = "Q" if self.big else "L"
        raw_next = ifh[8:16] if self.big else ifh[4:8]
        if len(raw_next) < struct.calcsize(self.order + fmt):
            raise _fail("truncated header")
        (self.offset,) = struct.unpack(self.order + fmt, raw_next)
        if not self.offset:
            raise _fail("no more images in TIFF file")
        self.tags: dict = {}
        self._load(data)
        self.data = data

    def _load(self, data: bytes) -> None:
        """The entries, until one that the file is too short for."""
        big, order = self.big, self.order
        pos = self.offset
        head = 8 if big else 2
        if pos + head > len(data):
            return
        (count,) = struct.unpack(order + ("Q" if big else "H"),
                                 data[pos:pos + head])
        pos += head
        size, inline = (20, 8) if big else (12, 4)
        for _ in range(count):   # one step an entry of the directory
            if pos + size > len(data):
                return
            tag, typ, n, field = struct.unpack(
                order + ("HHQ8s" if big else "HHL4s"), data[pos:pos + size])
            pos += size
            if typ not in _TYPE_SIZE:
                continue
            nbytes = n * _TYPE_SIZE[typ]
            if nbytes > inline:
                (at,) = struct.unpack(order + ("Q" if big else "L"), field)
                if at + nbytes > len(data):
                    return
                value = data[at:at + nbytes]
            else:
                value = field[:nbytes]
            if value:
                self.tags[tag] = (typ, value)

    def __contains__(self, tag: int) -> bool:
        return tag in self.tags

    def get(self, tag: int, default=None):
        """The tag's value as Pillow's tag_v2 gives it."""
        if tag not in self.tags:
            return default
        typ, data = self.tags[tag]
        if typ in (1, 7):
            values = [data]
        elif typ == 2:
            values = [(data[:-1] if data.endswith(b"\0") else data)
                      .decode("latin-1", "replace")]
        elif typ in (5, 10):
            nums = struct.unpack(
                f"{self.order}{len(data) // 4}{'L' if typ == 5 else 'l'}",
                data)
            values = [Fraction(a, b) if b else math.nan
                      for a, b in zip(nums[::2], nums[1::2])]
        else:
            fmt = _TYPE_FMT[typ]
            values = list(struct.unpack(
                f"{self.order}{len(data) // struct.calcsize(self.order + fmt)}{fmt}",
                data))
        if tag in _SINGLE or typ == 1:
            return values[0]
        return tuple(values)


_LT_WIDTH = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
             11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_LT_INTS = {1: "B", 6: "b", 3: "H", 8: "h", 4: "L", 9: "l", 13: "L",
            16: "Q", 17: "q", 18: "Q"}
_LT_ARRAYS = {1: "u1", 6: "i1", 3: "u2", 8: "i2", 4: "u4", 9: "i4",
              16: "u8", 17: "i8"}
# tif_dirread.c TIFFFetchStripThing: a tag with fewer entries than strips
# is padded with zeros only up to this many strips
# (LIBTIFF_STRILE_ARRAY_MAX_RESIZE_COUNT's default)
_STRILE_MAX_RESIZE = 1_000_000


class _LibtiffDir:
    """IFD 0 as libtiff's TIFFReadDirectory reads it for Pillow's decoder:
    the whole entry table or nothing, the first entry of a tag, integer
    tags of any integer type, a tag whose data lies past the file's end
    unread. ``value`` of a tag libtiff cannot do without raises (its
    "goto bad"); ``soft`` of another gives None, libtiff's default."""

    def __init__(self, ifd: _Ifd):
        data, order, big = ifd.data, ifd.order, ifd.big
        self.data, self.order, self.big = data, order, big
        pos = ifd.offset
        head, size = (8, 20) if big else (2, 12)
        if pos + head > len(data):
            raise _fail("libtiff: cannot read the directory count")
        (count,) = struct.unpack(order + ("Q" if big else "H"),
                                 data[pos:pos + head])
        if count > 4096:
            raise _fail("libtiff: a directory of more than 4096 entries")
        if count == 0:
            raise _fail("libtiff: an empty directory")
        if pos + head + count * size > len(data):
            raise _fail("libtiff: cannot read the directory")
        self.count = count
        self.entries: dict = {}
        table = data[pos + head:pos + head + count * size]
        total = 0
        for k in range(count):   # one step an entry of the directory
            tag, typ, n, field = struct.unpack(
                order + ("HHQ8s" if big else "HHL4s"),
                table[k * size:(k + 1) * size])
            self.entries.setdefault(tag, (typ, n, field))
            width = _LT_WIDTH.get(typ, 0)   # EvaluateIFDdatasizeReading
            if width and n * width > (8 if big else 4):
                total += n * width
                if n * width >= 1 << 64 or total >= 1 << 64:
                    raise _fail("libtiff: too large IFD data size")

    def raw(self, tag: int):
        """(type, count, bytes or None where they lie past the file)."""
        if tag not in self.entries:
            return None
        typ, n, field = self.entries[tag]
        width = _LT_WIDTH.get(typ, 0)
        nbytes = n * width
        if nbytes <= (8 if self.big else 4):
            return typ, n, field[:nbytes]
        (at,) = struct.unpack(self.order + ("Q" if self.big else "L"), field)
        if at + nbytes > len(self.data):
            return typ, n, None
        return typ, n, self.data[at:at + nbytes]

    def striles(self, tag: int, n: int):
        """TIFFFetchStripThing: the first n values of an offsets or byte
        counts tag (more are not read) as uint64, 0 past its count; None
        where it is absent; refused where libtiff cannot read them."""
        if tag not in self.entries:
            return None
        typ, count, field = self.entries[tag]
        if typ not in _LT_ARRAYS:   # the integer types
            raise _fail(f"libtiff: tag {tag} of type {typ}")
        width = _LT_WIDTH[typ]
        take = min(count, n)
        if count * width <= (8 if self.big else 4):
            raw = field[:take * width]
        else:
            (at,) = struct.unpack(self.order + ("Q" if self.big else "L"),
                                  field)
            if at + take * width > len(self.data):
                raise _fail(f"libtiff: cannot read tag {tag}")
            raw = self.data[at:at + take * width]
        values = np.frombuffer(raw, np.dtype(_LT_ARRAYS[typ]).newbyteorder(
            self.order))
        if (values < 0).any():
            raise _fail(f"libtiff: tag {tag} has a negative value")
        out = np.zeros(n, np.uint64)
        out[:take] = values
        return out

    def ints(self, tag: int):
        """The tag's integers, or None where libtiff cannot read them."""
        got = self.raw(tag)
        if got is None or got[0] not in _LT_INTS or got[2] is None:
            return None
        typ, n, data = got
        return list(struct.unpack(f"{self.order}{n}{_LT_INTS[typ]}", data))

    def value(self, tag: int, default=None, persample: int = 0,
              short: bool = False):
        """A tag libtiff must read: one integer (or, with ``persample``,
        as many equal ones), in range; absent: ``default``."""
        if tag not in self.entries:
            return default
        v = self.ints(tag)
        if v is None or (short and self.entries[tag][0] in (13, 18)):
            raise _fail(f"libtiff: cannot read tag {tag}")
        if len(v) != 1:
            if not persample or len(v) < persample or \
                    len(set(v[:persample])) != 1:
                raise _fail(f"libtiff: incorrect count for tag {tag}")
        if v[0] < 0 or v[0] > (0xFFFF if short else 0xFFFFFFFF):
            raise _fail(f"libtiff: tag {tag} out of range")
        return v[0]

    def soft(self, tag: int, default=None):
        """A tag libtiff ignores where it cannot read it."""
        v = self.ints(tag)
        if v is None or len(v) != 1 or not 0 <= v[0] <= 0xFFFF:
            return default
        return v[0]


def _ints(values, what: str) -> list:
    try:
        out = [int(v) for v in values]
    except (TypeError, ValueError):
        raise _fail(f"{what} is not read: {values!r}") from None
    if any(o != v for o, v in zip(out, values)):
        raise _fail(f"{what} is not read: {values!r}")
    return out


class _Setup:
    """TiffImageFile._setup on IFD 0: the mode, raw mode and layout."""

    def __init__(self, ifd: _Ifd):
        self.ifd = ifd
        if 0xBC01 in ifd:
            raise _fail("Windows Media Photo files are not read")
        code = ifd.get(259, 1)
        try:
            self.compression = COMPRESSIONS[code]
        except (KeyError, TypeError):
            raise _fail(f"compression {code!r} is unknown") from None
        self.code = code
        self.planar = ifd.get(284, 1)
        photo = ifd.get(262, 0)
        if self.compression == "tiff_jpeg":
            photo = 6
        fillorder = ifd.get(266, 1)
        if 256 not in ifd or 257 not in ifd:
            raise _fail("missing dimensions")
        xsize, ysize = ifd.get(256), ifd.get(257)
        if not isinstance(xsize, int) or not isinstance(ysize, int):
            raise _fail("invalid dimensions")
        self.xsize, self.ysize = xsize, ysize
        self.orientation = ifd.get(274)
        sample_format = ifd.get(339, (1,))
        if (len(sample_format) > 1
                and max(sample_format) == min(sample_format) == 1):
            sample_format = (1,)
        bps = ifd.get(258, (1,))
        extra = ifd.get(338, ())
        bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1)
        bps_count += len(extra)
        spp = ifd.get(277, 3 if self.compression == "tiff_jpeg"
                      and photo in (2, 6) else 1)
        if spp > _MAX_SAMPLES:
            raise _fail("invalid value for samples per pixel")
        if spp < len(bps):
            bps = bps[:spp]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * spp
        if len(bps) != spp:
            raise _fail("unknown data organization")
        key = (ifd.prefix, photo, sample_format, fillorder, bps, extra)
        try:
            self.mode, rawmode = _OPEN[key]
        except (KeyError, TypeError):
            raise _fail(f"unknown pixel mode {key[1:]}") from None
        self.bps, self.bps_count = bps, bps_count
        xres, yres = ifd.get(282, 1), ifd.get(283, 1)
        if xres and yres and ifd.get(296) == 3:
            try:
                xres * 2.54, yres * 2.54
            except TypeError:
                raise _fail("resolution is not a number") from None
        self.libtiff = self.compression != "raw"
        if self.libtiff:
            if fillorder == 2:
                key = key[:3] + (1,) + key[4:]
                self.mode, rawmode = _OPEN[key]
            if (photo == 6 and self.compression == "jpeg"
                    and self.planar == 1):
                rawmode = "RGB"
            elif rawmode == "I;16":
                rawmode = "I;16N"
            elif rawmode.endswith((";16B", ";16L")):
                rawmode = rawmode[:-1] + "N"
        self.rawmode = rawmode
        self.tiles = [] if self.libtiff else self._raw_tiles()
        self.palette = None
        if self.mode in ("P", "PA"):
            if 320 not in ifd:
                raise _fail("a palette image without a colour map")
            cmap = ifd.get(320)
            entries = bytes((b // 256) & 255 for b in _ints(cmap, "ColorMap"))
            n = len(entries) // 3
            if n > 256:
                raise _fail("invalid palette size")
            self.palette = np.zeros((256, 3), np.uint8)
            self.palette[:n] = np.frombuffer(entries[:3 * n], np.uint8
                                             ).reshape(3, n).T

    def _raw_tiles(self) -> list:
        """Pillow's tiles of an uncompressed file: (extents, offset, raw
        mode, stride)."""
        ifd = self.ifd
        xsize, ysize = self.xsize, self.ysize
        if 273 in ifd:
            offsets = ifd.get(273)
            h, w = ifd.get(278, ysize), xsize
        elif 324 in ifd:
            offsets = ifd.get(324)
            w, h = ifd.get(322), ifd.get(323)
            if not isinstance(w, int) or not isinstance(h, int):
                raise _fail("invalid tile dimensions")
        else:
            raise _fail("unknown data organization")
        offsets = _ints(offsets if isinstance(offsets, (tuple, bytes))
                        else (offsets,), "offsets")
        if not isinstance(h, int):
            raise _fail(f"rows per strip {h!r} are not read")
        if w == xsize and h == ysize and self.planar != 2:
            offsets = offsets[-1:]
        tiles = []
        x = y = layer = 0
        for offset in offsets:
            stride = w * sum(self.bps) / 8 if x + w > xsize else 0
            rawmode = self.rawmode
            if self.planar == 2:
                if layer >= len(self.rawmode):
                    raise _fail("more planes than the raw mode has")
                rawmode = self.rawmode[layer]
                stride /= self.bps_count
            tiles.append(((x, y, min(x + w, xsize), min(y + h, ysize)),
                          offset, rawmode, int(stride)))
            x += w
            if x >= xsize:
                x, y = 0, y + h
                if y >= ysize:
                    y = 0
                    layer += 1
        return tiles


# ---------------------------------------------------------------------------
# Pillow's unpackers and conversions
# ---------------------------------------------------------------------------

def _bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """Packed samples of ``depth`` bits, MSB first, as (n, width)."""
    if depth == 8:
        return rows[:, :width]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width]


def _unpremultiply(px: np.ndarray) -> np.ndarray:
    """Pillow's unpackRGBa: each of R, G, B times 255 over alpha, clipped;
    0 where alpha is 0."""
    a = px[..., 3:4].astype(np.int32)
    rgb = np.minimum(px[..., :3].astype(np.int32) * 255
                     // np.maximum(a, 1), 255)
    rgb = np.where(a == 0, 0, np.where(a == 255, px[..., :3], rgb))
    out = px.copy()
    out[..., :3] = rgb
    out[..., 3:4] = np.where(a == 0, 0, a)
    return out


def _unpack(mode: str, rawmode: str, rows: np.ndarray, width: int):
    """Pillow's unpacker on (n, row bytes) uint8 rows: (n, width) values
    of a one-band mode, (n, width, 4) bytes of the others, or (band,
    (n, width)) for one band of a planar file."""
    n = rows.shape[0]
    if (mode, rawmode) in _BAND:
        return _BAND[mode, rawmode], rows[:, :width]
    if rawmode in _BIT_REVERSED:   # FillOrder 2: each byte's bits reversed
        rows = _REVERSE[rows]
        rawmode = _BIT_REVERSED[rawmode]
    if mode in ("1", "L", "P"):
        invert = rawmode.endswith("I") and rawmode != "I"
        base = rawmode[:-1] if invert else rawmode
        depth = {"1": 1, "L": 8, "P": 8, "L;2": 2, "L;4": 4, "P;1": 1,
                 "P;2": 2, "P;4": 4, "PX": 16}[base.rstrip(";")]
        if depth == 16:
            v = rows[:, :2 * width:2]
        else:
            v = _bits(rows, width, depth)
        if mode == "1":
            v = np.where(v != 0, 255, 0).astype(np.uint8)
        elif base in ("L;2", "L;4"):
            v = v * np.uint8(85 if base == "L;2" else 17)
        return (255 - v).astype(np.uint8) if invert else v.astype(np.uint8)
    if mode in ("I;16", "I;16B"):
        if rawmode == "I;12":
            b = rows[:, :(3 * width + 1) // 2 + 1].astype(np.uint16)
            b = np.pad(b, ((0, 0), (0, 2)))
            k = np.arange(width)
            i = (3 * k) // 2
            even = (b[:, i] << 4) | (b[:, i + 1] >> 4)
            odd = ((b[:, i] & 0x0F) << 8) | b[:, i + 1]
            return np.where(k % 2 == 0, even, odd).astype(np.uint16)
        dt = ">u2" if rawmode == "I;16B" else "<u2"
        return np.ascontiguousarray(rows[:, :2 * width]).view(dt).astype(
            np.uint16)
    if mode == "I":
        dt = {"I": "<i4", "I;16S": "<i2", "I;16BS": ">i2", "I;32N": "<i4",
              "I;32S": "<i4", "I;32BS": ">i4"}[rawmode]
        size = np.dtype(dt).itemsize
        return np.ascontiguousarray(rows[:, :size * width]).view(dt).astype(
            np.int32)
    if mode == "F":
        dt = ">f4" if rawmode == "F;32BF" else "<f4"
        return np.ascontiguousarray(rows[:, :4 * width]).view(dt).astype(
            np.float32)
    out = np.zeros((n, width, 4), np.uint8)
    if mode in ("LA", "PA"):
        px = rows[:, :2 * width].reshape(n, width, 2)
        out[..., 0] = px[..., 0]
        out[..., 3] = px[..., 1]
        return out
    letters = rawmode.split(";")[0]
    if rawmode.endswith(("16L", "16B", "16N")):
        k = len(letters)
        px = rows[:, :2 * k * width].reshape(n, width, k, 2)
        px = px[..., 0 if rawmode.endswith("16B") else 1]
    else:
        k = len(letters)
        px = rows[:, :k * width].reshape(n, width, k)
    take = 4 if mode in ("RGBA", "CMYK") else 3
    out[..., :take] = px[..., :take]
    if mode == "RGBA" and "a" in letters:
        out = _unpremultiply(out)
    return out


def _to_rgb(img: np.ndarray, mode: str, palette) -> np.ndarray:
    """PIL's convert("RGB") of an image of ``mode`` as ``_unpack`` lays
    it out."""
    if mode in ("P", "PA"):
        return palette[img if mode == "P" else img[..., 0]]
    if mode == "LAB":
        raise _fail("CIELab is not read")
    if mode == "LA":
        return mode_to_rgb(img[..., :1], "L")
    if mode in ("RGB", "RGBA", "CMYK"):
        return mode_to_rgb(img, mode)
    return mode_to_rgb(img[..., None], "I" if mode.startswith("I") else mode)


def _transpose(rgb: np.ndarray, orientation) -> np.ndarray:
    """ImageOps.exif_transpose's method for the Orientation tag."""
    method = {2: 0, 3: 1, 4: 2, 5: 3, 6: 4, 7: 5, 8: 6}.get(orientation)
    if method is None:
        return rgb
    out = (rgb[:, ::-1], rgb[::-1, ::-1], rgb[::-1],
           rgb.transpose(1, 0, 2), np.rot90(rgb, -1),
           rgb[::-1, ::-1].transpose(1, 0, 2), np.rot90(rgb, 1))[method]
    return np.ascontiguousarray(out)


def _new_image(mode: str, h: int, w: int) -> np.ndarray:
    if _BANDS[mode] > 1:
        return np.zeros((h, w, 4), np.uint8)
    dt = {"I;16": np.uint16, "I;16B": np.uint16, "I": np.int32,
          "F": np.float32}.get(mode, np.uint8)
    return np.zeros((h, w), dt)


def _put(img: np.ndarray, y0: int, x0: int, values) -> None:
    if isinstance(values, tuple):
        band, v = values
        img[y0:y0 + v.shape[0], x0:x0 + v.shape[1], band] = v
    else:
        img[y0:y0 + values.shape[0], x0:x0 + values.shape[1]] = values


# ---------------------------------------------------------------------------
# Pillow's raw route (compression 1)
# ---------------------------------------------------------------------------

def _raw_decode(data: bytes, s: _Setup) -> np.ndarray:
    """ImageFile.load over Pillow's tiles of an uncompressed file: sorted
    by offset, a tile followed by one of the same extent and raw mode
    dropped, each read by the raw decoder (rows of the unpacker's bytes,
    ``stride`` apart where it is given) until its extent is full."""
    tiles = sorted(s.tiles, key=lambda t: t[1])
    kept = [t for i, t in enumerate(tiles)
            if i + 1 == len(tiles) or (tiles[i + 1][0], tiles[i + 1][2],
                                       tiles[i + 1][3]) != (t[0], t[2], t[3])]
    plans = []
    for (x0, y0, x1, y1), offset, rawmode, stride in kept:
        if x0 == 0 and x1 == 0:   # decode.c setimage: the whole image
            x1, y1 = s.xsize, s.ysize
        if x1 <= x0 or y1 <= y0 or x1 > s.xsize or y1 > s.ysize:
            raise _fail("tile cannot extend outside image")
        if (s.mode, rawmode) not in _UNPACKERS:
            raise _fail(f"unknown raw mode {rawmode!r} for {s.mode}")
        linesize = (_UNPACKERS[s.mode, rawmode] * (x1 - x0) + 7) // 8
        step = stride or linesize
        if step < linesize:
            raise _fail("a stride shorter than a row")
        rows = y1 - y0
        if offset + step * (rows - 1) + linesize > len(data):
            raise _fail("image file is truncated")
        plans.append((x0, y0, x1, rows, offset, rawmode, step, linesize))
    img = _new_image(s.mode, s.ysize, s.xsize)
    buf = np.frombuffer(data, np.uint8)
    for x0, y0, x1, rows, offset, rawmode, step, linesize in plans:
        view = np.lib.stride_tricks.as_strided(
            buf[offset:], (rows, linesize), (step, 1), writeable=False)
        _put(img, y0, x0, _unpack(s.mode, rawmode, view, x1 - x0))
    return img


# ---------------------------------------------------------------------------
# libtiff's route (every other compression)
# ---------------------------------------------------------------------------

# The decoded bytes of an image's strips or tiles held at once; a batch
# holds at least one with its planes (Pillow holds one, a tile of at most
# 2 GiB)
_BATCH_BYTES = 1 << 24


class _Layout:
    """What libtiff takes from its directory to read the strips or tiles,
    with its checks (TIFFReadDirectory, TIFFReadEncodedStrip/Tile) and
    Pillow's (ImagingLibTiffDecode)."""

    def __init__(self, data: bytes, s: _Setup):
        if data[:4] not in (b"II\x2a\x00", b"MM\x00\x2a", b"II\x2b\x00",
                            b"MM\x00\x2b"):
            raise _fail(f"libtiff: bad header {data[:4]!r}")
        ifd = s.ifd
        if ifd.big and struct.unpack(ifd.order + "HH", data[4:8]) != (8, 0):
            raise _fail("libtiff: bad BigTIFF header")
        lt = _LibtiffDir(ifd)
        self.lt = lt
        spp = lt.value(277, 1, short=True)
        if spp == 0:
            raise _fail("libtiff: SamplesPerPixel 0")
        code = lt.value(259, 1, persample=spp, short=True)
        width, height = lt.value(256), lt.value(257)
        if height is None:
            raise _fail("libtiff: no ImageLength")
        if (width, height) != (s.xsize, s.ysize):
            raise _fail("libtiff: another size than Pillow's")
        tw, tl = lt.value(322), lt.value(323)
        planar = lt.value(284, 1, short=True)
        if planar not in (1, 2):
            raise _fail(f"libtiff: PlanarConfiguration {planar}")
        rps = lt.value(278, 2 ** 32 - 1)
        if rps == 0:
            raise _fail("libtiff: RowsPerStrip 0")
        extra = lt.ints(338) if 338 in lt.entries else []
        if extra is None or len(extra) > spp or any(
                e not in (0, 1, 2, 999) for e in extra):
            raise _fail("libtiff: bad ExtraSamples")
        bits = lt.value(258, 1, persample=spp, short=True)
        self.sample_format = lt.value(339, 1, persample=spp, short=True)
        for tag in (280, 281):   # Min/MaxSampleValue, as BitsPerSample
            lt.value(tag, 0, persample=spp, short=True)
        for tag in (340, 341):   # SMin/SMaxSampleValue: one a sample
            if tag in lt.entries and (
                    lt.entries[tag][1] != spp or lt.entries[tag][0] not in (
                        1, 3, 4, 5, 6, 8, 9, 10, 11, 12, 16, 17)
                    or lt.raw(tag)[2] is None):
                raise _fail(f"libtiff: cannot read tag {tag}")
        if code not in READ_COMPRESSIONS or code == 1:
            raise _fail(f"compression {code} "
                        f"({COMPRESSIONS.get(code, 'unknown')}) is not read")
        if code != s.code:
            raise _fail("libtiff: another compression than Pillow's")
        self.photo = lt.soft(262)
        if self.photo == 3:   # a palette needs its colour map, read whole
            cmap = lt.ints(320) if 258 in lt.entries else None
            if (cmap is None or len(cmap) != 3 << bits) and bits < 8:
                raise _fail("libtiff: no Colormap")
        self.fillorder = lt.soft(266, 1)
        if self.fillorder not in (1, 2):
            self.fillorder = 1
        self.predictor = lt.soft(317, 1) if code in _PREDICTED else 1
        t4 = lt.ints(292) if code == 3 else None   # T4Options
        self.t4options = t4[0] if t4 and len(t4) == 1 else 0
        # tif_jpeg.c: the sampling the JPEG frames must have (YCbCr: the
        # YCbCrSubsampling tag, or the first strip's where it is absent;
        # other colours 1 x 1; each plane of a planar file 1 x 1)
        sub = lt.ints(530) if self.photo == 6 else [1, 1]
        hv = sub if sub and len(sub) == 2 and all(
            0 < v < 16 for v in sub) else [0, 0]
        self.jpeg_options = (1 << 8 if planar == 2 else
                             hv[0] | hv[1] << 4)
        tables = lt.raw(347)
        self.tables = (tables[2] if code == 7 and tables and tables[0] == 7
                       and tables[2] else b"")
        self.extra = extra
        self.tiled = tw is not None or tl is not None
        if self.tiled:
            if not tw or not tl:
                raise _fail(f"tiles of {tw}x{tl}")
            seg_w, rows_per = tw, tl
        else:
            seg_w, rows_per = width, min(rps, height)
        self.rps = rps
        self.spp, self.bits, self.planar = spp, bits, planar
        self.seg_w, self.rows_per = seg_w, rows_per
        self.nx = -(-width // seg_w)
        self.ny = -(-height // rows_per)
        planes = spp if planar == 2 else 1
        n = self.nx * self.ny * planes
        offset_tag, count_tag = (324, 325) if self.tiled else (273, 279)
        for tag in (offset_tag, count_tag):   # TIFFFetchStripThing
            if tag in lt.entries and lt.entries[tag][1] < n > \
                    _STRILE_MAX_RESIZE:
                raise _fail(f"libtiff: incorrect count for tag {tag} "
                            f"({lt.entries[tag][1]} for {n} strips or tiles)")
        if count_tag not in lt.entries:
            if not ((planar == 1 and n == 1) or
                    (planar == 2 and n == planes)):
                raise _fail("libtiff: no StripByteCounts")
        elif n > 1 and lt.entries[count_tag][1] < self.nx * self.ny * (
                _BANDS[s.mode] if planar == 2 and _BANDS[s.mode] > 1 and
                self.photo != 6 else 1):
            # the strips or tiles past the tag's count have 0 bytes, which
            # libtiff cannot read (TIFFFillStrip/Tile), where the decode
            # reads them (the planes of the mode's bands; TIFFRGBAImage
            # goes on past a later plane's): refused before n of anything
            raise _fail("a strip or tile of 0 bytes")
        offsets = lt.striles(offset_tag, n)
        if offsets is None:
            raise _fail("libtiff: no strip or tile offsets")
        counts = lt.striles(count_tag, n)
        if counts is None or (n == 1 and not self.tiled and counts[0] == 0
                              and offsets[0] != 0):
            counts = self._estimate(lt, offsets, n, planes, planar)
        self.offsets, self.counts = offsets, counts

    def _estimate(self, lt, offsets, n, planes, planar):
        """EstimateStripByteCounts for a compressed file: what the
        directory leaves of the file, shared by the planes, the last strip
        cut at the file's end (one strip, or one a plane)."""
        space = (16 + 8 + lt.count * 20 + 8 if lt.big
                 else 8 + 2 + lt.count * 12 + 4)
        for typ, count, _ in lt.entries.values():
            width = _LT_WIDTH.get(typ, 0)
            if not width:
                raise _fail("libtiff: a tag of unknown type")
            size = width * count
            space += 0 if size <= (8 if lt.big else 4) else size
        size = len(lt.data)
        space = size if size < space else size - space
        if planar == 2:
            space //= planes
        counts = np.full(n, space, np.uint64)
        last = int(offsets[n - 1])
        if last + space > size:
            counts[-1] = 0 if last >= size else size - last
        return counts


def _predictor(rows: np.ndarray, lay: _Layout, stride: int, order: str):
    """libtiff's predictor module and byte swapping on decoded (n, row
    bytes) rows: the samples in the host's (little-endian) order."""
    predictor, bits = lay.predictor, lay.bits
    if predictor not in (1, 2, 3):
        raise _fail(f"predictor {predictor!r} is not read")
    if predictor == 1:
        if bits in (16, 32, 64) and order == ">":
            size = bits // 8
            n = rows.shape[0]
            return np.ascontiguousarray(rows[:, :rows.shape[1] // size * size]
                                        .reshape(n, -1, size)[:, :, ::-1]
                                        ).reshape(n, -1)
        return rows
    n, width = rows.shape
    if predictor == 2:
        if bits not in (8, 16, 32, 64):
            raise _fail(f"horizontal predictor with {bits}-bit samples")
        size = bits // 8
        if width % (size * stride):
            raise _fail("a row not of whole pixels")
        v = np.ascontiguousarray(rows).view(f"{order}u{size}").reshape(
            n, -1, stride)
        v = np.cumsum(v, axis=1, dtype=v.dtype.newbyteorder("="))
        return v.astype(f"<u{size}").view(np.uint8).reshape(n, width)
    if bits not in (16, 24, 32, 64) or lay.sample_format != 3:
        raise _fail("floating point predictor of these samples")
    size = bits // 8
    if width % (size * stride):
        raise _fail("a row not of whole pixels")
    acc = np.cumsum(rows.reshape(n, -1, stride), axis=1,
                    dtype=np.uint8).reshape(n, width)
    planes = acc.reshape(n, size, width // size)
    return np.ascontiguousarray(planes[:, ::-1].transpose(0, 2, 1)).reshape(
        n, width)


def _libtiff_decode(data: bytes, s: _Setup) -> np.ndarray:
    """ImagingLibTiffDecode: every strip or tile decoded in Pillow's order
    (rows of strips, or of tiles, then planes), then unpacked."""
    from mastermetastyletransfer_tpu_torch.data import native_loader

    lay = _Layout(data, s)
    w, h = s.xsize, s.ysize
    ycbcr = lay.photo == 6
    jpeg = s.code == 7
    if ycbcr and not (jpeg and lay.planar == 1):
        return _rgba_decode(data, s, lay)
    if s.code in _CCITT and lay.bits != 1:   # Fax3SetupState
        raise _fail("CCITT: bits per sample must be 1")
    if s.mode == "LAB":
        raise _fail("CIELab is not read")
    rawmode = s.rawmode
    planar = lay.planar == 2 and _BANDS[s.mode] > 1
    planes = _BANDS[s.mode] if planar else 1
    if planar and lay.bits not in (8, 16):
        raise _fail(f"planar samples of {lay.bits} bits")
    if (s.mode, rawmode) not in _UNPACKERS:
        raise _fail(f"unknown raw mode {rawmode!r} for {s.mode}")
    per_plane = 1 if lay.planar == 2 else lay.spp
    colour = 1 if jpeg and ycbcr else 2
    channels = 3 if colour == 1 else per_plane
    seg_w, rows_per, nx, ny = lay.seg_w, lay.rows_per, lay.nx, lay.ny
    row_bytes = (seg_w * lay.bits * per_plane + 7) // 8
    if jpeg:
        row_bytes = seg_w * channels
    unpacker_bits = _UNPACKERS[s.mode, rawmode]
    if lay.tiled:   # TiffDecode.c _decodeTile: the tile against the mode
        if rows_per * row_bytes > 2 ** 31 - 2:
            raise _fail("a tile of more than 2 GiB (IMAGING_CODEC_MEMORY)")
        if rows_per * row_bytes > (
                (rows_per * unpacker_bits // planes + 7) // 8) * seg_w:
            raise _fail("tile size is too large for the mode")
    elif row_bytes != (seg_w * unpacker_bits // planes + 7) // 8:
        raise _fail("scanline size is not the unpacker's row size")
    elif lay.rps != 2 ** 32 - 1 and (
            lay.rps >= 2 ** 31 or min(lay.rps, h) > (2 ** 31 - 1) // row_bytes):
        raise _fail("rows per strip overflow the strip buffer")
    # the strips or tiles in Pillow's order: rows of them, then planes
    yi = np.repeat(np.arange(ny), nx * planes)
    xi = np.tile(np.repeat(np.arange(nx), planes), ny)
    index = yi * nx + xi + np.tile(np.arange(planes), nx * ny) * (nx * ny)
    rows = (np.full(len(yi), rows_per) if lay.tiled
            else np.minimum(rows_per, h - yi * rows_per))
    table = np.zeros(len(yi), native_loader.TIFF_CHUNK)
    table["offset"], table["count"] = lay.offsets[index], lay.counts[index]
    table["need"], table["width"], table["height"] = (rows * row_bytes,
                                                      seg_w, rows)
    table["last"] = (yi == ny - 1) & (not lay.tiled)
    counts = table["count"]
    if (counts == 0).any():
        raise _fail("a strip or tile of 0 bytes")
    full = rows_per * row_bytes   # TIFFFillStrip/Tile: a count too large
    counts[(counts > 1 << 20) & ((counts - 4096) // 10 > full)] = (
        full * 10 + 4096)
    size = np.uint64(len(data))
    if ((table["offset"] > size)
            | (counts > size - np.minimum(table["offset"], size))).any():
        raise _fail("read error: a strip or tile runs past the file")
    img = _new_image(s.mode, h, w)
    unpackers = ([rawmode] if not planar else
                 [("R", "G", "B", "A")[p] for p in range(planes)])
    table = table.reshape(ny, nx, planes)
    carried = np.zeros(0, np.uint8)   # the strip buffer Pillow reuses
    with native_loader.TiffState() as state:   # libtiff's, strip to strip
        for batch in _batches(lay, planes, row_bytes):
            _decode_batch(data, s, lay, table, batch, planar, planes,
                          unpackers, colour, channels, per_plane, row_bytes,
                          img, carried, state)
    if planar and s.mode == "RGBA" and lay.extra and lay.extra[0] in (0, 1):
        img = _unpremultiply(img)   # TiffDecode.c: planar RGBa to RGBA
    return img


def _decode_batch(data, s, lay, table, batch, planar, planes, unpackers,
                  colour, channels, per_plane, row_bytes, img, carried,
                  state):
    """One batch of _libtiff_decode's strips or tiles: decoded, the
    predictor undone, unpacked into img. ``carried`` holds the last
    strip's bytes of the batch before (Pillow's strip buffer), updated in
    place."""
    from mastermetastyletransfer_tpu_torch.data import native_loader

    w, h = s.xsize, s.ysize
    seg_w, rows_per = lay.seg_w, lay.rows_per
    y0, y1, x0, x1 = batch
    part = np.ascontiguousarray(table[y0:y1, x0:x1]).reshape(-1)
    out = np.zeros(int(part["need"].sum()), np.uint8)
    if s.code in (8, 32946, 34925):
        at = 0
        for offset, count, need in zip(   # one step a strip or tile
                part["offset"].tolist(), part["count"].tolist(),
                part["need"].tolist()):
            raw = data[offset:offset + count]
            if lay.fillorder == 2:
                raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
            out[at:at + need] = np.frombuffer(
                _inflate(raw, need) if s.code != 34925
                else _unxz(raw, need), np.uint8)
            at += need
    else:
        # CCITT and JPEG: a strip that ends early (T.6) or a frame smaller
        # than its strip keeps the rest of the buffer from the strip
        # decoded before it
        carry = s.code in _CCITT or s.code == 7
        first = int(part["need"][0])
        out[:min(first, carried.size)] = carried[:first]
        native_loader.decode_tiff(
            s.code, data, part, lay.fillorder == 2, lay.tables, colour,
            channels, out, carry=carry, state=state,
            options=lay.jpeg_options if s.code == 7 else lay.t4options)
        if carry:
            last = out[out.size - int(part["need"][-1]):]
            carried.resize(last.size, refcheck=False)
            carried[:] = last
    decoded = _predictor(out.reshape(-1, row_bytes), lay, per_plane,
                         s.ifd.order)
    for p, unpacker in enumerate(unpackers):
        if lay.tiled:   # rows y0 * rows_per on, tiles x0 to x1
            top = y0 * rows_per
            tiles = decoded.reshape(y1 - y0, x1 - x0, planes, rows_per,
                                    row_bytes)
            for x in range(x0, x1):   # one step a column of tiles
                column = tiles[:, x - x0, p]
                block = (column[0] if y1 - y0 == 1 else
                         column.reshape(-1, row_bytes))[:h - top]
                _put_plane(img, top, x * seg_w, s.mode, unpacker, block,
                           min(seg_w, w - x * seg_w), planar, p,
                           lay.bits)
        else:   # strips y0 to y1, from row y0 * rows_per
            top = y0 * rows_per
            part = (_planar_rows(decoded, y1 - y0, planes, rows_per,
                                 h - top, p) if planar else decoded)
            _put_plane(img, top, 0, s.mode, unpacker, part, w, planar, p,
                       lay.bits)


# libtiff's YCbCr subsamplings that TIFFRGBAImage has a put function for,
# chunky (putcontig8bitYCbCr44tile ... 11tile) and planar (11 only), with
# the bytes each put function skips, a block row of a clipped tile, for
# every hs columns clipped (4x4's is 4 * 2 + 2, as libtiff has it)
_YCC_SKIP = {(4, 4): 10, (4, 2): 10, (4, 1): 6, (2, 2): 6, (2, 1): 4,
             (1, 2): 4, (1, 1): 3}
_YCC_CONTIG = set(_YCC_SKIP)


def _ycbcr_tables(lt: _LibtiffDir):
    """tif_color.c TIFFYCbCrToRGBInit, in its float and fixed-point
    arithmetic: (Y_tab, Cr_r, Cb_b, Cr_g, Cb_g), each 256 entries."""
    f32 = np.float32
    luma = [f32(0.299), f32(0.587), f32(0.114)]
    got = lt.raw(529)
    if got and got[0] == 5 and got[1] == 3 and got[2] is not None:
        nums = struct.unpack(f"{lt.order}6L", got[2])
        luma = [f32(f32(a) / f32(b)) if b else f32(0)   # 0 over 0: 0
                for a, b in zip(nums[::2], nums[1::2])]
    ref = [f32(v) for v in (0, 255, 128, 255, 128, 255)]
    got = lt.raw(532)
    if got and got[0] == 5 and got[1] == 6 and got[2] is not None:
        nums = struct.unpack(f"{lt.order}12L", got[2])
        ref = [f32(f32(a) / f32(b)) if b else f32(0)
               for a, b in zip(nums[::2], nums[1::2])]
    if any(np.isnan(v) for v in luma) or luma[1] == 0:
        raise _fail("libtiff: invalid YCbCrCoefficients")
    if any(not f32(-0x7FFFFFFF + 128) < v < f32(0x7FFFFFFF) for v in ref):
        raise _fail("libtiff: invalid ReferenceBlackWhite")

    def fix(x):   # FIX(x): (int32)(x * (1 << 16) + 0.5), the sum in double
        return int(np.float64(f32(x) * f32(65536)) + 0.5)

    def clamp(v, lo, hi):
        return lo if v < lo else hi if v > hi else v

    def code2v(c, rb, rw, cr):   # in float, RB cut to an integer first
        span = f32(rw) - f32(rb)
        return f32(f32(c - int(rb)) * f32(cr)) / (span if span != 0 else
                                                  f32(1))

    f1 = f32(2) - f32(2) * luma[0]
    d1 = fix(clamp(f1, f32(0), f32(2)))
    d2 = -fix(clamp(f32(luma[0] * f1) / luma[1], f32(0), f32(2)))
    f3 = f32(2) - f32(2) * luma[2]
    d3 = fix(clamp(f3, f32(0), f32(2)))
    d4 = -fix(clamp(f32(luma[2] * f3) / luma[1], f32(0), f32(2)))
    tabs = np.zeros((5, 256), np.int64)
    for i in range(256):   # one step a table entry (256)
        x = i - 128
        cr = int(clamp(code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127),
                       f32(-128 * 32), f32(128 * 32)))
        cb = int(clamp(code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127),
                       f32(-128 * 32), f32(128 * 32)))
        tabs[0, i] = int(clamp(code2v(x + 128, ref[0], ref[1], 255),
                               f32(-128 * 32), f32(128 * 32)))
        tabs[1, i] = (d1 * cr + (1 << 15)) >> 16
        tabs[2, i] = (d3 * cb + (1 << 15)) >> 16
        tabs[3, i] = d2 * cr
        tabs[4, i] = d4 * cb + (1 << 15)
    return tabs


def _rgba_decode(data: bytes, s: _Setup, lay: _Layout) -> np.ndarray:
    """Pillow's _decodeAsRGBA (libtiff's TIFFRGBAImage, started with
    stoponerr 0): a YCbCr file not JPEG-compressed, read in Pillow's blocks
    (a strip, or a row of tiles): a strip or tile whose codec fails keeps
    what it wrote, zeros after it (the codecs clear the rest); one that
    cannot be read is zeros, or, first in its block, stops the read; the
    predictor
    undone where the codec succeeded; the 8-bit YCbCr blocks of the
    subsampling turned to RGB through TIFFYCbCrtoRGB's tables, opaque, a
    clipped tile's block rows as far apart as libtiff's put function
    steps; Pillow's unpacker of its mode ("RGBX" for YCbCr) on each row
    of the RGBA. The Orientation tag is not applied here (Pillow
    transposes the image after)."""
    from mastermetastyletransfer_tpu_torch.data import native_loader

    lt = lay.lt
    w, h = s.xsize, s.ysize
    sub = lt.ints(530)   # libtiff's default where it cannot read a pair
    hs, vs = sub if sub and len(sub) == 2 else (2, 2)
    if lay.bits != 8 or lay.spp != 3:
        raise _fail("TIFFRGBAImage: YCbCr other than 8-bit, 3 samples")
    if _UNPACKERS.get((s.mode, s.rawmode), 64) > 32:
        raise _fail(f"unknown raw mode {s.rawmode!r} for {s.mode} on RGBA")
    if lay.sample_format == 3:
        raise _fail("TIFFRGBAImage: floating point samples")
    if s.code == 6:
        raise _fail("compression 6 (tiff_jpeg, old-style JPEG) is not read")
    if s.code in _CCITT:   # Fax3SetupState, before the first strip's buffer
        raise _fail("CCITT: bits per sample must be 1")
    if lay.planar == 2 and (hs, vs) != (1, 1) or (hs, vs) not in _YCC_CONTIG:
        raise _fail(f"TIFFRGBAImage: YCbCr subsampling {hs}x{vs} of "
                    f"planar configuration {lay.planar}")
    if lay.predictor == 3:
        raise _fail("floating point predictor of these samples")
    rps = lay.rows_per
    if lay.tiled and rps > (2 ** 31 - 1) // (4 * w) or not lay.tiled and (
            lay.rps != 2 ** 32 - 1 and lay.rps >= 2 ** 31):
        raise _fail("rows per block overflow the RGBA buffer")
    planes = 3 if lay.planar == 2 else 1
    seg_w = lay.seg_w
    if planes == 3:
        block, blocks_h, scan = 1, seg_w, seg_w
    else:
        block, blocks_h = hs * vs + 2, -(-seg_w // hs)
        scan = blocks_h * block // vs   # TIFFScanlineSize, cut
    # PredictorSetup: the predictor's rows (TIFFTileRowSize for tiles,
    # not cut to the subsampling) and samples
    pred_row = seg_w * (3 if planes == 1 else 1) if lay.tiled else scan
    pred_stride = 3 if planes == 1 else 1
    tabs = _ycbcr_tables(lt)
    rgba = np.zeros((h, w, 4), np.uint8)
    rgba[..., 3] = 255
    with native_loader.TiffState() as state:   # libtiff's, strip to strip
        _rgba_blocks(data, s, lay, rgba, tabs, hs, vs, planes, block,
                     blocks_h, scan, pred_row, pred_stride, state)
    img = _new_image(s.mode, h, w)   # Pillow's unpacker on the RGBA rows
    _put(img, 0, 0, _unpack(s.mode, s.rawmode, rgba.reshape(h, 4 * w), w))
    return img


def _rgba_blocks(data, s, lay, rgba, tabs, hs, vs, planes, block, blocks_h,
                 scan, pred_row, pred_stride, state) -> None:
    """_rgba_decode's blocks (a strip, or a row of tiles, each) into
    rgba."""
    w, h = s.xsize, s.ysize
    rps, seg_w = lay.rows_per, lay.seg_w
    nx = lay.nx if lay.tiled else 1
    for yi in range(lay.ny):   # one step a block of Pillow's
        top = yi * rps
        rows = min(rps, h - top)
        full = (-(-rps // vs) * blocks_h * block if lay.tiled else
                -(-rows // vs) * blocks_h * block if planes == 1
                else rows * w)
        need = (full if lay.tiled else
                min(-(-rows // vs) * vs * scan, full))
        buf = np.zeros((planes, full), np.uint8)
        for xi in range(nx):   # one step a strip, or a tile of the row
            for p in range(planes):
                index = (yi * nx + xi) + p * lay.ny * nx
                offset = int(lay.offsets[index])
                count = int(lay.counts[index])
                if count > 1 << 20 and (count - 4096) // 10 > full:
                    count = full * 10 + 4096   # TIFFFillStrip's limit
                if count == 0 or offset + count > len(data):
                    if xi == 0 and p == 0:   # before the block's buffer
                        raise _fail(f"read error on strip or tile {index}")
                buf[p, :need] = 0   # TIFFReadEncodedTile clears a failed one
                if count == 0 or offset + count > len(data):
                    continue
                ok = _decode_into(data, s.code, lay, offset, count, need,
                                  seg_w, rows, buf[p, :need], state)
                if ok and lay.predictor == 2:
                    _predict_in_place(buf[p, :need], lay, pred_row,
                                      pred_stride)
            x0 = xi * seg_w
            cols = min(seg_w, w - x0)
            yy = np.arange(rows)[:, None]
            xx = np.arange(cols)[None, :]
            if planes == 3:
                at = np.minimum(yy * seg_w + xx, full - 1)
                ycc = np.stack([buf[k][at] for k in range(3)], -1)
            else:
                # the put function's steps: whole blocks along a block row,
                # then the clipped columns' skip
                step = (-(-cols // hs) * block
                        + (seg_w - cols) // hs * _YCC_SKIP[hs, vs])
                at = (yy // vs) * step + (xx // hs) * block
                luma = np.minimum(at + (yy % vs) * hs + xx % hs, full - 1)
                cb = np.minimum(at + hs * vs, full - 1)
                ycc = np.stack([buf[0][luma], buf[0][cb],
                                buf[0][np.minimum(cb + 1, full - 1)]], -1)
            yv, cb, cr = (ycc[..., k].astype(np.int64) for k in range(3))
            y_tab = tabs[0][yv]
            rgb = np.stack([y_tab + tabs[1][cr],
                            y_tab + ((tabs[4][cb] + tabs[3][cr]) >> 16),
                            y_tab + tabs[2][cb]], -1)
            rgba[top:top + rows, x0:x0 + cols, :3] = np.clip(rgb, 0, 255)


def _decode_into(data, code, lay, offset, count, need, width, rows, out,
                 state) -> bool:
    """One strip or tile through its codec into ``out`` (its first
    ``need`` bytes), keeping what the codec wrote where it fails (False);
    ``out`` past that keeps what it held."""
    from mastermetastyletransfer_tpu_torch.data import native_loader

    if code in (8, 32946):
        return _inflate_partial(data, offset, count, need, lay.fillorder,
                                out)
    if code == 34925:
        return _unxz_partial(data, offset, count, need, lay.fillorder, out)
    chunk = np.array([(offset, count, need, width, rows, 0, 0)],
                     native_loader.TIFF_CHUNK)
    status = native_loader.decode_tiff(code, data, chunk,
                                       lay.fillorder == 2, lay.tables, 2, 1,
                                       out, tolerant=True, state=state,
                                       options=lay.jpeg_options)
    return not status[0] & 1


def _predict_in_place(buf: np.ndarray, lay: _Layout, row: int,
                      stride: int) -> None:
    """PredictorDecodeTile's horAcc8 on a decoded strip or tile: each row
    of ``row`` bytes summed along itself ``stride`` bytes apart; nothing
    where the strip is not whole rows, or a row not whole samples (libtiff
    then fails the strip after its codec wrote it)."""
    if row <= 0 or buf.size % row or row % stride:
        return
    rows = buf.reshape(-1, row // stride, stride)
    np.cumsum(rows, axis=1, dtype=np.uint8, out=rows)


def _inflate_partial(data, offset, count, need, fillorder, out) -> bool:
    """ZIPDecode on one strip into ``out``, keeping what inflate wrote
    before an error or the end of the data (libtiff's TIFFRGBAImage goes
    on past a failed strip); whether the strip decoded: whole, and with
    no error from zlib (which reads on to a block's end and the stream's
    check in the call that fills the strip)."""
    if count == 0 or offset + count > len(data):
        return False
    raw = data[offset:offset + count]
    if fillorder == 2:
        raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
    inflater, got, failed = zlib.decompressobj(), [], False
    try:
        got.append(inflater.decompress(raw, need))
    except zlib.error:   # again a byte at a time, for the bytes before it
        inflater, got, failed = zlib.decompressobj(), [], True
        try:
            for k in range(len(raw)):   # only on a damaged stream
                got.append(inflater.decompress(raw[k:k + 1],
                                               need - sum(map(len, got))))
                if sum(map(len, got)) >= need:
                    break
        except zlib.error:
            pass
    buf = b"".join(got)[:need]
    out[:len(buf)] = np.frombuffer(buf, np.uint8)
    return len(buf) == need and not failed


def _inflate(raw: bytes, need: int) -> bytes:
    """ZIPDecode on one strip: exactly ``need`` bytes or a refusal."""
    try:
        got = zlib.decompressobj().decompress(raw, need)
    except zlib.error as e:
        raise _fail(f"Deflate: decoding error ({e})") from None
    if len(got) < need:
        raise _fail("Deflate: not enough data")
    return got


# liblzma's smallest dictionary (LZMA_DICT_SIZE_MIN)
_XZ_DICT_MIN = 4096


def _vli(data: bytes, pos: int):
    """An xz variable-length integer at pos: (value, next pos), or None."""
    value = 0
    for k in range(9):   # at most 9 bytes
        if pos + k >= len(data):
            return None
        value |= (data[pos + k] & 0x7F) << (7 * k)
        if not data[pos + k] & 0x80:
            return value, pos + k + 1
    return None


def _xz_bounded(raw: bytes, need: int) -> bytes:
    """The xz stream with its first block's LZMA2 dictionary cut to the
    smallest that holds ``need`` bytes, where it declares a larger one:
    liblzma would allocate the declared size (up to 4 GiB) before the
    first byte, and the decoder never reaches back more than ``need``
    bytes, so the pixels are the same. The block header is left as it is
    where its CRC32 does not hold (liblzma refuses it)."""
    if len(raw) < 13 or raw[:6] != b"\xfd7zXZ\x00" or raw[12] == 0:
        return raw
    size = (raw[12] + 1) * 4
    header = bytearray(raw[12:12 + size])
    if len(header) < size or zlib.crc32(header[:-4]) != int.from_bytes(
            header[-4:], "little"):
        return raw
    pos = 2
    for bit in (0x40, 0x80):   # the compressed and uncompressed sizes
        if header[1] & bit:
            got = _vli(header, pos)
            if got is None:
                return raw
            pos = got[1]
    bound = max(need, _XZ_DICT_MIN)
    for _ in range((header[1] & 3) + 1):   # one step a filter (4 at most)
        fid, psize = _vli(header, pos) or (None, None), None
        if fid[0] is None:
            return raw
        got = _vli(header, fid[1])
        if got is None:
            return raw
        psize, pos = got
        if fid[0] == 0x21 and psize == 1 and pos < size - 4:
            prop = header[pos]
            if prop <= 40 and (2 | prop & 1) << (prop // 2 + 11) > bound:
                header[pos] = next(k for k in range(41)
                                   if (2 | k & 1) << (k // 2 + 11) >= bound)
        pos += psize
    header[-4:] = zlib.crc32(header[:-4]).to_bytes(4, "little")
    return raw[:12] + bytes(header) + raw[12 + size:]


class _LzmaStream(ctypes.Structure):
    """liblzma's lzma_stream."""
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t),
                ("total_in", ctypes.c_uint64), ("next_out", ctypes.c_void_p),
                ("avail_out", ctypes.c_size_t),
                ("total_out", ctypes.c_uint64),
                ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p),
                ("reserved", ctypes.c_void_p * 4),
                ("seek_pos", ctypes.c_uint64), ("reserved_int", ctypes.c_uint64),
                ("reserved_size", ctypes.c_size_t * 2),
                ("reserved_enum", ctypes.c_int * 2)]


_LIBLZMA = {}


def _liblzma():
    """liblzma, the library the standard library's lzma module wraps,
    through ctypes: tif_lzma.c keeps what lzma_code wrote in a call that
    ends in an error, which the lzma module drops."""
    if "lib" not in _LIBLZMA:
        name = ctypes.util.find_library("lzma") or "liblzma.so.5"
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            raise RuntimeError(f"liblzma (for LZMA TIFF strips) is not "
                               f"found: {e}") from None
        lib.lzma_stream_decoder.argtypes = [
            ctypes.POINTER(_LzmaStream), ctypes.c_uint64, ctypes.c_uint32]
        lib.lzma_code.argtypes = [ctypes.POINTER(_LzmaStream), ctypes.c_int]
        lib.lzma_end.argtypes = [ctypes.POINTER(_LzmaStream)]
        _LIBLZMA["lib"] = lib
    return _LIBLZMA["lib"]


def _unxz(raw: bytes, need: int) -> bytes:
    """LZMADecode (tif_lzma.c) on one strip: exactly ``need`` bytes or a
    refusal. libtiff stops once the strip is whole: data past it is not
    read, and an error that liblzma reports with the strip whole (a bad
    check of a block that ends there) does not count."""
    out = np.zeros(need, np.uint8)
    if not _xz_into(raw, need, out):
        raise _fail("LZMA: decoding error or not enough data")
    return out.tobytes()


def _xz_into(raw: bytes, need: int, out: np.ndarray) -> bool:
    """LZMADecode (tif_lzma.c) of one strip's stream into ``out``: one
    xz stream, lzma_code run until the stream ends, an error, or the strip
    is whole; what it wrote stays in ``out``. Whether the strip is whole
    (an error reported with the strip whole does not count, as there).
    The decoder's memory is held to what a dictionary of ``need`` bytes
    asks (a later block that declares more is refused: ROADMAP,
    differences from JAX)."""
    lib = _liblzma()
    raw = _xz_bounded(raw, need)
    stream = _LzmaStream()
    limit = 2 * max(need, _XZ_DICT_MIN) + (16 << 20)
    if lib.lzma_stream_decoder(ctypes.byref(stream), limit, 0) != 0:
        raise _fail("LZMA: the decoder does not start")
    src = np.frombuffer(raw, np.uint8)
    stream.next_in, stream.avail_in = src.ctypes.data, src.size
    stream.next_out, stream.avail_out = out.ctypes.data, need
    try:
        while stream.avail_out:   # lzma_code until it stops
            if lib.lzma_code(ctypes.byref(stream), 0) != 0:   # LZMA_RUN
                break   # the stream's end, an error, or no progress
    finally:
        lib.lzma_end(ctypes.byref(stream))
    return stream.avail_out == 0


def _unxz_partial(data, offset, count, need, fillorder, out) -> bool:
    """LZMADecode on one strip into ``out``, keeping what liblzma wrote
    before an error or the end of the data (TIFFRGBAImage goes on past a
    failed strip); whether the strip decoded whole."""
    if count == 0 or offset + count > len(data):
        return False
    raw = data[offset:offset + count]
    if fillorder == 2:
        raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
    return _xz_into(raw, need, out)


def _batches(lay: _Layout, planes: int, row_bytes: int):
    """The strips or tiles decoded together, as (first row, end row, first
    column, end column) of them: rows of them, or runs of tiles in one
    row, of about _BATCH_BYTES (at least one strip or tile)."""
    ny, nx = lay.ny, lay.nx
    each = planes * lay.rows_per * row_bytes   # a strip or tile, all planes
    if nx * each <= _BATCH_BYTES:
        k = _BATCH_BYTES // (nx * each)
        return [(y, min(y + k, ny), 0, nx) for y in range(0, ny, k)]
    k = max(1, _BATCH_BYTES // each)
    return [(y, y + 1, x, min(x + k, nx))   # one step a batch
            for y in range(ny) for x in range(0, nx, k)]


def _planar_rows(rows, ny, planes, rps, h, p):
    """Plane p's rows of a planar file's strips, decoded in Pillow's
    order (each row of strips, then each plane)."""
    sizes = [min(rps, h - y * rps) for y in range(ny)]
    starts = np.cumsum([0] + [n * planes for n in sizes])[:-1]
    picks = [rows[st + p * n:st + (p + 1) * n]
             for st, n in zip(starts, sizes)]
    return np.concatenate(picks) if len(picks) > 1 else picks[0]


def _put_plane(img, y0, x0, mode, rawmode, rows, width, planar, band,
               bits):
    """Rows from row y0 of the image at column x0: one plane into its
    band (libtiff's route: the RGBA band unpackers), or every band."""
    if planar:
        v = rows[:, 1:2 * width:2] if bits == 16 else rows[:, :width]
        img[y0:y0 + v.shape[0], x0:x0 + width, band] = v
        return
    _put(img, y0, x0, _unpack(mode, rawmode, rows, width))


def read_tiff(data: bytes) -> np.ndarray:
    """IFD 0 of a TIFF file as uint8 (H, W, 3) RGB, as PIL's
    convert("RGB") gives it."""
    try:   # Pillow fails on tag values of the wrong kind as well
        ifd = _Ifd(data)
        s = _Setup(ifd)
    except (TypeError, IndexError, KeyError, struct.error,
            OverflowError) as e:
        raise _fail(f"bad tag values ({type(e).__name__}: {e})") from None
    w, h = s.xsize, s.ysize
    if w <= 0 or h <= 0:
        raise _fail(f"an image of {w}x{h} pixels")
    if w * h > MAX_PIXELS:
        raise _fail(f"an image of {w}x{h} pixels is above the limit of "
                    f"{MAX_PIXELS} (a decompression bomb)")
    if s.code not in READ_COMPRESSIONS:
        raise _fail(f"compression {s.code} ({s.compression}) is not read")
    img = _libtiff_decode(data, s) if s.libtiff else _raw_decode(data, s)
    return _transpose(_to_rgb(img, s.mode, s.palette), s.orientation)
