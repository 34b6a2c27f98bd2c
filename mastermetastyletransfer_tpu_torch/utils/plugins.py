"""Pillow's image plugins that the port does not read, as far as
``data.pipeline.decode_image`` needs them to try its kinds in Pillow's
order (the machine with the card has no PIL).

``Image.open`` tries each plugin in turn: one whose ``_accept`` refuses
the first 16 bytes is skipped; otherwise its ``_open`` runs, and a
SyntaxError, IndexError, TypeError or struct.error there (KeyError and
EOFError too, which ImageFile turns into SyntaxError, as it does an image
of no mode or of no pixels) passes the bytes on to the next plugin, while
anything else ends the search: the file opens, or is refused. So
``takes(data)`` below is true where Pillow's search ends at that plugin,
and the port then refuses the bytes by the plugin's name.

* Most plugins: their ``_accept``, one line each (``ACCEPT``); once it
  holds, the port takes their ``_open`` to end the search. PCX's, DCX's
  and QOI's serve the port's readers of them too (``data/pipeline.py``).
* CUR, PCX and GBR, whose ``_accept`` holds for common TGA headers: also
  the checks of their ``_open`` that pass bytes on (PCX's: the header and
  its bounding box, which ``utils/pcx.py`` starts from).
* IM, IMT, IPTC, PCD and SPIDER, which have no ``_accept``: the checks of
  their ``_open``, with the same exceptions as Pillow's (a ValueError of
  ``int()`` in IM's or IMT's header ends the search, as it does there).
"""

from __future__ import annotations

import math
import re
import struct

from mastermetastyletransfer_tpu_torch.utils.png import OpenRefusal


def _u16le(b: bytes, i: int = 0) -> int:
    return struct.unpack_from("<H", b, i)[0]


def _u32le(b: bytes, i: int = 0) -> int:
    return struct.unpack_from("<I", b, i)[0]


def _u16be(b: bytes, i: int = 0) -> int:
    return struct.unpack_from(">H", b, i)[0]


def _u32be(b: bytes, i: int = 0) -> int:
    return struct.unpack_from(">I", b, i)[0]


# Each plugin's _accept on the first 16 bytes (Pillow 12.1)
ACCEPT = {
    "AVIF": lambda p: p[4:8] == b"ftyp" and p[8:12] in (
        b"avif", b"avis", b"mif1", b"msf1"),
    "BLP": lambda p: p.startswith((b"BLP1", b"BLP2")),
    "BUFR": lambda p: p.startswith((b"BUFR", b"ZCZC")),
    "CUR": lambda p: p.startswith(b"\0\0\2\0"),
    "PCX": lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5),
    "DCX": lambda p: len(p) >= 4 and _u32le(p) == 0x3ADE68B1,
    "DDS": lambda p: p.startswith(b"DDS "),
    "EPS": lambda p: p.startswith(b"%!PS") or (
        len(p) >= 4 and _u32le(p) == 0xC6D3D0C5),
    "FITS": lambda p: p.startswith(b"SIMPLE"),
    "FLI": lambda p: (len(p) >= 16 and _u16le(p, 4) in (0xAF11, 0xAF12)
                      and _u16le(p, 14) in (0, 3)),
    "FTEX": lambda p: p.startswith(b"FTEX"),
    "GBR": lambda p: len(p) >= 8 and _u32be(p, 0) >= 20 and _u32be(p, 4) in (
        1, 2),
    "GRIB": lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
    "HDF5": lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"),
    "JPEG2000": lambda p: p.startswith(
        (b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")),
    "ICNS": lambda p: p.startswith(b"icns"),
    "MCIDAS": lambda p: p.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04"),
    "MPEG": lambda p: p.startswith(b"\x00\x00\x01\xb3"),
    "MSP": lambda p: p.startswith((b"DanM", b"LinS")),
    "PIXAR": lambda p: p.startswith(b"\200\350\000\000"),
    "PSD": lambda p: p.startswith(b"8BPS"),
    "QOI": lambda p: p.startswith(b"qoif"),
    "SGI": lambda p: len(p) >= 2 and _u16be(p) == 474,
    "SUN": lambda p: len(p) >= 4 and _u32be(p) == 0x59A66A95,
    "WMF": lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00",
                                   b"\x01\x00\x00\x00")),
    "XBM": lambda p: p.lstrip().startswith(b"#define"),
    "XPM": lambda p: p.startswith(b"/* XPM */"),
    "XVTHUMB": lambda p: p.startswith(b"P7 332"),
}


def _passes(check) -> bool:
    """Run an _open's checks: False where they raise one of the
    exceptions Image.open passes over."""
    try:
        return check()
    except (IndexError, TypeError, KeyError, struct.error, OpenRefusal):
        return False


def _cur(data: bytes) -> bool:
    """CurImageFile._open: the entry Pillow picks, its bitmap as
    BmpImageFile._bitmap reads it, the height halved."""
    from mastermetastyletransfer_tpu_torch.utils.bmp import bitmap

    def check():
        m, pos = b"", 6
        for _ in range(_u16le(data[:6], 4)):   # one step an entry
            s = data[pos:pos + 16]
            pos += len(s)
            if not m:
                m = s
            elif s[0] > m[0] and s[1] > m[1]:
                m = s
        if not m:
            return False   # TypeError: no cursors were found
        try:
            rgb, _ = bitmap(data, _u32le(m, 12), halve=True)
        except OpenRefusal:
            return False
        except ValueError:
            return True
        return rgb.shape[0] > 0
    return _passes(check)


def _pcx(data: bytes) -> bool:
    """PcxImageFile._open: the bounding box, then the mode."""
    def check():
        s = data[:68]
        x0, y0, x1, y1 = (_u16le(s, 4), _u16le(s, 6), _u16le(s, 8) + 1,
                          _u16le(s, 10) + 1)
        if x1 <= x0 or y1 <= y0:
            return False   # bad PCX image size
        s[65], _u16le(s, 66)
        return True
    return _passes(check)


def _gbr(data: bytes) -> bool:
    """GbrImageFile._open: the header of a GIMP brush."""
    def check():
        header_size, version = _u32be(data, 0), _u32be(data, 4)
        if header_size < 20 or version not in (1, 2):
            return False
        width, height, depth = (_u32be(data, 8), _u32be(data, 12),
                                _u32be(data, 16))
        if width <= 0 or height <= 0 or depth not in (1, 4):
            return False
        if version == 2:
            if data[20:24] != b"GIMP":
                return False
            _u32be(data, 24)
        return True
    return _passes(check)


# ImImagePlugin's header keys (TAGS) and its line syntax
_IM_TAGS = {"Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type"}
_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


def _im_number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)   # a ValueError here ends Pillow's search


def _im(data: bytes) -> bool:
    """ImImageFile._open: the text header, then the image data's start."""
    if b"\n" not in data[:100]:
        return False
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    n, pos = 0, 0
    s = b""
    while True:   # one step a header line
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            return False
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _IM_LINE.match(s)
        if not m:
            return False
        k = m.group(1).decode("latin-1", "replace")
        v = m.group(2).decode("latin-1", "replace")
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            try:
                v = tuple(_im_number(x) for x in v.replace("*", ",").split(
                    ","))
            except ValueError:
                return True
            if len(v) == 1:
                v = v[0]
        if k != "Comment":
            info[k] = v
        n += k in _IM_TAGS
    if not n:
        return False
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        return False   # file truncated
    if "Lut" in info and len(data) - pos < 768:
        return False   # the palette's bytes past the data: IndexError
    size, mode = info["Image size (x*y)"], info["Image type"]
    try:
        return bool(mode) and not (size[0] <= 0 or size[1] <= 0)
    except TypeError:   # a size of one number
        return False


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt(data: bytes) -> bool:
    """ImtImageFile._open: key/value lines until the image data."""
    buffer, pos = data[:100], 100
    if b"\n" not in buffer:
        return False
    size, mode = [0, 0], ""
    while True:   # one step a header line
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos:pos + 1]
            pos += len(s)
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            more = data[pos:pos + 100]
            buffer, pos = buffer + more, pos + len(more)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                size[0] = int(v)
            elif k == b"height":
                size[1] = int(v)
        except ValueError:
            return True
        if k == b"pixel" and v == b"n8":
            mode = "L"
    return bool(mode) and size[0] > 0 and size[1] > 0


def _iptc(data: bytes) -> bool:
    """IptcImageFile._open: the IPTC/NAA fields, then the image's."""
    def field(pos):
        s = data[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\x00"):
            return None, 0, pos
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise IndexError("invalid IPTC/NAA file")   # SyntaxError
        size = s[3]
        if size > 132:
            raise ValueError("illegal field length")     # OSError
        if size == 128:
            size = 0
        elif size > 128:
            c = data[pos:pos + size - 128]
            pos += len(c)
            size = _u32be((b"\0\0\0\0" + c)[-4:])
        else:
            size = _u16be(s, 3)
        return tag, size, pos

    def getint(info, key):
        c = info[key]
        return _u32be((b"\0\0\0\0" + c)[-4:])

    def check():
        info, pos = {}, 0
        while True:   # one step a field
            tag, size, pos = field(pos)
            if not tag or tag == (8, 10):
                break
            tagdata = None
            if size:
                tagdata = data[pos:pos + size]
                pos += len(tagdata)
            if tag in info:
                if isinstance(info[tag], list):
                    info[tag].append(tagdata)
                else:
                    info[tag] = [info[tag], tagdata]
            else:
                info[tag] = tagdata
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode = ""
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            if (3, 65) in info:
                info[(3, 65)][0] - 1
        size = getint(info, (3, 20)), getint(info, (3, 30))
        try:
            if getint(info, (3, 120)) not in (1, 5):
                raise KeyError
        except KeyError:
            return True   # OSError: unknown IPTC image compression
        return bool(mode) and size[0] > 0 and size[1] > 0
    try:
        return _passes(check)
    except ValueError:
        return True


def _pcd(data: bytes) -> bool:
    """PcdImageFile._open: "PCD_" at 2048 and the orientation byte."""
    return data[2048:2052] == b"PCD_" and len(data) >= 2048 + 1539


def _spider_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _spider_header(t) -> int:
    """SpiderImagePlugin.isSpiderHeader: the header's bytes, or 0."""
    h = (99,) + t
    if not all(_spider_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _spider(data: bytes) -> bool:
    """SpiderImageFile._open: 27 floats of either byte order."""
    f = data[:108]
    if len(f) < 108:
        return False
    t = struct.unpack(">27f", f)
    if not _spider_header(t):
        t = struct.unpack("<27f", f)
        if not _spider_header(t):
            return False
    h = (99,) + t
    if int(h[5]) != 1:
        return False
    try:
        istack, imgnumber = int(h[24]), int(h[27])
    except (ValueError, OverflowError):
        return True   # ends Pillow's search
    if istack < 0 or imgnumber < 0 or (istack > 0 and imgnumber > 0):
        return False  # inconsistent stack header values
    if istack == 0 and imgnumber > 0:
        return True   # an attribute Pillow has not set: AttributeError
    if istack > 0 and not _spider_int(h[26]) and (
            math.isnan(h[26]) or math.isinf(h[26])):
        return True   # int() of the stack's image count fails
    return int(h[12]) > 0 and int(h[2]) > 0


# the plugins with more than their _accept to decide
_OPEN = {"CUR": _cur, "PCX": _pcx, "GBR": _gbr, "IM": _im, "IMT": _imt,
         "IPTC": _iptc, "PCD": _pcd, "SPIDER": _spider}


def takes(name: str, data: bytes) -> bool:
    """Whether Pillow's search for a plugin ends at ``name``'s."""
    accept = ACCEPT.get(name)
    if accept is not None and not accept(data[:16]):
        return False
    check = _OPEN.get(name)
    return True if check is None else check(data)
