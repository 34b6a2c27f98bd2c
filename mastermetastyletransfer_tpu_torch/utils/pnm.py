"""The port's Netpbm reader (PBM, PGM, PPM, PFM), with numpy (the machine
with the card has no PIL).

``read_pnm`` reads every file that Pillow's PpmImagePlugin reads, as PIL's
``convert("RGB")`` gives it: the magics of its ``MODES`` (P1-P6, ``Pf``,
and Pillow's own ``P0CMYK``, ``PyP``, ``PyRGBA``, ``PyCMYK``); the header's
tokens as ``_read_token`` reads them (whitespace, ``#`` comments to the end
of a line, even inside a token, at most 10 bytes a token); plain (ASCII)
samples as ``PpmPlainDecoder`` parses them, 64 KiB block by block; raw
samples at a maxval of 255 as stored, at any other maxval scaled to 255
(or to 65535 for a grey image above 255, Pillow's mode ``I``) with
Python's rounding. The modes convert as Pillow converts them: ``1`` to 0
or 255 (a PBM's 1 is black), ``I`` and ``F`` clamped to 0..255 (``F``
truncated, NaN to 0), ``CMYK`` through Pillow's cmyk2rgb, ``RGBA`` without
its alpha, and ``P`` black (the file carries no palette). A PFM's scale
gives its byte order (negative: little-endian) and its rows run bottom to
top. What Pillow refuses raises ``ValueError``: an unknown magic, a bad or
overlong token, a maxval outside 1..65535, a plain sample above the
maxval, too few samples. So does an image above PIL's decompression-bomb
limit (``MAX_PIXELS``), and an image whose samples the file is too short
to hold, both before anything of its size is allocated.
"""

from __future__ import annotations

import math

import numpy as np

from mastermetastyletransfer_tpu_torch.utils.png import MAX_PIXELS

# PpmImagePlugin.MODES: magic -> Pillow's mode
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4,
          "CMYK": 4}
_SPACE = b" \t\n\x0b\x0c\r"
_BLOCK = 65536   # ImageFile.SAFEBLOCK: the plain decoder's read size
_MAX_TOKEN = 10
_SPACES = b" \t\n\r\x0b\x0c"   # what bytes.split() splits at
_POW10 = 10 ** np.arange(_MAX_TOKEN, dtype=np.int64)


def accept(prefix: bytes) -> bool:
    """PpmImagePlugin._accept."""
    return len(prefix) >= 2 and prefix[:1] == b"P" and prefix[1] in b"0123456fy"


def _fail(why: str) -> ValueError:
    return ValueError(f"PNM: {why}")


class _Header:
    """PpmImageFile._open on the bytes: the magic, then each token."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        magic = b""
        for _ in range(6):
            c = data[self.pos:self.pos + 1]
            self.pos += len(c)
            if not c or c in _SPACE:
                break
            magic += c
        if magic not in MODES:
            raise _fail(f"not a PPM file (magic {magic!r})")
        self.magic = magic

    def token(self) -> bytes:
        data, token = self.data, b""
        while len(token) <= _MAX_TOKEN:
            c = data[self.pos:self.pos + 1]
            self.pos += len(c)
            if not c:
                break
            if c in _SPACE:
                if not token:
                    continue
                break
            if c == b"#":   # to CR, LF or the end, the token going on
                ends = [i for i in (data.find(b"\r", self.pos),
                                    data.find(b"\n", self.pos)) if i >= 0]
                self.pos = min(ends) + 1 if ends else len(data)
                continue
            token += c
        if not token:
            raise _fail("reached EOF while reading header")
        if len(token) > _MAX_TOKEN:
            raise _fail(f"token too long in file header: {token!r}")
        return token


def _int(token: bytes) -> int:
    try:
        return int(token)
    except ValueError:
        raise _fail(f"not an integer: {token!r}") from None


def _comment_end(block: bytes, start: int = 0) -> int:
    """PpmPlainDecoder._find_comment_end, as it is."""
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


def _decimals(block: bytes, need: int):
    """A plain block's tokens where it holds only ASCII digits and
    whitespace, all at once: (the first ``need`` whole tokens' values,
    the token cut at the block's end); None where it holds anything else
    (signs, underscores: int() reads them; junk: refused), which is read
    a token at a time."""
    if block.translate(None, b"0123456789" + _SPACES):
        return None
    b = np.frombuffer(block, np.uint8)
    digit = np.zeros(len(b) + 2, bool)
    digit[1:-1] = b > 32   # digits lie above the whitespace
    edges = np.flatnonzero(digit[1:] != digit[:-1])
    starts, ends = edges[0::2], edges[1::2]
    half = b""
    if digit[-2]:   # the block ends inside a token
        half = block[starts[-1]:]
        if len(half) > _MAX_TOKEN:
            raise _fail("token too long found in data")
        starts, ends = starts[:-1], ends[:-1]
    starts, ends = starts[:need], ends[:need]
    lengths = ends - starts
    if not len(lengths):
        return np.zeros(0, np.int64), half
    if lengths.max() > _MAX_TOKEN:
        raise _fail("token too long found in data")
    at = np.flatnonzero(digit[1:ends[-1] + 1])   # the tokens' digits
    power = np.repeat(ends - 1, lengths) - at
    values = np.add.reduceat((b[at] - 48).astype(np.int64) * _POW10[power],
                             np.cumsum(lengths) - lengths)
    return values, half


class _Plain:
    """PpmPlainDecoder's block loop over the bytes from ``pos``: each
    64 KiB block with its comments taken out."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.spans = data, pos, False

    def block(self) -> bytes:
        block = self.data[self.pos:self.pos + _BLOCK]
        self.pos += len(block)
        return block

    def strip(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.block()
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block

    def bits(self, total: int) -> np.ndarray:
        """P1's digits: 0 white, 1 black, any whitespace between."""
        out = b""
        while len(out) != total:
            block = self.block()
            if not block:
                break
            tokens = b"".join(self.strip(block).split())
            bad = tokens.translate(None, b"01")
            if bad:
                raise _fail(f"invalid token for this mode: {bad[:1]!r}")
            out = (out + tokens)[:total]
        if len(out) < total:
            raise _fail("not enough image data")
        return np.frombuffer(out, np.uint8) == ord("1")

    def samples(self, total: int, maxval: int, out_max: int) -> np.ndarray:
        """P2's and P3's decimal samples, each scaled to ``out_max``: a
        block of digits and whitespace at once (``_decimals``), another
        token by token as Pillow reads it."""
        parts, n, half = [], 0, b""
        while n != total:
            block = self.block()
            if not block:
                if not half:
                    break
                block = b" "
            block = self.strip(block)
            if half:
                block, half = half + block, b""
            fast = _decimals(block, total - n)
            if fast is not None:
                values, half = fast
            else:
                tokens = block.split()
                if block and not block[-1:].isspace():
                    half = tokens.pop()
                    if len(half) > _MAX_TOKEN:
                        raise _fail("token too long found in data")
                tokens = tokens[:total - n]
                if any(len(t) > _MAX_TOKEN for t in tokens):
                    raise _fail("token too long found in data")
                values = np.fromiter(map(_int, tokens), np.int64, len(tokens))
                if values.size and values.min() < 0:
                    raise _fail("channel value is negative")
            if values.size and values.max() > maxval:
                raise _fail("channel value too large for this mode")
            parts.append(values)
            n += len(values)
        if n < total:
            raise _fail("not enough image data")
        return np.round(np.concatenate(parts) / maxval * out_max)


def _cmyk_to_rgb(px: np.ndarray) -> np.ndarray:
    """Pillow's cmyk2rgb: each of R, G, B is nk - c nk / 255 with
    nk = 255 - k, MULDIV255's rounding."""
    c = px[..., :3].astype(np.int32)
    nk = 255 - px[..., 3:4].astype(np.int32)
    t = c * nk + 128
    return np.clip(nk - ((t + (t >> 8)) >> 8), 0, 255).astype(np.uint8)


def mode_to_rgb(px: np.ndarray, mode: str) -> np.ndarray:
    """PIL's convert("RGB") of (H, W, bands) samples of ``mode`` (``1`` as
    0/255, ``L``, ``I``, ``F``, ``P`` without a palette, ``RGB``,
    ``RGBA``, ``CMYK``); utils/tiff.py converts its modes through it."""
    if mode == "F":
        px = np.nan_to_num(px[..., 0], nan=0.0)
        px = np.where(px >= 255, 255, np.where(px <= 0, 0, px))
        grey = px.astype(np.uint8)
    elif mode == "I":
        grey = np.clip(px[..., 0], 0, 255).astype(np.uint8)
    elif mode == "CMYK":
        return _cmyk_to_rgb(px)
    elif mode == "P":
        return np.zeros(px.shape[:2] + (3,), np.uint8)
    elif mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(px[..., :3], np.uint8)
    else:   # "1" as 0/255, "L"
        grey = px[..., 0].astype(np.uint8)
    return np.repeat(grey[:, :, None], 3, axis=2)


def read_pnm(data: bytes) -> np.ndarray:
    """A Netpbm file's pixels as uint8 (H, W, 3) RGB, as PIL's
    convert("RGB") gives them."""
    if not accept(data[:2]):
        raise _fail("not a PPM file")
    head = _Header(data)
    mode = MODES[head.magic]
    w, h = _int(head.token()), _int(head.token())
    if w <= 0 or h <= 0:
        raise _fail(f"an image of {w}x{h} pixels")
    if mode == "F":
        try:
            scale = float(head.token())
        except ValueError:
            raise _fail("scale is not a number") from None
        if scale == 0.0 or not math.isfinite(scale):
            raise _fail("scale must be finite and non-zero")
        maxval = 0
    elif mode != "1":
        maxval = _int(head.token())
        if not 0 < maxval < 65536:
            raise _fail("maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    if w * h > MAX_PIXELS:
        raise _fail(f"an image of {w}x{h} pixels is above the limit of "
                    f"{MAX_PIXELS} (a decompression bomb)")
    plain = head.magic in (b"P1", b"P2", b"P3")
    bands = _BANDS[mode]
    total = w * h * bands
    body = data[head.pos:]
    if plain and len(body) < total:   # a sample takes a byte at least
        raise _fail("not enough image data")
    if mode == "1":
        if plain:
            px = np.where(_Plain(data, head.pos).bits(w * h), 0, 255)
        else:
            stride = (w + 7) // 8
            if len(body) < stride * h:
                raise _fail("image file is truncated")
            rows = np.frombuffer(body, np.uint8, stride * h).reshape(h,
                                                                     stride)
            px = np.where(np.unpackbits(rows, axis=1)[:, :w], 0, 255)
        return mode_to_rgb(px.reshape(h, w, 1).astype(np.uint8), mode)
    if mode == "F":
        if len(body) < 4 * total:
            raise _fail("image file is truncated")
        px = np.frombuffer(body, "<f4" if scale < 0 else ">f4", total)
        return mode_to_rgb(px.reshape(h, w, 1)[::-1], mode)
    out_max = 65535 if mode == "I" else 255
    if plain:
        px = _Plain(data, head.pos).samples(total, maxval, out_max)
    elif maxval == 255:
        if len(body) < total:
            raise _fail("image file is truncated")
        px = np.frombuffer(body, np.uint8, total)
    elif maxval == 65535 and mode == "I":   # Pillow's raw "I;16B"
        if len(body) < 2 * total:
            raise _fail("image file is truncated")
        px = np.frombuffer(body, ">u2", total)
    else:   # PpmDecoder: whole pixels until the image or the file ends
        size = 1 if maxval < 256 else 2
        if len(body) < size * total:
            raise _fail("not enough image data")
        raw = np.frombuffer(body, np.uint8 if size == 1 else ">u2", total)
        px = np.minimum(out_max, np.round(raw / maxval * out_max))
    return mode_to_rgb(px.reshape(h, w, bands), mode)
