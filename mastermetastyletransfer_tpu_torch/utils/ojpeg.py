"""Old-style JPEG TIFF (compression 6) for the port's TIFF reader, as
libtiff's tif_ojpeg.c reads it for Pillow (the machine with the card has
neither; ``utils/tiff.py`` calls this for compression 6).

libtiff does not hand the file's JPEG to libjpeg as it is. It reads the
stream's markers itself (``OJPEGReadHeaderInfoSec``) from a byte source
that is the JPEGInterchangeFormat's bytes (tags 513 and 514; an offset
past the file drops them, a length of 0 or past the file runs to its
end), then every strip's bytes in turn (a strip at offset 0 or past the
file skipped, a byte count of 0 or past the file running to its end):

* SOI is skipped, APPn and COM skipped by their length, DRI read (its
  interval kept), each DQT table kept as a segment of its own (a length
  of 65 bytes a table, Tq of at most 3), each DHT segment kept whole
  under its first table's class and id, SOF0, SOF1 or SOF3 checked
  against the directory (its samples, 8 bits, at least the image's or the
  strips' height, exactly the strips' width, the sampling factors), SOS
  checked (its length and components) and its component ids and tables
  kept; any other marker, a byte other than 0xFF where a marker is due,
  or the source's end refuses the file;
* the YCbCr subsampling is the SOF's (``OJPEGSubsamplingCorrect``, which
  reads the stream once before), where its first component's factors are
  1, 2 or 4 and the others 1 x 1; otherwise libjpeg upsamples and libtiff
  reports 1 x 1 (``subsampling_force_desubsampling_inside_decompression``);
* strips of fewer rows than the image must be a whole number of iMCU rows
  (8 x the vertical factor), and then the restart interval is one strip's
  MCUs unless the stream's DRI gives one.

libjpeg then reads a stream libtiff writes (``OJPEGWriteStream``): SOI,
the kept DQT segments (tables 0 to 3), the DHT segments (DC 0 to 3, AC 0
to 3), DRI where the interval is not 0, an SOF of the kept marker, height,
width, component ids, factors and tables, an SOS of the kept ids and
tables with Ss 0, Se 63, Ah and Al 0, then the source's bytes after the
SOS: the rest of the piece the SOS was in, and each strip after it, an
RSTn (n from 0, modulo 8) after every strip but the last and EOI after
the last, again and again. libjpeg reads it with ``raw_data_out``
(``native/jpeg.cpp``'s ``decode_planes``: the components at their own
size, no upsampling, no colour conversion), or for one component, or the
forced desubsampling, its full decode with the components as stored; the
rows past those the image needs are not decoded (the frame's height is
cut to them, which changes nothing before them).

Each strip starts a new iMCU row (``OJPEGPreDecode``); libtiff lays a
YCbCr strip out in its subsampled blocks (``OJPEGDecodeRaw``: per block
hs x vs luma samples, then Cb and Cr), which TIFFRGBAImage turns to RGB
as for any YCbCr file (``utils/tiff._rgba_blocks``).
"""

from __future__ import annotations

import struct

import numpy as np

_SOF = (0xC0, 0xC1, 0xC3)


def _fail(why: str) -> ValueError:
    return ValueError(f"TIFF: old-style JPEG: {why}")


def _long8(lt, tag: int) -> int:
    """A JPEGInterchangeFormat tag as TIFFFetchNormalTag reads it (one
    unsigned 64-bit integer of any integer type); 0 where it is absent or
    libtiff ignores it (another count, type or a negative value)."""
    v = lt.ints(tag)
    return v[0] if v is not None and len(v) == 1 and v[0] >= 0 else 0


class _Source:
    """OJPEGReadBufferFill's byte source: the JPEGInterchangeFormat's
    bytes, then each strip's; ``pieces`` of (bytes, is a strip)."""

    def __init__(self, data: bytes, lay):
        size = len(data)
        self.pieces = []
        jif, length = _long8(lay.lt, 513), _long8(lay.lt, 514)
        if jif >= size:
            jif = length = 0
        elif jif and (length == 0 or jif + length > size):
            length = size - jif
        if jif:
            self.pieces.append((data[jif:jif + length], False))
        # a strip libtiff cannot look up (no offsets or byte counts array)
        # fails the read there: the source ends
        for offset, count in zip(lay.offsets.tolist(), lay.counts.tolist()):
            if lay.unreadable:
                break
            if offset == 0 or offset >= size:
                self.pieces.append((b"", True))   # skipped, as libtiff does
                continue
            togo = size - offset if count == 0 else min(count, size - offset)
            self.pieces.append((data[offset:offset + togo], True))
        self.piece, self.at = 0, 0

    def byte(self) -> int:
        while self.piece < len(self.pieces):
            blob = self.pieces[self.piece][0]
            if self.at < len(blob):
                self.at += 1
                return blob[self.at - 1]
            self.piece, self.at = self.piece + 1, 0
        raise _fail("the stream ends in its header")

    def peek(self) -> int:
        value = self.byte()
        self.at -= 1
        return value

    def word(self) -> int:
        return self.byte() << 8 | self.byte()

    def block(self, n: int) -> bytes:
        return bytes(self.byte() for _ in range(n))

    def skip(self, n: int) -> None:
        """OJPEGReadSkip: at most what is left of the piece being read
        (libtiff does not skip into the next)."""
        if self.piece < len(self.pieces):
            self.at = min(self.at + n, len(self.pieces[self.piece][0]))

    def rest(self):
        """OJPEGWriteStreamCompressed from here on: (the data, an RSTn
        after each strip but the last, EOI after the last; whether the
        source ends first, where libjpeg reading on fails: "Premature end
        of JPEG data")."""
        out, rst = bytearray(), 0
        blob, strip = self.pieces[self.piece] if self.piece < len(
            self.pieces) else (b"", False)
        first = blob[self.at:]
        k = self.piece + 1
        pending = [(first, strip)] if first else []
        while True:
            for chunk, is_strip in pending:
                out += chunk
                if is_strip:
                    if any(s for _, s in self.pieces[k:]):
                        out += bytes([0xFF, 0xD0 + rst])
                        rst = (rst + 1) % 8
                    else:
                        return bytes(out) + b"\xff\xd9", False
            # OJPEGReadBufferFill: the next piece with data
            while k < len(self.pieces) and not self.pieces[k][0]:
                k += 1
            if k >= len(self.pieces):
                return bytes(out), True
            pending = [self.pieces[k]]
            k += 1


class Stream:
    """OJPEGReadHeaderInfo and OJPEGReadHeaderInfoSec on a file: the
    stream libjpeg reads and what libtiff keeps of the header."""

    def __init__(self, data: bytes, lay, width: int, height: int, spp: int,
                 ycbcr: bool):
        if lay.tiled or lay.planar != 1:
            raise _fail("tiles and planar files are not read")
        if spp not in (1, 3):
            raise _fail(f"{spp} samples per pixel")
        lt = lay.lt
        self.width, self.height = width, height
        self.strile = lay.rps if lay.rps != 2 ** 32 - 1 else height
        sub = lt.ints(530) if 530 in lt.entries else None
        hs, vs = (sub if sub and len(sub) == 2 else [2, 2]) if spp == 3 \
            else (1, 1)
        self.force = False
        if spp == 3 and ycbcr:   # OJPEGSubsamplingCorrect
            got = self._sampling(_Source(data, lay))
            if got is not None:
                hs, vs = got
        if spp == 3 and not ycbcr:
            hs, vs = 1, 1
        if self.force:
            hs, vs = 1, 1
        self.hs, self.vs = hs, vs
        restart = 0
        if self.strile < height:
            if hs not in (1, 2, 4) or vs not in (1, 2, 4):
                raise _fail("invalid subsampling values")
            if self.strile % (vs * 8):
                raise _fail("incompatible vertical subsampling and image "
                            "strip length")
            restart = -(-width // (hs * 8)) * (self.strile // (vs * 8))
        src = _Source(data, lay)
        self._header(src, spp, width, height, restart)
        self.rest, self.stop = src.rest()

    def _sampling(self, src: _Source):
        """The subsampling-correcting pass: the SOF's factors, or None
        where the pass stops first (its errors are silent)."""
        try:
            while True:
                if src.peek() != 0xFF:
                    return None
                src.byte()
                m = src.byte()
                while m == 0xFF:
                    m = src.byte()
                if m == 0xD8:
                    continue
                if m in _SOF:
                    n = src.word()
                    if n < 11 or (n - 8) % 3 or src.byte() != 8:
                        return None
                    src.skip(4)
                    count = src.byte()
                    if count != (n - 8) // 3:
                        return None
                    factors = []
                    for _ in range(count):   # one step a component
                        src.byte()
                        factors.append(src.byte())
                        src.byte()
                    first = factors[0] if factors else 0x22
                    h, v = first >> 4, first & 15
                    if h not in (1, 2, 4) or v not in (1, 2, 4) or any(
                            f != 17 for f in factors[1:]):
                        self.force = True
                        return 1, 1
                    return h, v
                if m == 0xDD:   # OJPEGReadHeaderInfoSecStreamDri
                    if src.word() != 4:
                        return None
                    src.word()
                    continue
                if m == 0xDA or not (m in (0xC4, 0xDB, 0xFE)
                                     or 0xE0 <= m <= 0xEF):
                    return None
                n = src.word()
                if n < 2 or (m in (0xC4, 0xDB) and n <= 2):
                    return None
                src.skip(n - 2)
        except ValueError:
            return None

    def _header(self, src: _Source, spp: int, width: int, height: int,
                restart: int) -> None:
        qt, dc, ac = [None] * 4, [None] * 4, [None] * 4
        sof = sos = None
        while True:   # one step a marker, to SOS
            if src.peek() != 0xFF:
                break
            src.byte()
            m = src.byte()
            while m == 0xFF:
                m = src.byte()
            if m == 0xD8:
                continue
            if m == 0xFE or 0xE0 <= m <= 0xEF:
                n = src.word()
                if n < 2:
                    raise _fail("corrupt JPEG data")
                src.skip(n - 2)
            elif m == 0xDD:
                if src.word() != 4:
                    raise _fail("corrupt DRI marker")
                restart = src.word()
            elif m == 0xDB:
                n = src.word()
                if n <= 2:
                    raise _fail("corrupt DQT marker")
                n -= 2
                while n > 0:   # one step a table of 64 bytes
                    if n < 65:
                        raise _fail("corrupt DQT marker")
                    table = src.block(65)
                    if table[0] & 15 > 3:
                        raise _fail("corrupt DQT marker")
                    qt[table[0] & 15] = b"\xff\xdb\x00\x43" + table
                    n -= 65
            elif m == 0xC4:
                n = src.word()
                if n <= 2:
                    raise _fail("corrupt DHT marker")
                body = src.block(n - 2)
                seg = bytes([0xFF, 0xC4, n >> 8, n & 255]) + body
                o = body[0]
                if o & 0xF0 == 0:
                    if o > 3:
                        raise _fail("corrupt DHT marker")
                    dc[o] = seg
                elif o & 0xF0 != 16 or o & 15 > 3:
                    raise _fail("corrupt DHT marker")
                else:
                    ac[o & 15] = seg
            elif m in _SOF:
                if sof is not None:
                    raise _fail("corrupt JPEG data (a second SOF)")
                sof = self._sof(src, m, spp, width, height)
            elif m == 0xDA:
                if sof is None:
                    raise _fail("corrupt SOS marker (no SOF before it)")
                if src.word() != 6 + 2 * spp or src.byte() != spp:
                    raise _fail("corrupt SOS marker")
                sos = [src.block(2) for _ in range(spp)]
                src.skip(3)   # Ss, Se, Ah and Al: not checked
                break
            else:
                raise _fail(f"unknown marker type {m} in JPEG data")
        if sof is None:
            raise _fail("no JPEG tables (no SOF before the data)")
        if sof[0] == 0xC3:
            raise _fail("a lossless frame (SOF3)")
        if sos is None:   # the loop left before an SOS: its fields are 0
            sos = [b"\0\0"] * spp
        marker, sof_y, sof_x, comps = sof
        # rows past those the strips ask for are not decoded
        imcu = 8 * max(c[1] & 15 for c in comps)
        sof_y = min(sof_y, -(-height // imcu) * imcu)
        head = bytearray(b"\xff\xd8")
        for seg in qt + dc + ac:
            if seg is not None:
                head += seg
        if restart:
            head += struct.pack(">BBHH", 0xFF, 0xDD, 4, restart)
        head += struct.pack(">BBHBHHB", 0xFF, marker, 8 + 3 * spp, 8, sof_y,
                            sof_x, spp)
        for c in comps:
            head += bytes(c)
        head += struct.pack(">BBHB", 0xFF, 0xDA, 6 + 2 * spp, spp)
        for s in sos:
            head += s
        head += b"\x00\x3f\x00"
        self.header = bytes(head)
        self.sof_x, self.sof_y = sof_x, sof_y

    def _sof(self, src: _Source, marker: int, spp: int, width: int,
             height: int):
        n = src.word()
        if n < 11 or (n - 8) % 3:
            raise _fail("corrupt SOF marker")
        if (n - 8) // 3 != spp:
            raise _fail("unexpected number of samples")
        if src.byte() != 8:
            raise _fail("unexpected number of bits per sample")
        sof_y = src.word()
        if sof_y < height:   # the strips' total height is the image's
            raise _fail("unexpected height")
        sof_x = src.word()
        if sof_x < width:
            raise _fail("unexpected width")
        if sof_x > width:
            raise _fail("image width exceeds expected image width")
        if src.byte() != spp:
            raise _fail("corrupt SOF marker")
        comps = []
        for q in range(spp):   # one step a component
            c, hv, tq = src.byte(), src.byte(), src.byte()
            if not self.force and hv != (
                    (self.hs << 4 | self.vs) if q == 0 else 17):
                raise _fail("unexpected subsampling values")
            comps.append((c, hv, tq))
        return marker, sof_y, sof_x, comps

    def planes(self, bound: int):
        """libjpeg's raw data of the stream: (planes, the iMCU row where
        the decode failed or -1)."""
        from mastermetastyletransfer_tpu_torch.data import native_loader

        return native_loader.decode_jpeg_planes(self.header + self.rest,
                                                bound, self.stop)


def ycbcr_blocks(st: Stream) -> np.ndarray:
    """The image's YCbCr strips as libtiff lays them out for
    TIFFRGBAImage: (block rows, blocks a row x (hs x vs + 2)) uint8, each
    strip's block rows from its first iMCU row; zeros in the last strip
    where the decode failed in it (OJPEGDecode clears it), a refusal where
    it failed in an earlier one."""
    hs, vs, w, h = st.hs, st.vs, st.width, st.height
    cols = -(-w // hs)
    if st.force:
        raise _fail("JPEG sampling factors libtiff desubsamples itself are "
                    "not read")
    bound = 3 * (-(-w // 8) * 8) * 8 * (-(-st.sof_y // 8) + 1) * 4
    planes, failed = st.planes(bound)
    if len(planes) != 3:
        raise _fail("not 3 components")
    y, cb, cr = planes
    nblock = -(-h // vs)
    if y.shape[0] < nblock * vs or y.shape[1] < cols * hs or cb.shape[
            0] < nblock or cb.shape[1] < cols:
        raise _fail("planes smaller than the image")
    luma = y[:nblock * vs, :cols * hs].reshape(nblock, vs, cols, hs)
    out = np.empty((nblock, cols, hs * vs + 2), np.uint8)
    out[..., :hs * vs] = luma.transpose(0, 2, 1, 3).reshape(nblock, cols,
                                                            hs * vs)
    out[..., hs * vs] = cb[:nblock, :cols]
    out[..., hs * vs + 1] = cr[:nblock, :cols]
    if failed >= 0:
        strip = failed * 8 * vs // st.strile
        if strip < -(-h // st.strile) - 1:
            # the next strip skips the failed one's rows first, which
            # fails again before TIFFRGBAImage has its buffer
            raise _fail(f"libjpeg fails in strip {strip}")
        out[strip * st.strile // vs:] = 0
    return out.reshape(nblock, cols * (hs * vs + 2))


def grey_rows(st: Stream) -> np.ndarray:
    """A one-sample file's rows (libjpeg's scanlines, the component as
    stored): (height, width) uint8; a failed decode refuses the file (its
    strip cannot be read)."""
    bound = (-(-st.width // 8) * 8) * (-(-st.sof_y // 8) * 8)
    planes, failed = st.planes(bound)
    if failed >= 0:
        raise _fail("the JPEG data ends early or its restart markers are "
                    "out of order")
    if len(planes) != 1:
        raise _fail("not 1 component")
    return planes[0][:st.height, :st.width]
