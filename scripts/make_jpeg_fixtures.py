"""Write the JPEG fixtures under tests/data/jpeg/ with PIL, and PIL's
decoded pixels beside them (pixels.npz, compressed), from a fixed seed;
and two larger sources with the JAX package's loader's batches of them
(prescale.npz, compressed).

    python scripts/make_jpeg_fixtures.py [--out tests/data/jpeg]

chip_smoke.py's ``codecs`` phase holds the port's decoder to the stored
pixels, and the port's batch loader to the stored batches, on the machine
with the card, which has neither PIL nor libjpeg; the CPU tests
(tests/test_torch_codecs.py) check that PIL still decodes each file to
them and that the JAX loader still gives the batches. One file per decoder
route: 4:4:4, 4:2:2, 4:2:0 and 4:4:0 chroma sampling, grayscale, an odd
size at quality 50, restart intervals, and progressive files (4:2:0,
4:4:4, grayscale, one with restart intervals). PIL cannot write 4:4:0: that
file is PIL's 4:2:2 JPEG of the transposed size with its frame header's
size swapped and its luminance sampling set to 1x2, which leaves the
entropy-coded data a valid 4:4:0 scan.

The prescale sources (``src_*.jpg``: a baseline 4:2:0 and a progressive
4:2:2 file) are read by the JAX loader (libjpeg, its DCT-domain prescale)
at one target per scale n/8, n = 1..8: the smallest target at which its
loop picks n (``prescale_targets``). Their batches are stored as
``<source>_<target>`` in prescale.npz.

The kinds that PIL reads but does not write go to tests/data/jpeg_kinds/,
PIL's pixels in its pixels.npz: arithmetic-coded files (sequential and
progressive, with restarts), CMYK (PIL's, with its Adobe marker, and one
without), YCCK, progressive files whose scans stop early (libjpeg-turbo
block-smooths them: after the DC scan alone, and after some AC scans) and
lossless files (SOF3: grey and RGB, predictors, point transform,
restarts). libjpeg writes the first kinds through a small C program
against the system's jpeglib.h (scripts/jpeg_fixture_writer.c, compiled
into the gitignored build/ directory); ``lossless_jpeg`` below writes
SOF3. Two of COCO's size (``trainer_*.jpg``: CMYK and arithmetic-coded)
are chip_smoke.py's trainer and http phases' inputs of these kinds.
Their loader sources (``src_*.jpg`` there) and the JAX loader's
batches of them are in that directory's prescale.npz: the arithmetic and
smoothed ones prescaled by its libjpeg at one target per n/8, the CMYK,
YCCK and lossless ones, which its libjpeg does not decode to RGB, through
its fallback (PIL's full-size decode and BILINEAR) at the same targets.
"""

from __future__ import annotations

import argparse
import io
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np
from PIL import Image

SEED = 20


def smooth(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Low-resolution noise upsampled by PIL, plus a little fine noise, so
    that every DCT band carries some energy."""
    base = rng.integers(0, 256, (max(h // 12, 2), max(w // 12, 2), 3),
                        np.uint8)
    img = np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR))
    fine = rng.integers(-12, 13, img.shape)
    return np.clip(img.astype(int) + fine, 0, 255).astype(np.uint8)


def jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def as_440(data: bytes) -> bytes:
    """A 4:2:2 file's frame header (SOF0 or, progressive, SOF2) rewritten
    to 4:4:0 (see above)."""
    b = bytearray(data)
    i = min(b.find(m) % len(b) for m in (b"\xff\xc0", b"\xff\xc2"))
    h, w = b[i + 5:i + 7], b[i + 7:i + 9]
    b[i + 5:i + 7], b[i + 7:i + 9] = w, h
    if b[i + 11] != 0x21:
        raise ValueError("expected a 2x1 luminance sampling")
    b[i + 11] = 0x12
    return bytes(b)


def jax_loader_scale(w: int, h: int, target: int) -> int:
    """The n of the n/8 scale at which the JAX package's loader decodes a
    w x h JPEG for ``target`` (its native/loader.cpp loop)."""
    num = 8
    while num > 1 and (w * (num - 1)) // 8 >= target \
            and (h * (num - 1)) // 8 >= target:
        num -= 1
    return num


def prescale_targets(w: int, h: int) -> list:
    """For n = 1..8, the smallest target (at least 8) at which the JAX
    loader decodes a w x h JPEG at n/8."""
    side = min(w, h)
    targets = [8] + [side * (n - 1) // 8 + 1 for n in range(2, 9)]
    assert [jax_loader_scale(w, h, t) for t in targets] == list(range(1, 9))
    return targets


# (name, (H, W), subsampling, progressive): a few hundred pixels a side.
PRESCALE_SOURCES = (("src_420", (160, 224), 2, False),
                    ("src_422_progressive", (152, 208), 1, True))


def prescale_sources() -> dict:
    rng = np.random.default_rng(SEED + 1)
    return {name: jpeg(smooth(rng, *hw), quality=90, subsampling=sub,
                       progressive=prog)
            for name, hw, sub, prog in PRESCALE_SOURCES}


def fixtures() -> dict:
    rng = np.random.default_rng(SEED)
    img = smooth(rng, 48, 64)
    return {
        "q95_444": jpeg(img, quality=95, subsampling=0),
        "q95_422": jpeg(img, quality=95, subsampling=1),
        "q95_420": jpeg(img, quality=95, subsampling=2),
        "q95_440": as_440(jpeg(smooth(rng, 64, 48), quality=95,
                               subsampling=1)),
        "gray": jpeg(np.asarray(Image.fromarray(img).convert("L")),
                     quality=90),
        "odd_37x23_q50": jpeg(smooth(rng, 37, 23), quality=50),
        "restart": jpeg(smooth(rng, 40, 56), quality=85,
                        restart_marker_blocks=3),
        "progressive_420": jpeg(img, quality=95, progressive=True),
        "progressive_444": jpeg(img, quality=90, subsampling=0,
                                progressive=True, optimize=True),
        "progressive_gray": jpeg(
            np.asarray(Image.fromarray(img).convert("L")), quality=90,
            progressive=True),
        "progressive_restart": jpeg(smooth(rng, 37, 53), quality=85,
                                    progressive=True,
                                    restart_marker_blocks=2),
    }


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRITER = os.path.join(ROOT, "build", "jpeg_fixture_writer")


def libjpeg_file(px: np.ndarray, space: str = "ycbcr", quality: int = 90,
                 sampling: str = "-", arith: bool = False, restart: int = 0,
                 scans: str = "-", adobe: str = "-") -> bytes:
    """A JPEG of uint8 (H, W[, C]) pixels written by the system's libjpeg
    (scripts/jpeg_fixture_writer.c, built here at first use): ``space``
    ycbcr, rgb, gray, cmyk or ycck (CMYK input as PIL stores it),
    ``sampling`` "HxV,..." per component, arithmetic coding, a restart
    interval in MCUs, ``scans`` "-" (sequential), "p" (libjpeg's
    progression) or a script "comps:Ss-Se:Ah-Al;...", the Adobe marker
    "-" (libjpeg's default), "0" or "1"."""
    src = os.path.join(ROOT, "scripts", "jpeg_fixture_writer.c")
    if (not os.path.exists(WRITER)
            or os.path.getmtime(WRITER) < os.path.getmtime(src)):
        os.makedirs(os.path.dirname(WRITER), exist_ok=True)
        tmp = f"{WRITER}.{os.getpid()}.tmp"
        subprocess.run(["cc", "-O2", "-o", tmp, src, "-ljpeg"], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, WRITER)
    px = np.ascontiguousarray(px, np.uint8)
    h, w = px.shape[:2]
    with tempfile.TemporaryDirectory() as tmp:
        raw, out = os.path.join(tmp, "in"), os.path.join(tmp, "out.jpg")
        with open(raw, "wb") as f:
            f.write(px.tobytes())
        subprocess.run([WRITER, raw, out, str(w), str(h),
                        str(1 if px.ndim == 2 else px.shape[2]), space,
                        str(quality), sampling, str(int(arith)),
                        str(restart), scans, str(adobe)], check=True,
                       capture_output=True, timeout=60)
        with open(out, "rb") as f:
            return f.read()


def scans_of(data: bytes) -> list:
    """(start, end) of each scan: its SOS segment and entropy-coded data."""
    out, i = [], 2
    while i < len(data) - 1 and data[i + 1] != 0xD9:
        end = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
        if data[i + 1] == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in
                       (0x00, *range(0xD0, 0xD8))):
                end += 1
            out.append((i, end))
        i = end
    return out


def stop_after(data: bytes, k: int) -> bytes:
    """A progressive file cut after its scan k and ended (EOI)."""
    return data[:scans_of(data)[k][1]] + b"\xff\xd9"


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v: int, k: int) -> None:
        self.acc = (self.acc << k) | (v & ((1 << k) - 1))
        self.n += k
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            self.n -= 8

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def lossless_jpeg(planes: list, sampling: list, psv: int = 1, pt: int = 0,
                  restart_rows: int = 0, ids: list = None,
                  interleave: bool = True) -> bytes:
    """A lossless JPEG (SOF3, 8-bit, T.81 Annex H) of uint8 planes, each at
    its component's size for ``sampling`` [(h, v), ...]: predictor ``psv``
    (1-7), point transform ``pt``, a restart every ``restart_rows`` MCU
    rows; one interleaved scan or one scan per component. The differences
    take a fixed Huffman table of 17 five-bit codes; a plane is padded to
    whole MCUs by repeating its edges."""
    nc = len(planes)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    height = min(p.shape[0] * vmax // v for p, (_, v) in zip(planes, sampling))
    width = min(p.shape[1] * hmax // h for p, (h, _) in zip(planes, sampling))
    ids = ids or list(range(1, nc + 1))
    out = bytearray(b"\xff\xd8")
    out += _segment(0xC3, bytes([8]) + struct.pack(">HHB", height, width, nc)
                    + b"".join(bytes([i, h << 4 | v, 0])
                               for i, (h, v) in zip(ids, sampling)))
    out += _segment(0xC4, bytes([0, 0, 0, 0, 0, 17]) + bytes(11)
                    + bytes(range(17)))
    for scan in ([list(range(nc))] if interleave else [[c] for c in
                                                         range(nc)]):
        one = len(scan) == 1
        per_row = (planes[scan[0]].shape[1] if one
                   else -(-width // hmax))
        mcu_rows = (planes[scan[0]].shape[0] if one
                    else -(-height // vmax))
        if restart_rows:
            out += _segment(0xDD, struct.pack(">H", restart_rows * per_row))
        out += _segment(0xDA, bytes([len(scan)]) + b"".join(
            bytes([ids[c], 0]) for c in scan) + bytes([psv, 0, pt]))
        diffs = {}
        for c in scan:
            h, v = (1, 1) if one else sampling[c]
            x = planes[c].astype(np.int64) >> pt
            x = np.pad(x, ((0, mcu_rows * v - x.shape[0]),
                           (0, per_row * h - x.shape[1])), mode="edge")
            d = np.zeros_like(x)
            for y in range(x.shape[0]):
                first = y == 0 or (restart_rows and y % v == 0
                                   and (y // v) % restart_rows == 0)
                for i in range(x.shape[1]):
                    ra = x[y, i - 1] if i else 0
                    if first:
                        pred = ra if i else 1 << (7 - pt)
                    elif i == 0:
                        pred = x[y - 1, 0]
                    else:
                        rb, rc = x[y - 1, i], x[y - 1, i - 1]
                        pred = (ra, rb, rc, ra + rb - rc,
                                ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                                (ra + rb) >> 1)[psv - 1]
                    d[y, i] = x[y, i] - pred
            diffs[c] = d
        bits = _BitWriter()
        for my in range(mcu_rows):
            if restart_rows and my and my % restart_rows == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + (my // restart_rows - 1) % 8])
            for mx in range(per_row):
                for c in scan:
                    h, v = (1, 1) if one else sampling[c]
                    for by in range(v):
                        for bx in range(h):
                            dv = int(diffs[c][my * v + by, mx * h + bx])
                            s = abs(dv).bit_length()
                            bits.put(s, 5)
                            if s:
                                bits.put(dv if dv >= 0 else dv - 1, s)
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")


def cmyk_of(img: np.ndarray) -> np.ndarray:
    """CMYK samples of an RGB image, as PIL's convert("CMYK") makes them."""
    return np.asarray(Image.fromarray(img).convert("CMYK"))


def pil_cmyk_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(cmyk_of(img), "CMYK").save(buf, "JPEG", **kw)
    return buf.getvalue()


def kind_fixtures() -> dict:
    """The kinds PIL reads and does not write, from a seed."""
    rng = np.random.default_rng(SEED + 2)
    img = smooth(rng, 40, 56)
    cm = cmyk_of(smooth(rng, 40, 56))
    return {
        "arith_420": libjpeg_file(img, arith=True, sampling="2x2,1x1,1x1"),
        "arith_progressive_422_restart": libjpeg_file(
            smooth(rng, 37, 45), arith=True, scans="p",
            sampling="2x1,1x1,1x1", restart=3),
        "cmyk_adobe": pil_cmyk_jpeg(smooth(rng, 40, 56), quality=90),
        "cmyk_no_adobe_420": libjpeg_file(
            cm, space="cmyk", adobe="0", sampling="2x2,1x1,1x1,2x2"),
        "ycck_420": libjpeg_file(cm, space="ycck",
                                 sampling="2x2,1x1,1x1,2x2"),
        "smoothed_dc_only_420": stop_after(
            jpeg(img, quality=85, progressive=True), 0),
        "smoothed_ac_partial_420": stop_after(
            jpeg(smooth(rng, 45, 61), quality=85, progressive=True), 3),
        "smoothed_arith_440": stop_after(
            libjpeg_file(smooth(rng, 37, 45), arith=True, scans="p",
                         sampling="1x2,1x1,1x1"), 2),
        "lossless_grey_psv4": lossless_jpeg(
            [smooth(rng, 23, 31)[:, :, 0]], [(1, 1)], psv=4),
        "lossless_rgb_psv6_restart": lossless_jpeg(
            list(np.moveaxis(smooth(rng, 21, 30), 2, 0)), [(1, 1)] * 3,
            psv=6, pt=1, restart_rows=4),
    }


def kind_sources() -> dict:
    """The loader's sources of the new kinds: {name: (bytes, route)}, the
    route "prescale" (the JAX loader's libjpeg decodes it at n/8) or
    "fallback" (it does not: PIL's full-size decode and BILINEAR)."""
    rng = np.random.default_rng(SEED + 3)
    img = smooth(rng, 72, 96)
    return {
        "src_arith_progressive_420": (libjpeg_file(
            img, arith=True, scans="p", sampling="2x2,1x1,1x1"), "prescale"),
        "src_smoothed_420": (stop_after(jpeg(smooth(rng, 72, 96), quality=85,
                                             progressive=True), 2),
                             "prescale"),
        "src_cmyk_adobe": (pil_cmyk_jpeg(smooth(rng, 72, 96), quality=90),
                           "fallback"),
        "src_ycck_420": (libjpeg_file(cmyk_of(smooth(rng, 72, 96)),
                                      space="ycck",
                                      sampling="2x2,1x1,1x1,2x2"),
                         "fallback"),
        "src_lossless_rgb": (lossless_jpeg(
            list(np.moveaxis(smooth(rng, 72, 96), 2, 0)), [(1, 1)] * 3,
            psv=7), "fallback"),
    }


def trainer_files() -> dict:
    """Two files at COCO's 640x480 for chip_smoke.py's trainer and http
    phases, which cannot write these kinds without PIL or libjpeg: PIL's
    CMYK JPEG (Adobe marker) and libjpeg's arithmetic-coded 4:2:0 one."""
    rng = np.random.default_rng(SEED + 4)

    def photo():   # smooth, without the fine noise: a few tens of KB
        base = rng.integers(0, 256, (15, 20, 3), np.uint8)
        return np.asarray(Image.fromarray(base).resize((640, 480),
                                                       Image.BILINEAR))

    return {"trainer_cmyk_adobe": pil_cmyk_jpeg(photo(), quality=90),
            "trainer_arith_420": libjpeg_file(photo(), arith=True,
                                              quality=90,
                                              sampling="2x2,1x1,1x1")}


def write_kinds(out: str) -> None:
    """tests/data/jpeg_kinds/: the kind fixtures and PIL's pixels, the
    loader's sources and the JAX loader's batches of them."""
    os.makedirs(out, exist_ok=True)
    pixels = {}
    for name, data in kind_fixtures().items():
        with open(os.path.join(out, f"{name}.jpg"), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            pixels[name] = np.asarray(im.convert("RGB"))
    np.savez_compressed(os.path.join(out, "pixels.npz"), **pixels)
    for name, data in trainer_files().items():
        with open(os.path.join(out, f"{name}.jpg"), "wb") as f:
            f.write(data)
    from mastermetastyletransfer_tpu.data import native_loader

    batches = {}
    for name, (data, _) in kind_sources().items():
        path = os.path.join(out, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            w, h = im.size
        for t in prescale_targets(w, h):
            batches[f"{name}_{t}"] = native_loader.decode_resize_batch(
                [path], t)[0]
    np.savez_compressed(os.path.join(out, "prescale.npz"), **batches)
    print(f"wrote {len(pixels)} JPEGs of other kinds, {len(batches)} "
          f"batches to {out}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "data", "jpeg"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    pixels = {}
    for name, data in fixtures().items():
        with open(os.path.join(args.out, f"{name}.jpg"), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            pixels[name] = np.asarray(im.convert("RGB"))
    np.savez_compressed(os.path.join(args.out, "pixels.npz"), **pixels)
    # the JAX package's loader (libjpeg) imported here alone: nothing else
    # in this script needs it
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from mastermetastyletransfer_tpu.data import native_loader

    batches = {}
    for name, data in prescale_sources().items():
        path = os.path.join(args.out, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            w, h = im.size
        for t in prescale_targets(w, h):
            batches[f"{name}_{t}"] = native_loader.decode_resize_batch(
                [path], t)[0]
    np.savez_compressed(os.path.join(args.out, "prescale.npz"), **batches)
    print(f"wrote {len(pixels)} JPEGs and pixels.npz, "
          f"{len(PRESCALE_SOURCES)} sources and prescale.npz to {args.out}")
    write_kinds(os.path.join(os.path.dirname(args.out), "jpeg_kinds"))


if __name__ == "__main__":
    main()
