"""Differential fuzz of the port's image readers against PIL on the CPU:
random files of one kind (PIL's save and the byte-level writers of
scripts/make_image_format_fixtures.py), some of them damaged (bytes
flipped, the file cut short), each decoded by PIL and by the port's
``data/pipeline.decode_image``; a case counts as a difference where the
verdicts differ (one decodes, the other refuses) or the pixels do. Bodies
PIL opens as a format the port does not read are counted apart.

    python scripts/fuzz_image_formats.py --kind tiff --seed 2 --n 1500
        [--damage 0.7] [--keep DIR] [--repo DIR]

Kinds: pnm, gif, ico, dib, tiff (CCITT, LZMA, Zstandard and YCbCr tiles
among them), tga (random bytes, TGA files and ICO headers, their header
fields mutated), jpeg (a damaged JPEG's scan data; restart markers in
0.3 of the files), png, pcx (PCX and DCX), qoi, thunderscan
(ThunderScan and CIELab TIFF), ojpeg (old-style JPEG TIFF). ``--damage`` is
the share of damaged files (flips in 0.7 of them, cuts in the rest);
``--keep`` writes each differing file there. Prints one JSON line: the
counts by (PIL decodes, the port decodes) and the differences; a
difference whose pixels PIL takes from memory it never wrote (decoded
again in a fresh process, PIL gives other pixels) is counted apart, as
``pil_unsettled``. ``--repo`` tests another checkout's port (a parent
unpacked with ``git archive``) with this checkout's generators.

``--kind loader`` holds the port's batch loader to the JAX package's
instead (``decode_resize_batch`` of each file at its target, libjpeg
with its fallback to PIL against the port's decoder): JPEGs of 64 to 700
pixels a side, progressive and restart-bearing ones among them, a third
cut short, a third with their scan data flipped, each at the target
where the JAX loader decodes it at n/8 for an n from 1 to 8; the counts
by (damage, JAX reads or refuses, the port reads or refuses).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import warnings

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import scripts.make_image_format_fixtures as fx  # noqa: E402
import scripts.make_jpeg_fixtures as mjf  # noqa: E402

PORT_FORMATS = {"BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "ICO", "TIFF",
                "TGA", "WEBP", "MPO", "PCX", "DCX", "QOI"}


def pil(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(io.BytesIO(data)) as im:
                return np.asarray(im.convert("RGB")), im.format
    except Exception:  # noqa: BLE001 - any refusal of PIL's
        return None, None


def saved(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def gen_pnm(rng) -> bytes:
    magic = [b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"P0CMYK", b"Pf",
             b"PyP", b"PyRGBA", b"PyCMYK"][int(rng.integers(0, 11))]
    w, h = int(rng.integers(1, 9)), int(rng.integers(1, 9))
    bands = {b"P3": 3, b"P6": 3, b"P0CMYK": 4, b"PyRGBA": 4,
             b"PyCMYK": 4}.get(magic, 1)
    seps = [b" ", b"\n", b"\t", b"  ", b"\r\n", b" #c\n", b"#x\r"]
    sep = [seps[int(rng.integers(0, len(seps)))] for _ in range(4)]
    if magic == b"Pf":
        f = rng.normal(100, 150, (h, w)).astype(np.float32)
        return fx.pnm_file(magic, f, header_sep=sep, scale=float(
            rng.choice([-1.0, 1.0, -2.5])))
    maxval = int(rng.choice([1, 100, 255, 256, 1000, 65535]))
    vals = rng.integers(0, 2 if magic in (b"P1", b"P4") else maxval + 1,
                        (h, w, bands) if bands > 1 else (h, w))
    return fx.pnm_file(magic, vals, maxval, header_sep=sep)


def gen_gif(rng) -> bytes:
    w, h = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    if rng.random() < 0.4:
        im = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
        im = im.quantize(int(rng.choice([2, 4, 16, 256])))
        return saved(im, "GIF", interlace=bool(rng.random() < 0.3))
    size = int(rng.integers(2, 9))
    idx = rng.integers(0, 1 << size, (h, w)).astype(np.uint8)
    kw = dict(min_size=size, interlace=bool(rng.random() < 0.3),
              global_pal=rng.integers(0, 256, (int(rng.integers(1, 257)), 3)))
    if rng.random() < 0.3:
        kw["screen"] = (int(rng.integers(1, 50)), int(rng.integers(1, 50)))
        kw["at"] = (int(rng.integers(0, 10)), int(rng.integers(0, 10)))
    if rng.random() < 0.3:
        kw["transparency"] = int(rng.integers(0, 256))
    for key, p in (("comment", 0.3), ("defer", 0.2), ("later_frame", 0.2)):
        if rng.random() < p:
            kw[key] = True
    return fx.gif_file(idx, **kw)


def gen_ico(rng) -> bytes:
    side = int(rng.choice([16, 24, 32, 48, 64]))
    img = fx.smooth(rng, side, side, c=4)
    mode = ["RGBA", "RGB", "P", "L"][int(rng.integers(0, 4))]
    im = (Image.fromarray(img, "RGBA") if mode == "RGBA"
          else fx._pil_image(img[..., :3], mode))
    sizes = sorted({int(s) for s in rng.choice([16, 24, 32, 48], 3)
                    if s <= side})
    return saved(im, "ICO", sizes=[(s, s) for s in sizes],
                 bitmap_format=str(rng.choice(["bmp", "png"])))


def gen_dib(rng) -> bytes:
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    mode = ["1", "L", "P", "RGB"][int(rng.integers(0, 4))]
    return saved(fx._pil_image(fx.smooth(rng, h, w), mode), "DIB")


def gen_tiff_codecs(rng) -> bytes:
    """A TIFF of CCITT (PIL's save), LZMA or Zstandard (PIL's save or the
    byte-level writer's), YCbCr in tiles or with a predictor or an
    orientation, or planar JPEG."""
    h, w = int(rng.integers(1, 60)), int(rng.integers(1, 90))
    pick = int(rng.integers(0, 6))
    if pick == 0:
        comp = ["tiff_ccitt", "tiff_raw_16", "group3", "group4"][
            int(rng.integers(0, 4))]
        info = {}
        if rng.random() < 0.5:
            info[278] = int(rng.integers(1, h + 1))
        if rng.random() < 0.3 and comp != "tiff_raw_16":
            info[266] = 2
        if rng.random() < 0.3:
            info[262] = 0
        if comp == "group3":
            info[292] = int(rng.choice([0, 1, 4, 5]))
        return fx.pil_ccitt(fx.fax_pattern(rng, h, w), comp, info)
    if pick == 1:
        mode = list(fx.PIL_TIFF_MODES)[int(rng.integers(0, 8))]
        src = fx.smooth(rng, h, w)
        src = src if mode in ("RGB", "RGBA", "P", "CMYK") else src[..., 1]
        return fx.pil_tiff(src, mode, compression=str(rng.choice(
            ["lzma", "zstd"])))
    if pick == 2:
        kw = [{"predictor": 2}, {"tile": (16, 16)}, {"rows_per_strip": 3},
              {"fill_order": 2}][int(rng.integers(0, 4))]
        return fx.tiff_file(fx.smooth(rng, h, w).astype(np.int64),
                            compression=int(rng.choice([34925, 50000])),
                            **kw)
    sub = [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4)][int(rng.integers(0, 5))]
    comp = int(rng.choice([5, 8, 32773, 34925, 50000]))
    if pick == 3:
        return fx.ycbcr_tiles_tiff(rng, h, w, sub, compression=comp,
                                   tile=(16, int(rng.choice([16, 32]))))
    if pick == 4:
        tags = ({317: (3, [2])} if rng.random() < 0.5 else
                {274: (3, [int(rng.integers(1, 9))])})
        return fx.ycbcr_tiff(rng, h, w, sub, compression=comp,
                             rows_per_strip=2 * sub[1], tags=tags)
    return fx.tiff_file(fx.smooth(rng, h, w).astype(np.int64), compression=7,
                        planar=2, rows_per_strip=int(rng.integers(1, h + 1)))


def gen_tga(rng) -> bytes:
    """Random bytes, or a TGA (PIL's save, or the byte-level writer's 16-
    and 32-bit true colour, colour maps from an offset entry, flips,
    literals across rows) or an ICO, its header fields mutated."""
    pick = rng.random()
    if pick < 0.15:
        return bytes(rng.integers(0, 256, int(rng.integers(0, 120)),
                                  dtype=np.uint8))
    if pick < 0.3:
        data = bytearray(gen_ico(rng))
    elif pick < 0.6:
        h, w = int(rng.integers(1, 30)), int(rng.integers(1, 40))
        mode = ["1", "L", "LA", "P", "RGB", "RGBA"][int(rng.integers(0, 6))]
        img = fx.smooth(rng, h, w)
        im = (Image.fromarray(np.dstack([img[..., 1], img[..., 0]]), "LA")
              if mode == "LA" else fx._pil_image(img, mode))
        data = bytearray(saved(im, "TGA", rle=bool(rng.random() < 0.5),
                               orientation=int(rng.choice([-1, 1]))))
    else:
        h, w = int(rng.integers(1, 20)), int(rng.integers(1, 30))
        depth = int(rng.choice([8, 16, 24, 32]))
        itype = int(rng.choice([1, 2, 3, 9, 10, 11]))
        k = max(depth // 8, 1)
        px = rng.integers(0, 256, (h, w, k), dtype=np.uint8)
        px[h // 2:] = px[0, 0]   # runs
        cmap = None
        kw = {}
        if itype & 7 == 1 or rng.random() < 0.1:
            kw["map_depth"] = int(rng.choice([16, 24, 32]))
            cmap = rng.integers(0, 256, int(rng.integers(1, 300)) * (
                kw["map_depth"] // 8), dtype=np.uint8)
            kw["map_start"] = int(rng.integers(0, 20))
        data = bytearray(fx.tga_file(
            px, itype, depth, cmap=cmap, flags=int(rng.choice(
                [0, 0x10, 0x20, 0x30])),
            id_section=bytes(int(rng.integers(0, 3))), cross=bool(
                rng.random() < 0.5), **kw))
    for _ in range(int(rng.integers(0, 3))):   # header fields mutated
        i = int(rng.integers(0, min(18, len(data))))
        data[i] = int(rng.choice([0, 1, 2, 3, 8, 9, 10, 11, 16, 24, 32,
                                  255, int(rng.integers(0, 256))]))
    return bytes(data)


def gen_tiff(rng) -> bytes:
    if rng.random() < 0.3:
        return gen_tiff_codecs(rng)
    if rng.random() < 0.4:
        h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        mode = list(fx.PIL_TIFF_MODES + ("LA", "I"))[int(rng.integers(0, 10))]
        src = fx.smooth(rng, h, w)
        src = src if mode in ("RGB", "RGBA", "P", "CMYK", "LA") else \
            src[..., 1]
        comps = list(fx.PIL_TIFF_COMPRESSIONS) + (
            ["jpeg"] if mode in ("RGB", "L", "CMYK") else [])
        return fx.pil_tiff(src, mode,
                           compression=comps[int(rng.integers(0, len(comps)))])
    return fx.writer_case(rng)


def restart_options(rng) -> dict:
    """Pillow's restart markers: every one or two MCU rows, or every few
    MCUs."""
    if rng.random() < 0.5:
        return {"restart_marker_rows": int(rng.integers(1, 3))}
    return {"restart_marker_blocks": int(rng.integers(1, 8))}


def gen_jpeg(rng) -> bytes:
    w, h = int(rng.integers(8, 60)), int(rng.integers(8, 60))
    a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    im = Image.fromarray(a) if rng.random() < 0.8 else Image.fromarray(a[..., 0])
    kw = restart_options(rng) if rng.random() < 0.3 else {}
    return saved(im, "JPEG", quality=int(rng.choice([50, 90, 100])),
                 progressive=bool(rng.random() < 0.3),
                 subsampling=int(rng.choice([0, 1, 2])), **kw)


def gen_loader(rng):
    """A JPEG of 64 to 700 pixels a side (0.3 of them progressive, 0.3 with
    restart markers, some grey), cut short, its scan data flipped, or
    whole, a third each; and the target at which the JAX loader decodes it
    at n/8, n drawn from 1..8. Returns (bytes, damage, n, target)."""
    h, w = (int(v) for v in rng.integers(64, 701, 2))
    img = fx.smooth(rng, h, w)
    im = Image.fromarray(img if rng.random() < 0.85 else img[..., 0])
    kw = restart_options(rng) if rng.random() < 0.3 else {}
    data = saved(im, "JPEG", quality=int(rng.choice([50, 75, 90, 95])),
                 progressive=bool(rng.random() < 0.3),
                 subsampling=int(rng.choice([0, 1, 2])), **kw)
    pick = rng.random()
    if pick < 1 / 3:
        data, how = data[:int(rng.integers(2, len(data)))], "cut"
    elif pick < 2 / 3:
        start = data.find(b"\xff\xda") + 10
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(start, len(b)))] ^= int(rng.integers(1, 256))
        data, how = bytes(b), "flip"
    else:
        how = "clean"
    n = int(rng.integers(1, 9))
    return data, how, n, mjf.prescale_targets(w, h)[n - 1]


@contextlib.contextmanager
def _quiet_stderr():
    """File descriptor 2 to /dev/null (what a C library prints there)."""
    sys.stderr.flush()
    saved = os.dup(2)
    with open(os.devnull, "w") as null:
        os.dup2(null.fileno(), 2)
        try:
            yield
        finally:
            os.dup2(saved, 2)
            os.close(saved)


def loader_fuzz(args) -> dict:
    """The port's batch loader against the JAX package's, file by file
    (``decode_resize_batch`` of one path at its target): a difference where
    one reads the file and the other raises, or the batches differ."""
    import tempfile

    from mastermetastyletransfer_tpu.data.native_loader import (
        decode_resize_batch as jax_batch,
    )
    from mastermetastyletransfer_tpu_torch.data.native_loader import (
        decode_resize_batch as port_batch,
    )

    rng = np.random.default_rng(args.seed)
    counts, diffs = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.n):
            data, how, n, target = gen_loader(rng)
            path = os.path.join(tmp, f"{i}.jpg")
            with open(path, "wb") as f:
                f.write(data)
            try:
                with _quiet_stderr():   # libjpeg's warnings
                    want = jax_batch([path], target)[0]
            except Exception:  # noqa: BLE001 - PIL's refusal, any kind
                want = None
            try:
                got = port_batch([path], target)[0]
            except ValueError:
                got = None
            key = f"{how}: jax {'reads' if want is not None else 'refuses'}"\
                  f", port {'reads' if got is not None else 'refuses'}"
            counts[key] = counts.get(key, 0) + 1
            if (want is None) != (got is None) or (
                    want is not None and not np.array_equal(want, got)):
                diffs.append(i)
                if args.keep:
                    os.makedirs(args.keep, exist_ok=True)
                    with open(os.path.join(args.keep, f"loader_{i}_n{n}_"
                                           f"{how}.jpg"), "wb") as f:
                        f.write(data)
            os.unlink(path)
    return dict(kind="loader", seed=args.seed, n=args.n,
                counts=dict(sorted(counts.items())), differing=len(diffs),
                differing_cases=diffs[:50])


def gen_png(rng) -> bytes:
    w, h = int(rng.integers(1, 300)), int(rng.integers(1, 300))
    mode = ["RGB", "RGBA", "L", "P", "1", "LA"][int(rng.integers(0, 6))]
    a = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    im = (Image.fromarray(a[..., :3]).quantize(16) if mode == "P" else
          Image.fromarray(a[..., :2], "LA") if mode == "LA" else
          Image.fromarray(a[..., :len(mode)], mode) if mode.startswith("RGB")
          else Image.fromarray(a[..., 0]).convert(mode))
    return saved(im, "PNG")


def gen_pcx(rng) -> bytes:
    """A PCX (PIL's save, or the byte-level writer's with the version,
    bits, planes, header stride and bounding box drawn, a body of random
    packets at times), or a DCX of one or two of them."""
    h, w = int(rng.integers(1, 24)), int(rng.integers(1, 40))
    if rng.random() < 0.3:
        mode = ["1", "L", "P", "RGB"][int(rng.integers(0, 4))]
        data = saved(fx._pil_image(fx.smooth(rng, h, w), mode), "PCX")
    else:
        bits, planes = [(1, 1), (1, 2), (1, 4), (8, 1), (8, 3), (2, 1),
                        (8, 4), (4, 1)][int(rng.integers(0, 8))]
        stride = (w * bits + 7) // 8 + int(rng.integers(0, 3))
        rows = rng.integers(0, 256, (h, planes * stride), dtype=np.uint8)
        rows[:, ::3] = rows[:, :1]   # runs
        body = None
        if rng.random() < 0.2:
            body = bytes(rng.integers(0, 256, int(rng.integers(0, 400)),
                                      dtype=np.uint8))
        data = fx.pcx_file(
            rows, w, version=int(rng.choice([0, 2, 3, 5, 5, 5])), bits=bits,
            planes=planes, stride=int(rng.choice([stride, stride - 1,
                                                  stride + 1, 0])),
            origin=(int(rng.integers(0, 4)), int(rng.integers(0, 4))),
            palette256=(rng.integers(0, 256, 768) if rng.random() < 0.4
                        else None), body=body,
            zero_runs=bool(rng.random() < 0.2))
    if rng.random() < 0.25:
        pages = [data] + ([gen_pcx(rng)] if rng.random() < 0.5 else [])
        data = fx.dcx_file(pages)
    return data


def gen_qoi(rng) -> bytes:
    """A QOI: PIL's save in RGB or RGBA, or random ops (every kind) under
    a header of any channels byte."""
    h, w = int(rng.integers(1, 20)), int(rng.integers(1, 30))
    if rng.random() < 0.4:
        img = fx.smooth(rng, h, w, 4 if rng.random() < 0.5 else 3)
        img[h // 2:, : w // 2] = img[0, 0]
        return saved(Image.fromarray(img.astype(np.uint8)), "QOI")
    ops = bytearray()
    while len(ops) < h * w * 2:
        k = int(rng.integers(0, 6))
        if k == 0:
            ops += bytes([0xFE]) + bytes(rng.integers(0, 256, 3,
                                                       dtype=np.uint8))
        elif k == 1:
            ops += bytes([0xFF]) + bytes(rng.integers(0, 256, 4,
                                                       dtype=np.uint8))
        elif k == 2:
            ops.append(int(rng.integers(0, 64)))
        elif k == 3:
            ops.append(0x40 | int(rng.integers(0, 64)))
        elif k == 4:
            ops += bytes([0x80 | int(rng.integers(0, 64)),
                          int(rng.integers(0, 256))])
        else:
            ops.append(0xC0 | int(rng.integers(0, 62)))
    return fx.qoi_file(w, h, bytes(ops), int(rng.choice([3, 4, 3, 7])),
                       end=bool(rng.random() < 0.7))


def gen_thunderscan(rng) -> bytes:
    """A ThunderScan TIFF of drawn values in strips (FillOrder 2 at
    times), or one of random codes, or a CIELab TIFF."""
    h, w = int(rng.integers(1, 12)), int(rng.integers(1, 24))
    if rng.random() < 0.2:
        return fx.tiff_file(fx.smooth(rng, h, w).astype(np.int64),
                            photometric=8, compression=int(rng.choice(
                                [1, 5, 8, 32773])),
                            planar=int(rng.choice([1, 2])))
    rps = int(rng.integers(1, h + 1))
    kw = {"photometric": int(rng.choice([0, 1]))}
    if rng.random() < 0.2:
        kw["fill_order"] = 2
    if rng.random() < 0.5:
        v = np.cumsum(rng.integers(-2, 3, (h, w)), 1) % 16
        return fx.thunder_tiff(v, rows_per_strip=rps, **kw)
    strips = [bytes(rng.integers(0, 256, int(rng.integers(1, 3 * w * rps)),
                                 dtype=np.uint8)) for _ in range(h)]
    return fx.tiff_file(np.zeros((h, w, 1), np.int64), bps=4,
                        rows_per_strip=rps, tags={259: (3, [32809])},
                        chunk_hook=lambda i, b: strips[i], **kw)


def gen_ojpeg(rng) -> bytes:
    """An old-style JPEG TIFF (the byte-level writer's ``ojpeg_file``) of
    a drawn size, layout, sampling, restart interval and strip height."""
    h, w = int(rng.integers(1, 60)), int(rng.integers(1, 60))
    grey = rng.random() < 0.2
    img = fx.smooth(rng, h, w)
    sub = int(rng.integers(0, 3))
    vs = 2 if sub == 2 and not grey else 1
    rps = int(rng.choice([8 * vs, 16 * vs, h])) if rng.random() < 0.7 \
        else int(rng.integers(1, h + 1))
    kw = {"subsampling": sub, "quality": int(rng.integers(30, 96))}
    if rps < h or rng.random() < 0.3:
        kw["restart_marker_rows"] = int(rng.choice([1, 1, 2]))
    layout = str(rng.choice(["whole", "split", "whole_split"]))
    return fx.ojpeg_file(img[..., 1] if grey else img,
                         photometric=1 if grey else int(rng.choice([6, 6, 2])),
                         rows_per_strip=rps, layout=layout, jpeg_kw=kw,
                         jif_extra=int(rng.choice([0, 0, 0, 50, -5])))


GENERATORS = {"pnm": gen_pnm, "gif": gen_gif, "ico": gen_ico,
              "dib": gen_dib, "tiff": gen_tiff, "tga": gen_tga,
              "jpeg": gen_jpeg, "png": gen_png, "pcx": gen_pcx,
              "qoi": gen_qoi, "thunderscan": gen_thunderscan,
              "ojpeg": gen_ojpeg}


def pil_elsewhere(data: bytes):
    """PIL's pixels of the bytes decoded in a fresh process, as a digest
    (None where it refuses)."""
    code = ("import io, sys, hashlib, warnings\n"
            "import numpy as np\nfrom PIL import Image\n"
            "warnings.simplefilter('ignore')\n"
            "try:\n"
            "    a = np.asarray(Image.open(io.BytesIO(sys.stdin.buffer.read()))"
            ".convert('RGB'))\n"
            "    print(hashlib.sha256(a.tobytes()).hexdigest())\n"
            "except Exception:\n"
            "    print('None')\n")
    out = subprocess.run([sys.executable, "-c", code], input=data,
                         capture_output=True, timeout=120).stdout.decode()
    return None if out.strip() == "None" else out.strip()


def damage(data: bytes, rng, kind: str) -> bytes:
    if len(data) < 2:
        return data
    if rng.random() < 0.7:
        start = data.find(b"\xff\xda") + 10 if kind == "jpeg" else 0
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(start, len(b)))] ^= int(rng.integers(1, 256))
        return bytes(b)
    return data[:int(rng.integers(1, len(data)))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kind", required=True,
                    choices=sorted(GENERATORS) + ["loader"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--damage", type=float, default=0.5)
    ap.add_argument("--keep", default=None)
    ap.add_argument("--repo", default=ROOT,
                    help="the checkout whose port is tested")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    if args.kind == "loader":
        print(json.dumps(loader_fuzz(args)))
        return
    from mastermetastyletransfer_tpu_torch.data.pipeline import decode_image

    rng = np.random.default_rng(args.seed)
    counts, diffs, other, unsettled = {}, [], 0, []
    for i in range(args.n):
        data = GENERATORS[args.kind](rng)
        if rng.random() < args.damage:
            data = damage(data, rng, args.kind)
        want, fmt = pil(data)
        try:
            got = decode_image(data)
        except ValueError:
            got = None
        key = f"pil {'decodes' if want is not None else 'refuses'}, port " \
              f"{'decodes' if got is not None else 'refuses'}"
        counts[key] = counts.get(key, 0) + 1
        if want is not None and fmt not in PORT_FORMATS:
            other += got is None
            continue
        if (want is None) != (got is None) or (
                want is not None and (want.shape != got.shape
                                      or not np.array_equal(want, got))):
            if want is not None and got is not None and (
                    pil_elsewhere(data) != hashlib.sha256(
                        want.tobytes()).hexdigest()):
                unsettled.append(i)
                continue
            diffs.append(i)
            if args.keep:
                os.makedirs(args.keep, exist_ok=True)
                with open(os.path.join(args.keep, f"{args.kind}_{i}"),
                          "wb") as f:
                    f.write(data)
    print(json.dumps(dict(kind=args.kind, seed=args.seed, n=args.n,
                          damage=args.damage, counts=counts,
                          other_formats_refused=other,
                          pil_unsettled=len(unsettled),
                          pil_unsettled_cases=unsettled[:50],
                          differing=len(diffs), differing_cases=diffs[:50])))


if __name__ == "__main__":
    main()
