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
"""

from __future__ import annotations

import argparse
import io
import os
import sys

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


if __name__ == "__main__":
    main()
