"""Write the JPEG fixtures under tests/data/jpeg/ with PIL, and PIL's
decoded pixels beside them (pixels.npz, compressed), from a fixed seed.

    python scripts/make_jpeg_fixtures.py [--out tests/data/jpeg]

chip_smoke.py's ``codecs`` phase holds the port's decoder to the stored
pixels on the machine with the card, which has no PIL; the CPU tests
(tests/test_torch_codecs.py) check that PIL still decodes each file to
them. One file per decoder route: 4:4:4, 4:2:2, 4:2:0 and 4:4:0 chroma
sampling, grayscale, an odd size at quality 50, and restart intervals.
PIL cannot write 4:4:0: that file is PIL's 4:2:2 JPEG of the transposed
size with its frame header's size swapped and its luminance sampling set
to 1x2, which leaves the entropy-coded data a valid 4:4:0 scan.
"""

from __future__ import annotations

import argparse
import io
import os

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
    """A 4:2:2 file's frame header rewritten to 4:4:0 (see above)."""
    b = bytearray(data)
    i = b.index(b"\xff\xc0")
    h, w = b[i + 5:i + 7], b[i + 7:i + 9]
    b[i + 5:i + 7], b[i + 7:i + 9] = w, h
    if b[i + 11] != 0x21:
        raise ValueError("expected a 2x1 luminance sampling")
    b[i + 11] = 0x12
    return bytes(b)


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
    print(f"wrote {len(pixels)} JPEGs and pixels.npz to {args.out}")


if __name__ == "__main__":
    main()
