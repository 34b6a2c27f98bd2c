"""Write the WebP fixtures under tests/data/webp/ and PIL's decoded pixels
beside them (pixels.npz, compressed, by file name without ".webp"), from
a fixed seed.

    python scripts/make_webp_fixtures.py [--out tests/data/webp]

The port reads WebP with its own decoder (native/webp.cpp); the CPU tests
(tests/test_torch_webp.py) hold it to PIL on these files and on a seeded
sweep, and chip_smoke.py's ``codecs`` phase to the stored pixels on the
machine with the card, which has neither PIL nor libwebp. PIL writes:
lossy files at quality 0, 50, 75, 95 and 100 with method 0 and 6 (odd
sizes), lossy with alpha, lossless photo-like files (the predictor and
cross-colour transforms), lossless files of at most 2, 4, 16 and 256
colours (colour indexing, bundled at 8, 4 and 2 pixels a byte below 256)
with ``exact`` on and off, and an animation whose frames differ. What
PIL's save cannot select, libwebp writes through a small C program
against the system's encode.h and mux.h (scripts/webp_fixture_writer.c,
compiled into the gitignored build/ directory): the simple loop filter, a
filter strength of 0, sharpness 7, one segment, 8 token partitions,
near-lossless, each ALPH filtering and compression, and an animation
whose first frame sits at an offset inside a larger canvas. Two files at
COCO's 640x480 (``trainer_*.webp``: lossy with alpha, lossless) are
chip_smoke.py's trainer and http phases' WebP inputs.
"""

from __future__ import annotations

import argparse
import io
import os
import subprocess
import tempfile

import numpy as np
from PIL import Image

SEED = 26
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRITER = os.path.join(ROOT, "build", "webp_fixture_writer")


def smooth(rng: np.random.Generator, h: int, w: int, c: int = 3,
           noise: int = 12) -> np.ndarray:
    """Low-resolution noise upsampled by PIL, plus a little fine noise."""
    base = rng.integers(0, 256, (max(h // 12, 2), max(w // 12, 2), c),
                        np.uint8)
    img = np.dstack([np.asarray(Image.fromarray(base[..., k]).resize(
        (w, h), Image.BILINEAR)) for k in range(c)])
    fine = rng.integers(-noise, noise + 1, img.shape)
    return np.clip(img.astype(int) + fine, 0, 255).astype(np.uint8)


def with_alpha(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """RGBA: a smooth alpha with a fully transparent corner and an opaque
    one."""
    h, w = img.shape[:2]
    a = smooth(rng, h, w, 1, 0)[..., 0]
    a[: h // 3, : w // 3] = 0
    a[-(h // 3):, -(w // 3):] = 255
    return np.dstack([img[..., :3], a])


def paletted(rng: np.random.Generator, h: int, w: int, colors: int,
             channels: int) -> np.ndarray:
    """An image of at most ``colors`` colours: bands and blocks of a random
    palette."""
    pal = rng.integers(0, 256, (colors, channels), np.uint8)
    idx = (np.arange(w)[None, :] // 3 + np.arange(h)[:, None] // 5) % colors
    idx[h // 2:] = rng.integers(0, colors, (h - h // 2, w))
    return pal[idx]


def pil_webp(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def pil_animation(frames, **kw) -> bytes:
    ims = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, "WEBP", save_all=True, append_images=ims[1:],
                duration=100, loop=0, **kw)
    return buf.getvalue()


def libwebp_file(frames, **config) -> bytes:
    """A WebP of uint8 (H, W, 3 or 4) frames written by the system's
    libwebp (scripts/webp_fixture_writer.c, built here at first use), with
    ``config``'s WebPConfig fields; ``canvas=(cw, ch, x, y)`` for an
    animation with the first frame at (x, y)."""
    src = os.path.join(ROOT, "scripts", "webp_fixture_writer.c")
    if (not os.path.exists(WRITER)
            or os.path.getmtime(WRITER) < os.path.getmtime(src)):
        os.makedirs(os.path.dirname(WRITER), exist_ok=True)
        tmp = f"{WRITER}.{os.getpid()}.tmp"
        subprocess.run(["cc", "-O2", "-o", tmp, src, "-lwebpmux", "-lwebp"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, WRITER)
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    h, w, c = frames[0].shape
    args = [f"frames={len(frames)}"]
    for key, value in config.items():
        if key == "canvas":
            value = ",".join(str(v) for v in value)
        args.append(f"{key}={value}")
    with tempfile.TemporaryDirectory() as tmp:
        raw, out = os.path.join(tmp, "in"), os.path.join(tmp, "out.webp")
        with open(raw, "wb") as f:
            for frame in frames:
                f.write(frame.tobytes())
        subprocess.run([WRITER, raw, out, str(w), str(h), str(c), *args],
                       check=True, capture_output=True, timeout=60)
        with open(out, "rb") as f:
            return f.read()


def fixtures() -> dict:
    rng = np.random.default_rng(SEED)
    out = {}
    for q, m in ((0, 0), (50, 6), (75, 0), (95, 6), (100, 0)):
        out[f"lossy_q{q}_m{m}"] = pil_webp(smooth(rng, 45, 67), quality=q,
                                           method=m)
    out["lossy_alpha"] = pil_webp(with_alpha(rng, smooth(rng, 50, 70)),
                                  quality=80)
    out["lossy_alpha_exact"] = pil_webp(
        with_alpha(rng, smooth(rng, 33, 47)), quality=60, exact=True,
        alpha_quality=50)
    out["lossless_photo"] = pil_webp(smooth(rng, 41, 59, noise=20),
                                     lossless=True)
    out["lossless_photo_alpha_m6"] = pil_webp(
        with_alpha(rng, smooth(rng, 29, 37)), lossless=True, quality=100,
        method=6)
    for colors in (2, 4, 16, 256):
        for exact in (False, True):
            channels = 4 if exact else 3
            out[f"lossless_{colors}c{'_exact' if exact else ''}"] = pil_webp(
                paletted(rng, 27, 45, colors, channels), lossless=True,
                exact=exact)
    out["animated"] = pil_animation([smooth(rng, 40, 52) for _ in range(3)],
                                    quality=70)
    # the C writer's
    photo = smooth(rng, 61, 83)
    out["simple_filter"] = libwebp_file([photo], filter_type=0,
                                        filter_strength=60, quality=40)
    out["filter_strength_0"] = libwebp_file([photo], filter_strength=0,
                                            quality=40)
    out["sharpness_7"] = libwebp_file([photo], filter_type=1,
                                      filter_strength=90, filter_sharpness=7,
                                      quality=30)
    out["one_segment"] = libwebp_file([photo], segments=1, quality=60)
    out["partitions_8"] = libwebp_file([smooth(rng, 131, 47)], partitions=3,
                                       quality=70)
    out["near_lossless"] = libwebp_file([smooth(rng, 39, 57)], lossless=1,
                                        near_lossless=40)
    # ALPH: raw, and lossless under each filter (libwebp filters only a
    # compressed plane; the alpha patterns make its choice the named one)
    y, x = np.mgrid[0:37, 0:49]
    plane = np.clip(2 * x + 3 * y + rng.integers(0, 3, x.shape), 0, 255)
    product = (x * y) % 256
    for name, alpha, filtering, compression, want in (
            ("alpha_raw", product, 0, 0, 0),
            ("alpha_lossless_none", product, 0, 1, 0),
            ("alpha_lossless_horizontal", plane, 1, 1, 1),
            ("alpha_lossless_vertical", product, 2, 1, 2),
            ("alpha_lossless_gradient", product, 1, 1, 3)):
        rgba = np.dstack([smooth(rng, 37, 49), alpha.astype(np.uint8)])
        data = libwebp_file([rgba], alpha_filtering=filtering,
                            alpha_compression=compression, quality=70)
        header = data[data.find(b"ALPH") + 8]
        assert (header & 3, (header >> 2) & 3) == (compression, want), name
        out[name] = data
    out["anim_offset"] = libwebp_file(
        [with_alpha(rng, smooth(rng, 30, 40)) for _ in range(2)],
        canvas=(64, 56, 12, 20), quality=75)
    out["anim_offset_lossless"] = libwebp_file(
        [smooth(rng, 21, 27) for _ in range(2)], canvas=(40, 36, 6, 10),
        lossless=1)
    return out


def trainer_files() -> dict:
    """Two files at COCO's 640x480 for chip_smoke.py's trainer and http
    phases, which cannot write WebP: lossy with alpha, and lossless."""
    rng = np.random.default_rng(SEED + 1)

    def photo():   # smooth, without the fine noise
        base = rng.integers(0, 256, (15, 20, 3), np.uint8)
        return np.asarray(Image.fromarray(base).resize((640, 480),
                                                       Image.BILINEAR))

    # flat blocks, so that the stored pixels stay small; posterised to 11
    # levels a channel, too many colours for a palette
    blocks = np.kron(rng.integers(0, 8, (15, 20, 3)) * 32,
                     np.ones((32, 32, 1), np.int64)).astype(np.uint8)
    return {"trainer_lossy_alpha": pil_webp(with_alpha(rng, blocks),
                                            quality=80),
            "trainer_lossless": pil_webp(photo() // 24 * 24,
                                         lossless=True)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                  "webp"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    pixels = {}
    for name, data in {**fixtures(), **trainer_files()}.items():
        with open(os.path.join(args.out, f"{name}.webp"), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            pixels[name] = np.asarray(im.convert("RGB"))
    np.savez_compressed(os.path.join(args.out, "pixels.npz"), **pixels)
    print(f"wrote {len(pixels)} WebP files and pixels.npz to {args.out}")


if __name__ == "__main__":
    main()
