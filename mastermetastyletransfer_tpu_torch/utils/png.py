"""The port's image writer: 8-bit RGB PNG with the standard library and
numpy (the machine with the card has no PIL). The trainer's dumps, the eval
grid's stylized images and the adaptation CLI's outputs all go through it;
the JAX package writes the last two as JPEG (quality 95) through PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of uint8 (H, W, 3): filter 0 on every row, one
    IDAT, zlib's default compression."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)], 1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def save_png(path: str, img01: np.ndarray) -> None:
    """A float RGB image in [0, 1] as an 8-bit PNG (values scaled by 255,
    clipped, truncated, as the JAX package quantizes them for PIL)."""
    with open(path, "wb") as f:
        f.write(png_bytes(np.clip(img01 * 255, 0, 255).astype(np.uint8)))
