"""The port's QOI reader, with the native library (the machine with the
card has no PIL).

``read_qoi`` reads a Quite OK Image as PIL's ``Image.open(...)
.convert("RGB")`` gives it. Pillow 12's QoiImagePlugin is the
specification:

* ``_open``: the magic ``qoif``, then the width and height (big-endian,
  32 bits each) and the channels byte, RGB where it is 3 and RGBA for any
  other value; bytes too short for them, or a width or height of 0, pass
  the bytes on (``OpenRefusal``); the colour-space byte is skipped, and
  the ops start at byte 14;
* QoiDecoder's ops (``native/qoi.cpp``), as Pillow applies them, not as
  the format's reference decoder does (a run stores nothing in the table
  of seen pixels, and an empty slot is (0, 0, 0, 0)); data that ends
  before the last pixel is refused, and nothing past it is read;
* ``convert("RGB")`` drops the alpha.

An image above PIL's decompression-bomb limit is refused, and so is one
whose data cannot hold its pixels (an op of one byte gives at most 62),
both before anything of its size is allocated.
"""

from __future__ import annotations

import struct

import numpy as np

from mastermetastyletransfer_tpu_torch.utils.png import MAX_PIXELS, OpenRefusal


def accept(prefix: bytes) -> bool:
    """QoiImagePlugin._accept."""
    return prefix[:4] == b"qoif"


def read_qoi(data: bytes) -> np.ndarray:
    """A QOI file's pixels as uint8 (H, W, 3) RGB, as PIL's convert("RGB")
    gives them."""
    from mastermetastyletransfer_tpu_torch.data import native_loader

    if len(data) < 13:   # i32 of a short read, or read(1)[0] of none
        raise OpenRefusal(f"QOI: a header of {len(data)} bytes")
    w, h = struct.unpack_from(">II", data, 4)
    bands = 3 if data[12] == 3 else 4
    if w <= 0 or h <= 0:
        raise OpenRefusal(f"QOI: an image of {w}x{h} pixels")
    if w * h > MAX_PIXELS:   # Image.open's bomb check
        raise ValueError(f"QOI: an image of {w}x{h} pixels is above the "
                         f"limit of {MAX_PIXELS} (a decompression bomb)")
    body = data[14:]
    if 62 * len(body) < w * h:
        raise ValueError("QOI: the data ends before the last pixel")
    px = native_loader.decode_qoi(body, w * h, bands)
    return np.ascontiguousarray(px[:, :3].reshape(h, w, 3))
