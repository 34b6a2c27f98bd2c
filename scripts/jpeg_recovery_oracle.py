"""Hold the port's n/8 JPEG decode (``mmst_jpeg_decode_scaled``, the
batch loader's) to libjpeg as the JAX package's loader runs it, on the
CPU, before any resize: the system's libjpeg-turbo through a small C
library (scripts/jpeg_recovery_oracle.c, compiled with ``cc ... -ljpeg``
into the gitignored build/), ``jpeg_stdio_src`` (a fake EOI past the
file's end), ``scale_num`` n / 8, ``JCS_RGB``, warnings not fatal. The
way to see what libjpeg makes of a cut or damaged file: the verdicts,
the pixels, and ``coefficients`` (``jpeg_read_coefficients``: what each
block holds after the scans, the blocks a damaged scan never reached
included).

    python scripts/jpeg_recovery_oracle.py FILE [FILE ...] [--n 1,2,4,8]

Prints one JSON line a file and scale: both verdicts (libjpeg's message
where it refuses, the port's where it does) and, where both decode, the
count of values that differ and the first differing pixel.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
SOURCE = os.path.join(ROOT, "scripts", "jpeg_recovery_oracle.c")
_LIB = {}


def library() -> ctypes.CDLL:
    if "lib" in _LIB:
        return _LIB["lib"]
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(ROOT, "build", f"jpeg_recovery_oracle-{digest}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", tmp, SOURCE,
                        "-ljpeg"], check=True, capture_output=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    lib.jro_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long), ctypes.c_char_p, ctypes.c_int]
    lib.jro_coefficients.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    _LIB["lib"] = lib
    return lib


def _with_file(data: bytes, fn):
    fd, path = tempfile.mkstemp(suffix=".jpg")
    try:
        os.write(fd, data)
        os.close(fd)
        return fn(path.encode())
    finally:
        os.unlink(path)


def decode(data: bytes, n: int):
    """libjpeg's n/8 RGB pixels of the bytes, or its message where it
    refuses them: (array or None, message or None)."""
    lib = library()
    w, h, warn = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
    err = ctypes.create_string_buffer(512)
    cap = 1 << 26
    out = np.empty(cap, np.uint8)

    def run(path):
        return lib.jro_decode(path, n, out.ctypes.data, cap, ctypes.byref(w),
                              ctypes.byref(h), ctypes.byref(warn), err, 512)

    if _with_file(data, run):
        return None, err.value.decode(errors="replace")
    return out[:w.value * h.value * 3].reshape(h.value, w.value, 3).copy(), \
        None


def coefficients(data: bytes):
    """Each component's quantized coefficients after every scan (height
    in blocks, width in blocks, 64, natural order), or libjpeg's message."""
    lib = library()
    dims = (ctypes.c_int * 9)()
    err = ctypes.create_string_buffer(512)
    out = np.empty(1 << 24, np.int16)

    def run(path):
        return lib.jro_coefficients(path, out.ctypes.data, out.size, dims,
                                    err, 512)

    if _with_file(data, run):
        return err.value.decode(errors="replace")
    comps, used = [], 0
    for c in range(dims[0]):
        bw, bh = dims[1 + 2 * c], dims[2 + 2 * c]
        comps.append(out[used:used + bw * bh * 64].reshape(bh, bw, 64).copy())
        used += bw * bh * 64
    return comps


def port_decode(data: bytes, n: int):
    """The port's ``mmst_jpeg_decode_scaled`` at n/8: (array or None,
    message or None)."""
    from mastermetastyletransfer_tpu_torch.data import native_loader as nl

    lib = nl._library()
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    if lib.mmst_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                          err, 256):
        return None, err.value.decode(errors="replace")
    out = np.empty(((h.value * n + 7) // 8, (w.value * n + 7) // 8, 3),
                   np.uint8)
    if lib.mmst_jpeg_decode_scaled(data, len(data), n,
                                   out.ctypes.data_as(nl._u8p), out.shape[1],
                                   out.shape[0], err, 256):
        return None, err.value.decode(errors="replace")
    return out, None


def compare(data: bytes, n: int) -> dict:
    want, why = decode(data, n)
    got, port_why = port_decode(data, n)
    row = {"n": n, "libjpeg": why or "decodes", "port": port_why or "decodes"}
    if want is not None and got is not None:
        if want.shape != got.shape:
            row["shapes"] = [list(want.shape), list(got.shape)]
        else:
            bad = np.argwhere(want != got)
            row["values_differing"] = int(len(bad))
            if len(bad):
                row["first"] = [int(v) for v in bad[0]]
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+")
    ap.add_argument("--n", default="1,2,3,4,5,6,7,8")
    args = ap.parse_args(argv)
    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        for n in (int(v) for v in args.n.split(",")):
            print(json.dumps({"file": path, **compare(data, n)}))


if __name__ == "__main__":
    main()
