"""ctypes bridge to the native C++ JPEG decode + resize loader (JAX
counterpart: data/native_loader.py).

``native/loader.cpp`` is compiled on first use with the flags of the JAX
package's native/build.sh,

    g++ -O3 -march=native -shared -fPIC -o build/libmmst_loader-<hash>.so
        native/loader.cpp -ljpeg -lpthread

into ``build/`` at the repository root (listed in .gitignore), keyed by a
hash of the source and the flags; the library is written to a temporary
file first and renamed into place. Nothing is written inside the package.
It is a host decode: it runs on the CPU, not on the device.

A file the library fails on (not a JPEG, or a broken one) goes through
``data.pipeline._decode_resize``, file by file; where g++ or libjpeg is
missing and the library does not build, every file does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
LIBS = ["-ljpeg", "-lpthread"]

_lock = threading.Lock()
_state = {"lib": None, "failed": False}


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmmst_loader-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        tmp.unlink(missing_ok=True)


def _load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None where it does not
    build or load (then and later: one attempt per process)."""
    with _lock:
        if _state["lib"] is not None or _state["failed"]:
            return _state["lib"]
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError):
            _state["failed"] = True
            return None
        lib.mmst_decode_resize_batch.restype = ctypes.c_int
        lib.mmst_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        _state["lib"] = lib
        return lib


def native_available() -> bool:
    return _load_library() is not None


def decode_resize_batch(paths: List[str], resize_to: int,
                        n_threads: int = 4) -> np.ndarray:
    """Decode and resize a batch of image files to uint8 (N, S, S, 3).

    JPEGs go through the native library; a file it fails on, and every
    file where it is not available, through ``_decode_resize``."""
    n = len(paths)
    out = np.empty((n, resize_to, resize_to, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    lib = _load_library()
    if lib is not None and n:
        names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        lib.mmst_decode_resize_batch(
            names, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            resize_to, n_threads,
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    for i in np.flatnonzero(ok == 0):
        from mastermetastyletransfer_tpu_torch.data.pipeline import (
            _decode_resize,
        )
        out[i] = _decode_resize(paths[i], resize_to)
    return out
