"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

into ``build/`` at the repository root (listed in .gitignore), keyed by a
hash of every file under csrc/ (the sources share a header) and the flags,
so an edited source builds anew and an unchanged one is loaded as it is.
The library has a plain C interface: no PyTorch headers, which keeps a
build to seconds. ``build_all`` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from csrc/ at first use")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, building it first if needed."""
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return ctypes.CDLL(str(out))


def build_all() -> Dict[str, float]:
    """Build and load every source, the builds side by side; returns {name:
    seconds of its build} (0.0 for a library that was already built)."""
    def timed(name):
        fresh = not library_path(name).exists()
        t0 = time.perf_counter()
        load(name)
        return time.perf_counter() - t0 if fresh else 0.0

    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))
