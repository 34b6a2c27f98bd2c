"""zarr v2 arrays over a key-value mapping: the arrays of an Orbax
checkpoint (JAX counterpart: utils/checkpoint.py:21-67, through
tensorstore's ``zarr`` format), read from an OCDBT store
(``utils/ocdbt.py``) or a directory (``DirectoryStore``), and written
into a directory.

An array ``name`` is the key ``<name>/.zarray``, JSON:

    {"chunks": [...], "compressor": null | {"id": "zstd", ...},
     "dimension_separator": "." | "/", "dtype": "<f4", "fill_value": ...,
     "filters": null, "order": "C" | "F", "shape": [...], "zarr_format": 2}

and one key per chunk of the grid that covers the shape,
``<name>/<i>.<j>...`` (``"0"`` for a 0-d array), each the chunk's whole
block of ``chunks`` (edge chunks padded), raw or one Zstandard frame; an
absent chunk is ``fill_value`` (0 where null). ``dtype`` is a numpy type
string of a boolean, integer or float kind, or ``"bfloat16"``, which numpy
has no type for: it is read as uint16 and viewed as ``torch.bfloat16``.
Anything else (zarr v3, another compressor, filters, structured types)
raises ValueError naming it; so does a chunk whose frame does not decode
or whose size is not its block's, naming the file it came from.

The writer writes what Orbax writes for one leaf with ``use_ocdbt=False``,
less the compression (the port has no Zstandard encoder): one chunk the
size of the array, C order, compressor null.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Optional

import numpy as np
import torch

_KINDS = "biuf"


class DirectoryStore:
    """The files under ``root`` as a key-value mapping: key ``a/b`` is the
    file ``root/a/b``."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def where(self, key: str) -> str:
        return os.path.join(self.root, key)

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self.where(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None


def _dtype(name: str, where: str) -> np.dtype:
    """The numpy type of a chunk's bytes (bfloat16: its uint16 bits)."""
    if name == "bfloat16":
        return np.dtype("<u2")
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    if dt is None or dt.kind not in _KINDS or dt.str != name:
        raise ValueError(f"{where}: dtype {name!r} is not read")
    return dt


def _fill(value, dtype: np.dtype, bf16: bool, where: str):
    if value is None:
        return 0
    if isinstance(value, str):
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in special or not (bf16 or dtype.kind == "f"):
            raise ValueError(f"{where}: fill_value {value!r} is not read")
        value = special[value]
    if bf16:
        f32 = np.array(value, dtype=np.float32)
        return torch.from_numpy(f32.reshape(1)).to(
            torch.bfloat16).view(torch.int16).item() & 0xFFFF
    return value


def read_array(kv, name: str) -> torch.Tensor:
    """The zarr v2 array ``name`` of ``kv`` (an object with ``get(key)`` and
    ``where(key)``) as a CPU tensor of its dtype."""
    key = f"{name}/.zarray"
    raw = kv.get(key)
    if raw is None:
        raise ValueError(f"{kv.where(key)}: no such array in the store")
    where = kv.where(key)
    try:
        meta = json.loads(raw)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{where}: not JSON ({e})") from None
    if not isinstance(meta, dict) or meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: not zarr v2 array metadata")
    if meta.get("filters"):
        raise ValueError(f"{where}: filters {meta['filters']} are not read")
    comp = meta.get("compressor")
    if comp is not None and (not isinstance(comp, dict)
                             or comp.get("id") != "zstd"):
        raise ValueError(f"{where}: compressor {comp} is not read")
    shape, chunks = meta.get("shape"), meta.get("chunks")
    if (not isinstance(shape, list) or not isinstance(chunks, list)
            or len(shape) != len(chunks)
            or not all(isinstance(s, int) and s >= 0 for s in shape)
            or not all(isinstance(c, int) and c >= 1 for c in chunks)):
        raise ValueError(f"{where}: shape {shape} and chunks {chunks}")
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    if order not in ("C", "F") or sep not in (".", "/"):
        raise ValueError(f"{where}: order {order!r}, dimension_separator "
                         f"{sep!r}")
    bf16 = meta.get("dtype") == "bfloat16"
    dt = _dtype(meta.get("dtype"), where)
    out = np.full(shape, _fill(meta.get("fill_value"), dt, bf16, where),
                  dtype=dt.newbyteorder("="))
    block = math.prod(chunks) * dt.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        ckey = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = kv.get(ckey)
        if data is None:
            continue
        if comp is not None:
            # imported here: the data package imports utils.checkpoint,
            # which imports this module
            from mastermetastyletransfer_tpu_torch.data import native_loader
            try:
                data = native_loader.decode_zstd_frame(data, block)
            except ValueError as e:
                raise ValueError(f"{kv.where(ckey)}: {e}") from None
        if len(data) != block:
            raise ValueError(f"{kv.where(ckey)}: a chunk of {len(data)} "
                             f"bytes, {block} expected")
        part = np.frombuffer(data, dtype=dt).reshape(chunks, order=order)
        dst = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[dst] = part[tuple(slice(0, d.stop - d.start) for d in dst)]
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if bf16 else t


def write_array(root: str, name: str, t: torch.Tensor) -> None:
    """Write ``t`` as the zarr v2 array ``name`` under the directory
    ``root``: ``root/<name>/.zarray`` and its one chunk."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        arr, dtype = t.view(torch.int16).numpy(), "bfloat16"
    else:
        arr = t.numpy()
        dtype = arr.dtype.str
        _dtype(dtype, name)
    shape = list(arr.shape)
    meta = {"chunks": [max(s, 1) for s in shape], "compressor": None,
            "dimension_separator": ".", "dtype": dtype, "fill_value": None,
            "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
    d = os.path.join(root, name)
    os.makedirs(d)
    with open(os.path.join(d, ".zarray"), "w") as f:
        json.dump(meta, f, separators=(",", ":"))
    if arr.size:
        with open(os.path.join(d, ".".join("0" * arr.ndim) or "0"),
                  "wb") as f:
            f.write(arr.tobytes())
