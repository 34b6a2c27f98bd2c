"""Orbax's PyTree checkpoint of one step directory, read and written
without Orbax (JAX counterpart: utils/checkpoint.py:21-67, through
``orbax.checkpoint.PyTreeCheckpointer``; the layout of orbax-checkpoint
0.11).

A tree is a dict ``{key: leaf}``. A key is the leaf's path from the root,
a tuple whose items are ``str`` (a dict key or a named field) or ``int``
(a sequence index); a leaf is a tensor, or None where Orbax keeps a
placeholder and no value (optax's ``MaskedNode`` and ``EmptyState``).

    <step>/_METADATA             JSON: "tree_metadata" maps each leaf's
                                 key tuple (as text) to its
                                 "key_metadata" (each item's "key" and
                                 "key_type": 1 a sequence index, 2 a dict
                                 key) and "value_metadata" ("value_type",
                                 "skip_deserialize" for a placeholder);
                                 "use_ocdbt", "use_zarr3"
    <step>/_CHECKPOINT_METADATA  JSON: the handler, the timestamps
    <step>/manifest.ocdbt, d/, ocdbt.process_<n>/
                                 use_ocdbt: one OCDBT store (utils/ocdbt.py)
                                 holding every leaf's zarr array
    <step>/<name>/.zarray, <name>/0.0 ...
                                 otherwise: a directory per leaf

where a leaf's array is named by its key's items joined with ".". Zarr v3
(``use_zarr3``) and Orbax's per-array metadata files (``array_metadatas/``)
are refused by name. ``write_pytree`` writes the second layout, as Orbax
writes it with ``use_ocdbt=False`` (uncompressed: utils/zarr.py); Orbax's
default ``restore`` reads it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch

from mastermetastyletransfer_tpu_torch.utils.ocdbt import OcdbtStore
from mastermetastyletransfer_tpu_torch.utils.zarr import (
    DirectoryStore, read_array, write_array,
)

Key = Tuple[Union[str, int], ...]
_SEQUENCE, _DICT = 1, 2
_ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
_HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
            "PyTreeCheckpointHandler")


def is_pytree(path: str) -> bool:
    """Whether ``path`` is a step directory of an Orbax PyTree
    checkpoint."""
    return os.path.isfile(os.path.join(path, "_METADATA"))


def _key(entry: dict, where: str) -> Key:
    items = []
    for k in entry.get("key_metadata", ()):
        kind, name = k.get("key_type"), k.get("key")
        if kind == _SEQUENCE and isinstance(name, str) and name.isdigit():
            items.append(int(name))
        elif kind == _DICT and isinstance(name, str):
            items.append(name)
        else:
            raise ValueError(f"{where}: a key item {k} is not read")
    if not items:
        raise ValueError(f"{where}: a leaf without a key")
    return tuple(items)


def read_pytree(path: str, keep: Optional[Callable[[Key], bool]] = None
                ) -> Dict[Key, Optional[torch.Tensor]]:
    """Every leaf of the checkpoint in the step directory ``path`` (those
    ``keep`` takes, where given) as CPU tensors, placeholders as None.
    Raises ValueError where the checkpoint is damaged or of a layout not
    read."""
    where = os.path.join(path, "_METADATA")
    with open(where) as f:
        try:
            meta = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{where}: not JSON ({e})") from None
    if not isinstance(meta, dict) or not isinstance(
            meta.get("tree_metadata"), dict):
        raise ValueError(f"{where}: no tree_metadata")
    if meta.get("use_zarr3"):
        raise ValueError(f"{where}: use_zarr3 (zarr v3 arrays) is not read")
    if os.path.exists(os.path.join(path, "array_metadatas")):
        raise ValueError(f"{path}: array_metadatas (Orbax's per-array "
                         f"metadata files) are not read")
    if not isinstance(meta.get("use_ocdbt"), bool):
        raise ValueError(f"{where}: no use_ocdbt")
    store = OcdbtStore(path) if meta["use_ocdbt"] else DirectoryStore(path)
    leaves = {}
    for entry in meta["tree_metadata"].values():
        if not isinstance(entry, dict):
            raise ValueError(f"{where}: a leaf entry {entry!r}")
        key = _key(entry, where)
        if key in leaves:
            raise ValueError(f"{where}: the leaf {key} twice")
        value = entry.get("value_metadata") or {}
        kind = value.get("value_type")
        if value.get("skip_deserialize"):
            if kind != "None":
                raise ValueError(f"{where}: {key}: a skipped leaf of type "
                                 f"{kind!r}")
            leaves[key] = None
        elif kind not in _ARRAY_TYPES:
            raise ValueError(f"{where}: {key}: value type {kind!r} is not "
                             f"read")
        elif keep is None or keep(key):
            leaves[key] = read_array(store, ".".join(map(str, key)))
    return leaves


def write_pytree(path: str,
                 leaves: Iterable[Tuple[Key, Optional[torch.Tensor]]]) -> None:
    """Write the leaves, in the order given, as a checkpoint in the new
    directory ``path``."""
    t0 = time.time_ns()
    os.makedirs(path)
    tree = {}
    for key, leaf in leaves:
        if leaf is not None:
            write_array(path, ".".join(map(str, key)), leaf)
        tree[str(tuple(map(str, key)))] = {
            "key_metadata": [
                {"key": str(k), "key_type": _SEQUENCE if isinstance(k, int)
                 else _DICT} for k in key],
            "value_metadata": {
                "value_type": "None" if leaf is None else "np.ndarray",
                "skip_deserialize": leaf is None}}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": t0,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
