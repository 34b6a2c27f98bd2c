"""Parameter interchange with the JAX package.

Parameters in the port are the JAX package's nested dicts with torch
tensors as leaves: the same keys, the same shapes and the same layouts
(linear kernels (in, out), conv kernels HWIO). Two ways in:

* ``load_params_npz`` reads the flat ``.npz`` written by the JAX package's
  ``save_params_npz`` (utils/checkpoint.py:70-101 there): one array per
  leaf, keyed by its path joined with "/", list items by their index;
* ``params_from_jax`` takes a nested params dict with numpy leaves (a JAX
  param tree after ``jax.device_get``) and converts it leaf by leaf; the
  model's tree and the VGG19 loss's (``init_vgg19_features``, {"conv0":
  {"kernel", "bias"}, ...}) alike.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """The flat key scheme of the ``.npz`` export: {"a/b/0/c": leaf}."""
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(flatten_params(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flatten_params(v, f"{prefix}/{i}"))
    else:
        flat[prefix] = tree
    return flat


def save_params_npz(path: str, params: Any) -> None:
    """Write a param tree in the flat ``.npz`` key scheme."""
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in flatten_params(params).items()})


def load_params_npz(path: str, target: Any) -> Any:
    """Load a flat ``.npz`` export into the structure of ``target``; each
    leaf keeps the device of the target leaf. Raises KeyError on a missing
    key and ValueError on a shape mismatch."""
    with np.load(path) as data:
        def walk(prefix, tree):
            if isinstance(tree, dict):
                return {k: walk(f"{prefix}/{k}" if prefix else str(k), v)
                        for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(f"{prefix}/{i}", v)
                                  for i, v in enumerate(tree))
            arr = data[prefix]
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(f"{prefix}: shape {arr.shape} in the file, "
                                 f"{tuple(tree.shape)} expected")
            return torch.from_numpy(np.array(arr)).to(tree.device)

        return walk("", target)


def params_from_jax(tree: Any, device="cpu") -> Any:
    """Nested JAX params (numpy leaves) -> the port's params (tensors)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of a nested dict/list, or, given
    more trees of the same structure, to the leaves at each position:
    ``fn(leaf, *leaves_of_rest)``. Raises ValueError where the dict keys
    or list lengths differ."""
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or r.keys() != tree.keys()
               for r in rest):
            raise ValueError(f"trees differ at keys {sorted(tree)}")
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if any(not isinstance(r, (list, tuple)) or len(r) != len(tree)
               for r in rest):
            raise ValueError(f"trees differ at a sequence of {len(tree)}")
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
