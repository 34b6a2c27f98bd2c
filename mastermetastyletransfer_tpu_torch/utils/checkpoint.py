"""Parameter interchange with the JAX package, and the train state's
checkpoints.

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

A train-state checkpoint is the JAX package's (utils/checkpoint.py:26-67
there): an Orbax PyTree checkpoint of ``{"state": TrainState}`` per step,

    <dir>/<step>/             the tree of ``train.state.to_pytree``:
                              params, Adam's moments and both of optax's
                              counts, the step (utils/orbax.py)
    <dir>/config.json         the run's configuration, when given

read and written without Orbax. ``save_checkpoint`` writes the layout
Orbax writes with ``use_ocdbt=False`` (a zarr directory per leaf) into a
temporary directory, renamed into place when complete; the JAX package's
``restore_checkpoint`` reads it. ``restore_checkpoint`` copies a step
written in either of Orbax's layouts (the JAX package writes OCDBT) back
into a train state's tensors, in place, on their devices, and still
reads the port's earlier layout where a step holds it (``params.npz``
with every leaf in the flat key scheme, ``opt.npz`` with "mu/<key>" and
"nu/<key>" for each trainable leaf, ``state.json`` with the step and
Adam's count). ``restore_params`` takes the parameters alone, from a
checkpoint of any training mode, as the JAX package's evaluation does.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from mastermetastyletransfer_tpu_torch.utils.orbax import (
    is_pytree, read_pytree, write_pytree,
)


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


def save_checkpoint(ckpt_dir: str, state, step: int, *,
                    config_json: Optional[str] = None) -> str:
    """Write the train state (``train.state.TrainState``) at
    ``ckpt_dir/step``, replacing a checkpoint of that step; returns the
    path."""
    # train.state imports this module
    from mastermetastyletransfer_tpu_torch.train.state import to_pytree

    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, str(int(step)))
    tmp = os.path.join(ckpt_dir, f".{int(step)}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    write_pytree(tmp, to_pytree(state))
    if os.path.exists(path):
        old = f"{tmp}.old"
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
    if config_json is not None:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            f.write(config_json)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    return max(steps) if steps else None


def _step_dir(ckpt_dir: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), str(int(step)))
    if not (os.path.exists(os.path.join(path, "params.npz"))
            or is_pytree(path)):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return path


def copy_leaf(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst takes src's values, in place on dst's device, and src's dtype
    where they differ (JAX's restore gives a leaf the checkpoint's
    dtype)."""
    with torch.no_grad():
        if src.dtype == dst.dtype:
            dst.copy_(src)
        else:
            dst.data = src.to(dst.device)


def _read_step(path: str, keep=None) -> dict:
    """The tree of the step directory ``path`` as ``read_pytree`` gives it
    (those leaves ``keep`` takes, where given), from either Orbax layout
    or the port's earlier one."""
    from mastermetastyletransfer_tpu_torch.train.state import optax_tree

    if not os.path.exists(os.path.join(path, "params.npz")):
        return read_pytree(path, keep)

    def load(name: str) -> dict:
        with np.load(os.path.join(path, name)) as data:
            return {tuple(int(k) if k.isdigit() else k
                          for k in key.split("/")):
                    torch.from_numpy(np.array(data[key]))
                    for key in data.files}

    params, opt = load("params.npz"), load("opt.npz")
    moments = {m: {k[1:]: v for k, v in opt.items() if k[0] == m}
               for m in ("mu", "nu")}
    if len(moments["mu"]) + len(moments["nu"]) != len(opt) or not (
            set(moments["mu"]) | set(moments["nu"])) <= set(params):
        raise KeyError(f"{path}: opt.npz holds moments of no parameter")
    with open(os.path.join(path, "state.json")) as f:
        meta = json.load(f)
    return dict(optax_tree(meta["step"], meta["count"], params,
                           moments["mu"], moments["nu"]))


def restore_checkpoint(ckpt_dir: str, state, *, step: Optional[int] = None):
    """Restore the checkpoint of ``step`` (the latest if None) into
    ``state``: its parameters, Adam's moments and count, and its step, each
    tensor copied in place on its device. Returns the state. Raises
    FileNotFoundError without a checkpoint, KeyError where the
    checkpoint's leaves or trainable leaves are not the state's, and
    ValueError where its shapes are not the state's or its data is
    damaged."""
    from mastermetastyletransfer_tpu_torch.train.state import load_pytree

    path = _step_dir(ckpt_dir, step)
    return load_pytree(state, _read_step(path), path)


def restore_params(ckpt_dir: str, params: Any, *,
                   step: Optional[int] = None) -> Any:
    """Copy the parameters of the checkpoint of ``step`` (the latest if
    None) into ``params``, in place on their devices, whatever the
    training mode that wrote it; returns ``params``. Raises
    FileNotFoundError without a checkpoint, KeyError where its parameter
    leaves are not those of ``params``, ValueError where a shape differs
    or the data is damaged."""
    from mastermetastyletransfer_tpu_torch.train.state import param_paths

    path = _step_dir(ckpt_dir, step)
    dst = param_paths(params)
    src = {k[2:]: v for k, v in _read_step(
        path, keep=lambda k: k[:2] == ("state", "params")).items()
        if k[:2] == ("state", "params")}
    if set(src) != set(dst):
        raise KeyError(f"{path}: the checkpoint's parameters are not the "
                       f"model's: {sorted(map(str, set(dst) ^ set(src)))[:3]}")
    for k, v in dst.items():
        if tuple(src[k].shape) != tuple(v.shape):
            raise ValueError(f"{path}: {k}: shape {tuple(src[k].shape)} in "
                             f"the checkpoint, {tuple(v.shape)} expected")
    for k, v in dst.items():
        copy_leaf(v, src[k])
    return params
