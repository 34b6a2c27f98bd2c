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

A train-state checkpoint (JAX counterpart: utils/checkpoint.py:26-67) is
the port's own format; the JAX package writes Orbax, which the machine
with the card does not have. ``save_checkpoint`` writes

    <dir>/<step>/params.npz   every leaf, in the flat .npz key scheme (so
                              the JAX package's load_params_npz reads it)
    <dir>/<step>/opt.npz      Adam's moments, "mu/<key>" and "nu/<key>"
                              for each trainable leaf's flat key
    <dir>/<step>/state.json   {"step": the state's step, "count": Adam's}
    <dir>/config.json         the run's configuration, when given

into a temporary directory first, renamed into place when complete;
``restore_checkpoint`` copies them back into a train state's tensors, in
place, on their devices.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

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


def _cpu_arrays(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


def save_checkpoint(ckpt_dir: str, state, step: int, *,
                    config_json: Optional[str] = None) -> str:
    """Write the train state (``train.state.TrainState``) at
    ``ckpt_dir/step``, replacing a checkpoint of that step; returns the
    path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, str(int(step)))
    tmp = os.path.join(ckpt_dir, f".{int(step)}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    save_params_npz(os.path.join(tmp, "params.npz"), state.params)
    keys = list(state.trainable())
    np.savez(os.path.join(tmp, "opt.npz"),
             **_cpu_arrays({f"mu/{k}": v for k, v in zip(keys, state.opt.mu)}),
             **_cpu_arrays({f"nu/{k}": v for k, v in zip(keys, state.opt.nu)}))
    with open(os.path.join(tmp, "state.json"), "w") as f:
        json.dump({"step": int(state.step), "count": int(state.opt.count)}, f)
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


def _copy_into(dst: torch.Tensor, arr: np.ndarray, key: str) -> None:
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{key}: shape {arr.shape} in the checkpoint, "
                         f"{tuple(dst.shape)} expected")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(arr)))


def restore_checkpoint(ckpt_dir: str, state, *, step: Optional[int] = None):
    """Restore the checkpoint of ``step`` (the latest if None) into
    ``state``: its parameters, Adam's moments and count, and its step, each
    tensor copied in place on its device. Returns the state. Raises
    FileNotFoundError without a checkpoint, KeyError or ValueError where
    the checkpoint's leaves, trainable leaves or shapes are not the
    state's."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), str(int(step)))
    leaves = flatten_params(state.params)
    keys = list(state.trainable())
    with np.load(os.path.join(path, "params.npz")) as data:
        if set(data.files) != set(leaves):
            raise KeyError(f"{path}: the checkpoint's leaves are not the "
                           f"state's")
        for key, leaf in leaves.items():
            _copy_into(leaf, data[key], key)
    with np.load(os.path.join(path, "opt.npz")) as data:
        want = {f"{m}/{k}" for m in ("mu", "nu") for k in keys}
        if set(data.files) != want:
            raise KeyError(f"{path}: the checkpoint's trainable leaves are "
                           f"not the state's (another training mode?)")
        for moments, m in ((state.opt.mu, "mu"), (state.opt.nu, "nu")):
            for key, t in zip(keys, moments):
                _copy_into(t, data[f"{m}/{key}"], f"{m}/{key}")
    with open(os.path.join(path, "state.json")) as f:
        meta = json.load(f)
    state.step = int(meta["step"])
    state.opt.count = int(meta["count"])
    return state
