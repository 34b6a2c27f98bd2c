"""Write the JAX-written train-state checkpoints under tests/data/orbax/,
and digests.json beside them, from fixed seeds.

    JAX_PLATFORMS=cpu python scripts/make_orbax_fixtures.py [--out DIR]

Each fixture is an experiment's ``checkpoints`` directory as the JAX
package's trainer leaves it (``<step>/`` and ``config.json``), written by
the JAX package after two of its own training steps, at the narrowest
model whose Swin and style transformer the port's kernels take
(``fixture_config``; 3.3 MB for the two):

* ``plain_ocdbt``: plain mode, the Swin frozen, written by the JAX
  package's ``save_checkpoint`` (Orbax's default layout: one OCDBT store);
* ``fast_adaptation_leaves``: fast adaptation (the style encoder alone
  trains), written by Orbax's ``PyTreeCheckpointHandler(use_ocdbt=False)``
  (a zarr directory per leaf), with two bfloat16 leaves among its
  parameters (the CNN decoder's last bias, frozen, and the style
  encoder's first bias, trained: its Adam moments are bfloat16 too).

``digests.json`` holds, for each fixture, its mode, step, layout, crop
size and batch, and for every array leaf as the JAX package's ``restore_checkpoint``
gives it (into ``create_train_state``'s tree at the fixture's config):
its key path (dict keys and field names as text, sequence indices as
integers), dtype, shape and the SHA-256 of its bytes in C order. The CPU
tests (tests/test_torch_orbax_format.py) read the fixtures with JAX and
with the port against the digests; chip_smoke.py's ``orbax`` phase with
the port alone, on the machine with the card, which has neither JAX nor
Orbax, and takes one step from each.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mastermetastyletransfer_tpu import config as jcfg  # noqa: E402
from mastermetastyletransfer_tpu.models import master as jmaster  # noqa: E402
from mastermetastyletransfer_tpu.train import state as jstate  # noqa: E402
from mastermetastyletransfer_tpu.train import step as jstep  # noqa: E402
from mastermetastyletransfer_tpu.utils import checkpoint as jckpt  # noqa: E402

SEED = 30
SIZE, BATCH, STEPS = 64, 2, 2
FIXTURES = {"plain_ocdbt": ("plain", True),
            "fast_adaptation_leaves": ("fast_adaptation", False)}
BF16_LEAVES = {"fast_adaptation_leaves": (("decoder", "conv8", "bias"),
                                          "style_encoder_first_bias")}


def fixture_config(mode: str) -> jcfg.ExperimentConfig:
    """The fixtures' model: the narrowest that the port's Swin and
    style-transformer kernels take (C a multiple of 32, head dim 32, MLP
    width a multiple of 32): swin_custom at 32 channels, one block per
    stage, the style transformer at 64 (2 heads), MLP ratio 1 throughout,
    the CNN decoder from 64 (too narrow for its stencil kernels, which
    want 32 channels after the third halving); bf16 compute, as the
    trainer runs on a TPU; stochastic depth off and k fixed at 1, so that
    a step draws nothing but its inputs."""
    m = jcfg.ModelConfig(compute_dtype="bfloat16")
    m = m.replace(
        swin=jcfg.SwinConfig(variant="swin_custom", embed_dim=32,
                             depths=(1, 1), num_heads=(1, 2), mlp_ratio=1.0,
                             stochastic_depth_probs=(0.0, 0.0)),
        transformer=m.transformer.replace(
            encoder_dim=64, decoder_dim=64, encoder_num_heads=2,
            decoder_num_heads=2, encoder_mlp_ratio=1.0,
            decoder_mlp_ratio=1.0, encoder_stochastic_depth_prob=0.0,
            decoder_stochastic_depth_prob=0.0),
        decoder=m.decoder.replace(channel_dim=64))
    return jcfg.ExperimentConfig(
        model=m, data=jcfg.DataConfig(crop_to=SIZE,
                                      batch_size_content=BATCH),
        train=jcfg.TrainConfig(mode=mode, max_layers=1))


def key_of(path) -> list:
    """A JAX key path as a list: names as text, indices as integers."""
    out = []
    for k in path:
        if isinstance(k, jax.tree_util.SequenceKey):
            out.append(int(k.idx))
        elif isinstance(k, jax.tree_util.DictKey):
            out.append(str(k.key))
        else:
            out.append(str(k.name))
    return out


def _first(tree, prefix, want) -> tuple:
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(key_of(path))
        if key[:len(prefix)] == prefix and key[-1] == want:
            return key
    raise KeyError(prefix)


def _set(tree, key, fn):
    if len(key) == 1:
        tree[key[0]] = fn(tree[key[0]])
    else:
        _set(tree[key[0]], key[1:], fn)


def with_bf16_leaves(name: str, params: dict) -> dict:
    """``params`` with the fixture's BF16_LEAVES cast to bfloat16."""
    for key in BF16_LEAVES.get(name, ()):
        if key == "style_encoder_first_bias":
            key = _first(params, ("style_transformer", "encoder"), "bias")
        _set(params, key, lambda v: v.astype(ml_dtypes.bfloat16))
    return params


def fixture_params(name: str, cfg: jcfg.ExperimentConfig) -> dict:
    return with_bf16_leaves(name, jax.device_get(
        jmaster.init_master_model(jax.random.PRNGKey(SEED), cfg.model)))


def train_two_steps(name: str, cfg: jcfg.ExperimentConfig):
    """The JAX train state after STEPS of the JAX package's step on inputs
    from the seed, with random VGG19 weights."""
    from mastermetastyletransfer_tpu.losses import vgg as jvgg

    params = fixture_params(name, cfg)
    vgg = jax.device_get(jvgg.init_vgg19_features(
        jax.random.PRNGKey(SEED + 1)))
    tx = jstate.make_optimizer(params, cfg.train)
    state, tx = jstate.create_train_state(params, cfg.train, tx)
    step = jstep.make_train_step(cfg, vgg, tx)
    rng = np.random.default_rng(SEED)
    for i in range(STEPS):
        content, style = (jnp.asarray(rng.random((BATCH, SIZE, SIZE, 3),
                                                 dtype=np.float32))
                          for _ in range(2))
        state, _ = step(state, content, style, jax.random.PRNGKey(i))
    return jax.device_get(state)


def save(path: str, state, ocdbt: bool, cfg) -> None:
    if ocdbt:
        jckpt.save_checkpoint(path, state, int(state.step),
                              config_json=cfg.to_json())
        return
    import orbax.checkpoint as ocp

    os.makedirs(path, exist_ok=True)
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(
        os.path.join(os.path.abspath(path), str(int(state.step))),
        {"state": state}, force=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(cfg.to_json())


def leaf_digests(tree) -> list:
    """Each array leaf of ``{"state": tree}``: key, dtype, shape, sha256."""
    rows = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            {"state": tree})[0]:
        arr = np.asarray(leaf)
        rows.append({"key": key_of(path), "dtype": str(arr.dtype),
                     "shape": list(arr.shape),
                     "sha256": hashlib.sha256(arr.tobytes()).hexdigest()})
    return rows


def restored(path: str, name: str, cfg) -> object:
    """The fixture as the JAX package's restore_checkpoint gives it, into
    ``create_train_state``'s tree of zeros of the fixture's leaves."""
    shapes = jax.eval_shape(lambda key: jmaster.init_master_model(
        key, cfg.model), jax.random.PRNGKey(SEED))
    params = with_bf16_leaves(name, jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    tx = jstate.make_optimizer(params, cfg.train)
    template, _ = jstate.create_train_state(params, cfg.train, tx)
    return jckpt.restore_checkpoint(path, template)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                  "orbax"))
    out = ap.parse_args().out
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    digests = {}
    for name, (mode, ocdbt) in FIXTURES.items():
        cfg = fixture_config(mode)
        state = train_two_steps(name, cfg)
        path = os.path.join(out, name)
        save(path, state, ocdbt, cfg)
        digests[name] = {"mode": mode, "step": int(state.step),
                         "layout": "ocdbt" if ocdbt else "per-leaf",
                         "size": SIZE, "batch": BATCH,
                         "leaves": leaf_digests(restored(path, name, cfg))}
    with open(os.path.join(out, "digests.json"), "w") as f:
        json.dump(digests, f, separators=(",", ":"))
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(out) for f in files)
    print(f"{out}: {total} bytes")


if __name__ == "__main__":
    main()
