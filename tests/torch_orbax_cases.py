"""Shared by tests/test_torch_orbax_{state,meta,modes,unfrozen}.py, one
training mode each: its train state carried through the JAX package's
Orbax checkpoints and the port's, on the CPU at a narrow float32 model.
Each of those modules imports the three tests at the end of this one and
gives them its ``run`` fixture.

``run_mode(mode, root)`` (mode "plain", "meta", "fast_adaptation", or
"unfrozen": plain with ``freeze_encoder=False``):

* JAX takes two steps from its weights, writes the state with its own
  ``save_checkpoint`` (Orbax's default OCDBT layout) and with
  ``PyTreeCheckpointHandler(use_ocdbt=False)`` (a zarr directory per
  leaf), and reads each back with its ``restore_checkpoint``;
* the port restores each into a fresh state of its own (``restore``);
* from the restored states, one more step on each side (``after``), and
  the port's step again on scaled content for each leaf's spread;
* the port takes two steps of its own from JAX's weights and writes them
  with its ``save_checkpoint``, which JAX's ``restore_checkpoint`` reads
  into ``create_train_state``'s template (``port_written``).

The leaves are ``{key tuple: numpy array}`` of ``{"state": TrainState}``,
keys as the port's ``train.state.to_pytree`` names them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.train import state as jstate
from mastermetastyletransfer_tpu.train import step as jstep
from mastermetastyletransfer_tpu.utils import checkpoint as jckpt
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.train import state as tstate
from mastermetastyletransfer_tpu_torch.train import step as tstep
from mastermetastyletransfer_tpu_torch.utils import checkpoint as tckpt
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    params_from_jax,
)
from tests.torch_jax_init import jax_weights

SIZE, BATCH, INNER = 32, 2, 2
# The standing bounds of the port's step against JAX's
# (tests/test_torch_train.py): the loss within 1e-5 relative; a leaf
# within 1e-4 relative max-abs, or within SPREAD_FACTOR times its own
# spread, whichever is larger: how far the port's own leaf moves when the
# content images are scaled by (1 + eps), eps in SPREAD_EPS.
TOL_LOSS, TOL_LEAF = 1e-5, 1e-4
SPREAD_FACTOR, SPREAD_EPS = 4, (2.0 ** -20, 2.0 ** -17)
MOMENT = ("state", "opt_state", "inner_states", "train", "inner_state", 0)
# the step, Adam's count and the schedule's
COUNTS = (("state", "step"), MOMENT + ("count",), MOMENT[:-1] + (1, "count"))


def model_config() -> jcfg.ModelConfig:
    """swin_custom at 16 channels (one block a stage), the style
    transformer and the CNN decoder at 32, stochastic depth off."""
    m = jcfg.ModelConfig()
    return m.replace(
        swin=jcfg.SwinConfig(variant="swin_custom", embed_dim=16,
                             depths=(1, 1), num_heads=(1, 2),
                             stochastic_depth_probs=(0.0, 0.0)),
        transformer=m.transformer.replace(
            encoder_dim=32, decoder_dim=32, encoder_num_heads=2,
            decoder_num_heads=2, encoder_stochastic_depth_prob=0.0,
            decoder_stochastic_depth_prob=0.0),
        decoder=m.decoder.replace(channel_dim=32))


def jax_config(mode: str) -> jcfg.ExperimentConfig:
    """k fixed at 1 (max_layers 1), so that a step draws nothing."""
    train = (dict(mode="plain", freeze_encoder=False) if mode == "unfrozen"
             else dict(mode=mode))
    return jcfg.ExperimentConfig(
        model=model_config(),
        data=jcfg.DataConfig(crop_to=SIZE, batch_size_content=BATCH),
        train=jcfg.TrainConfig(max_layers=1, num_inner_updates=INNER,
                               **train))


def port_config(cfg: jcfg.ExperimentConfig) -> tcfg.ExperimentConfig:
    ct = tcfg.ExperimentConfig.from_json(cfg.to_json())
    return ct.replace(model=ct.model.with_kernels())


def key_of(path) -> tuple:
    out = []
    for k in path:
        if isinstance(k, jax.tree_util.SequenceKey):
            out.append(int(k.idx))
        elif isinstance(k, jax.tree_util.DictKey):
            out.append(str(k.key))
        else:
            out.append(str(k.name))
    return tuple(out)


def jax_leaves(state) -> dict:
    return {key_of(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path({"state": state})[0]}


def port_leaves(state) -> dict:
    out = {}
    for k, v in tstate.to_pytree(state):
        if v is None:
            continue
        # a copy: the port's steps update the state's tensors in place
        v = v.detach().cpu().clone()
        out[k] = (v.view(torch.int16).numpy().view(jnp.bfloat16)
                  if v.dtype == torch.bfloat16 else v.numpy())
    return out


def _inputs(rng, meta: bool):
    lead = (INNER,) if meta else ()
    content = rng.random(lead + (BATCH, SIZE, SIZE, 3), dtype=np.float32)
    style = rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    return content, style


def _jax_state(cfg, pj):
    tx = jstate.make_optimizer(pj, cfg.train)
    state, tx = jstate.create_train_state(pj, cfg.train, tx)
    return state, tx


def run_mode(mode: str, root: str) -> dict:
    cfg = jax_config(mode)
    meta = cfg.train.mode == "meta"
    pj, vj = jax_weights(cfg.model)
    state, tx = _jax_state(cfg, pj)
    make = jstep.make_meta_train_step if meta else jstep.make_train_step
    jstep_fn = make(cfg, vj, tx)
    rng = np.random.default_rng(7)
    for i in range(2):
        state, _ = jstep_fn(state, *map(jnp.asarray, _inputs(rng, meta)),
                            jax.random.PRNGKey(i))
    state = jax.device_get(state)
    step = int(state.step)

    import orbax.checkpoint as ocp

    dirs = {"ocdbt": os.path.join(root, "ocdbt"),
            "per_leaf": os.path.join(root, "per_leaf")}
    jckpt.save_checkpoint(dirs["ocdbt"], state, step,
                          config_json=cfg.to_json())
    os.makedirs(dirs["per_leaf"])
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(
        os.path.join(dirs["per_leaf"], str(step)), {"state": state})

    ct = port_config(cfg)
    vgg = params_from_jax(vj)
    make_t = tstep.make_meta_train_step if meta else tstep.make_train_step
    tstep_fn = make_t(ct, vgg, device="cpu")

    def port_state(seed: int):
        return tstate.create_train_state(init_master_model(
            ct.model, torch.Generator().manual_seed(seed), device="cpu"),
            ct.train)

    def port_step(st, content, style):
        if meta:
            return tstep_fn(st, content, style, torch.Generator(),
                            ks=[1] * INNER)
        return tstep_fn(st, content, style, torch.Generator(), k=1)

    out = dict(cfg=cfg, ct=ct, dirs=dirs, step=step, jax={}, restore={},
               after={})
    content, style = _inputs(rng, meta)
    for layout, d in dirs.items():
        template, _ = _jax_state(cfg, pj)
        restored = jckpt.restore_checkpoint(d, template)
        out["jax"][layout] = jax_leaves(restored)
        st = tckpt.restore_checkpoint(d, port_state(3))
        out["restore"][layout] = port_leaves(st)
        if layout == "ocdbt":
            jafter, jm = jstep_fn(restored, jnp.asarray(content),
                                  jnp.asarray(style), jax.random.PRNGKey(9))
            st, tm = port_step(st, content, style)
            port = port_leaves(st)
            spread = {k: 0.0 for k in port}
            for eps in SPREAD_EPS:
                moved, _ = port_step(tckpt.restore_checkpoint(
                    d, port_state(3)), content * (1 + eps), style)
                for k, v in port_leaves(moved).items():
                    spread[k] = max(spread[k], float(np.abs(
                        v.astype(np.float64) - port[k]).max(initial=0)))
            out["after"] = dict(
                jax=jax_leaves(jax.device_get(jafter)), port=port,
                spread=spread, jax_loss=float(jm["total"]),
                port_loss=float(tm["total"]))

    # the port's own run from JAX's weights, written by the port
    st = tstate.create_train_state(params_from_jax(pj), ct.train)
    for _ in range(2):
        st, _ = port_step(st, *_inputs(rng, meta))
    written = os.path.join(root, "port")
    tckpt.save_checkpoint(written, st, st.step, config_json=ct.to_json())
    template, _ = _jax_state(cfg, pj)
    out["port_written"] = dict(
        port=port_leaves(st),
        jax=jax_leaves(jckpt.restore_checkpoint(written, template)),
        path=written)
    return out


def assert_same_leaves(got: dict, want: dict) -> None:
    """Every key of both, each leaf of the same dtype, shape and bytes."""
    assert set(got) == set(want), sorted(map(str, set(got) ^ set(want)))[:4]
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def assert_step_within_bounds(after: dict) -> None:
    """The step from the restored state: the loss, and every leaf (its
    parameters, Adam's moments; the counts and the step exactly)."""
    w = after["jax_loss"]
    assert abs(after["port_loss"] - w) <= TOL_LOSS * abs(w)
    assert set(after["port"]) == set(after["jax"])
    for k, want in after["jax"].items():
        got = after["port"][k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if want.dtype.kind != "f":
            assert np.array_equal(got, want), k
            continue
        # The keys' biases have an exactly zero gradient (a softmax does
        # not see a shift of every key): their moments are rounding noise
        # on both sides, held to the scale of their projection's kernel.
        moment = k[:7] in (MOMENT + ("mu",), MOMENT + ("nu",))
        scale = (after["jax"][k[:-1] + ("kernel",)]
                 if moment and k[-2:] == ("wk", "bias") else want)
        want = want.astype(np.float64)
        err = float(np.abs(got - want).max(initial=0))
        bound = max(TOL_LEAF * float(np.abs(scale).max(initial=0)),
                    SPREAD_FACTOR * after["spread"][k])
        assert err <= bound, (k, err, bound)


# ---------------------------------------------------------------------------
# the tests of one mode, on its module's ``run`` fixture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["ocdbt", "per_leaf"])
def test_port_restores_jax_checkpoint_bit_for_bit(run, layout):
    """Every leaf, both counts and the step, as JAX restores them."""
    got = run["restore"][layout]
    assert_same_leaves(got, run["jax"][layout])
    assert int(got[COUNTS[0]]) == run["step"] == 2
    assert int(got[COUNTS[1]]) == int(got[COUNTS[2]]) == 2 * (
        INNER if run["cfg"].train.mode == "meta" else 1)


def test_jax_restores_port_checkpoint_bit_for_bit(run):
    got = run["port_written"]
    assert_same_leaves(got["jax"], got["port"])
    assert int(got["jax"][COUNTS[1]]) == int(got["jax"][COUNTS[2]])


def test_one_step_from_the_restored_state_matches_jax(run):
    assert_step_within_bounds(run["after"])
