"""The port's configuration against the JAX package's JSON, float32 on the
CPU: every model field of a JAX JSON is kept, split3 runs as the native
route and a matmul mode the JAX package does not have raises where its
stage is built, ``patch_embed_impl="conv"`` runs
the strided convolution (max-abs 1e-4 against JAX's, the TOL of
tests/test_torch_models.py), and both ``traced_k_impl`` values give the
port's loop over k, which matches JAX's traced-k forms of either kind."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.models import master as jmaster
from mastermetastyletransfer_tpu.models import style_transformer as jst
from mastermetastyletransfer_tpu.models import swin as jswin
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.models import decoder as tdec
from mastermetastyletransfer_tpu_torch.models import style_transformer as tst
from mastermetastyletransfer_tpu_torch.models import swin as tswin
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
MODEL_CONFIGS = ("AttentionConfig", "SwinConfig", "StyleTransformerConfig",
                 "DecoderConfig", "ModelConfig")


@pytest.fixture(scope="module")
def model():
    pj = jax.device_get(jmaster.init_master_model(jax.random.PRNGKey(0),
                                                  jcfg.ModelConfig()))
    return pj, params_from_jax(pj)


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_model_configs_carry_every_jax_field(name):
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)
                if f.default is not dataclasses.MISSING}

    jf, tf = fields(getattr(jcfg, name)), fields(getattr(tcfg, name))
    assert set(f.name for f in dataclasses.fields(getattr(jcfg, name))) == \
        set(f.name for f in dataclasses.fields(getattr(tcfg, name)))
    assert jf == tf


def test_jax_json_round_trips_through_the_port():
    cj = jcfg.ModelConfig()
    cj = cj.replace(
        swin=cj.swin.replace(matmul_mode="split3", patch_embed_impl="conv"),
        transformer=cj.transformer.replace(matmul_mode="split3",
                                           traced_k_impl="switch"),
        decoder=cj.decoder.replace(matmul_mode="split3", rgb_tail="l2k128"))
    ct = tcfg.ModelConfig.from_json(cj.to_json())
    assert ct.to_dict() == cj.to_dict()


@pytest.mark.parametrize("stage", ["swin", "transformer", "decoder"])
def test_split3_raises_where_its_stage_is_built(model, stage):
    """split3 from a JAX JSON runs where its stage is built, as the port's
    native route (equal bit for bit); a mode the JAX package does not have
    raises there."""
    _, pt = model
    cj = jcfg.ModelConfig()
    cj = cj.replace(**{stage: getattr(cj, stage).replace(
        matmul_mode="split3")})
    ct = tcfg.ModelConfig.from_json(cj.to_json())
    assert getattr(ct, stage).matmul_mode == "split3"
    x = torch.zeros((1, 32, 32, 3))
    f = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, 4, 256)).astype(np.float32))
    build = {
        "swin": lambda c: tswin.swin_backbone_apply(pt["swin"], x, c.swin),
        "transformer": lambda c: tst.style_transformer_apply(
            pt["style_transformer"], f, f, c.transformer, k=1),
        "decoder": lambda c: tdec.cnn_decoder_apply(pt["decoder"], f,
                                                    c.decoder)}

    def with_mode(mode):
        return ct.replace(**{stage: getattr(ct, stage).replace(
            matmul_mode=mode)})

    assert torch.equal(build[stage](ct), build[stage](with_mode("native")))
    with pytest.raises(ValueError, match="split6"):
        build[stage](with_mode("split6"))
    if stage == "transformer":
        stream = tst.style_transformer_stream(pt["style_transformer"], f,
                                              ct.transformer, k=1)
        assert torch.equal(
            tst.style_transformer_apply_from_stream(
                pt["style_transformer"], f, stream, ct.transformer),
            build[stage](ct))
        with pytest.raises(ValueError, match="split6"):
            tst.style_transformer_stream(pt["style_transformer"], f,
                                         with_mode("split6").transformer,
                                         k=1)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_conv_patch_embed_matches_jax(model, use_pallas):
    pj, pt = model
    cj = jcfg.SwinConfig(patch_embed_impl="conv", use_pallas=use_pallas)
    ct = tcfg.SwinConfig.from_dict(cj.to_dict())
    assert ct.patch_embed_impl == "conv"
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    ref = np.asarray(jswin.swin_backbone_apply(pj["swin"], jnp.asarray(x),
                                               cj))
    got = tswin.swin_backbone_apply(pt["swin"], torch.from_numpy(x), ct)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)
    s2d = tswin.swin_backbone_apply(pt["swin"], torch.from_numpy(x),
                                    ct.replace(patch_embed_impl="s2d"))
    np.testing.assert_allclose(got.numpy(), s2d.numpy(), rtol=0, atol=1e-5)


def test_unknown_impl_values_raise():
    with pytest.raises(ValueError, match="patch_embed_impl"):
        tcfg.SwinConfig(patch_embed_impl="pallas")
    with pytest.raises(ValueError, match="traced_k_impl"):
        tcfg.StyleTransformerConfig.from_dict({"traced_k_impl": "while"})


@pytest.mark.parametrize("impl", ["scan", "switch"])
def test_traced_k_impl_is_one_function(model, impl):
    """JAX's traced k (k = 2 of max_k = 3) in either form against the
    port's loop at k = 2 under the same JSON."""
    pj, pt = model
    cj = jcfg.StyleTransformerConfig(traced_k_impl=impl)
    ct = tcfg.StyleTransformerConfig.from_dict(cj.to_dict())
    assert ct.traced_k_impl == impl
    rng = np.random.default_rng(2)
    fc, fs = (rng.standard_normal((1, 9, 9, 256)).astype(np.float32)
              for _ in range(2))
    ref = np.asarray(jst.style_transformer_apply(
        jax.tree_util.tree_map(jnp.asarray, pj["style_transformer"]),
        jnp.asarray(fc), jnp.asarray(fs), cj, k=jnp.asarray(2), max_k=3))
    got = tst.style_transformer_apply(pt["style_transformer"],
                                      torch.from_numpy(fc),
                                      torch.from_numpy(fs), ct, k=2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)
