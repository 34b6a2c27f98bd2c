"""The weight converters of the port (``utils/convert.py``,
``utils/convert_cli.py``) against the JAX package's, on synthetic state
dicts in the reference's and torchvision's key schemes (the builders of
tests/test_convert.py), on the CPU.

Every converter's tree equals JAX's bit for bit, leaf for leaf, each leaf a
float32 tensor of its own (none shares storage with another: the port's
optimizer updates leaves in place). Each command-line kind writes an .npz
with JAX's keys and arrays; where a kind starts from a random template
(``whole_model``, ``seed_from_swin``), JAX's initializer is made to return
the port's template, so that the files agree everywhere. A torchvision
swin features[:4] from tests/torch_swin_ref.py, converted by the port,
gives the port's Swin forward within 1e-5 of the oracle's.
"""

import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.utils import convert as jconvert
from mastermetastyletransfer_tpu.utils import convert_cli as jcli
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    init_style_transformer,
)
from mastermetastyletransfer_tpu_torch.models.swin import swin_backbone_apply
from mastermetastyletransfer_tpu_torch.utils import convert as tconvert
from mastermetastyletransfer_tpu_torch.utils import convert_cli as tcli
from mastermetastyletransfer_tpu_torch.utils.checkpoint import flatten_params
from tests.test_convert import (
    _r, make_style_transformer_sd, make_swin_backbone_sd, make_swin_block_sd,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

DEC_IDX = (0, 3, 5, 7, 9, 12, 14, 17, 19)


def _same(got: dict, want: dict) -> None:
    """The port's tree equals JAX's bit for bit; each leaf float32, its
    own storage."""
    g, w = flatten_params(got), flatten_params(want)
    assert set(g) == set(w)
    ptrs = set()
    for key, t in g.items():
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32, key
        assert np.array_equal(t.numpy(), np.asarray(w[key])), key
        ptrs.add(t.untyped_storage().data_ptr())
    assert len(ptrs) == len(g)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _decoder_sd(rng, c=16):
    chans = [(c, c // 2), (c // 2, c // 2), (c // 2, c // 2), (c // 2, c // 2),
             (c // 2, c // 4), (c // 4, c // 4), (c // 4, c // 8),
             (c // 8, c // 8), (c // 8, 3)]
    sd = {}
    for i, (ci, co) in zip(DEC_IDX, chans):
        sd[f"decoder.{i}.weight"] = _r(rng, co, ci, 3, 3)
        sd[f"decoder.{i}.bias"] = _r(rng, co)
    return sd


def _style_sd(rng, variant: str):
    """The reference's style transformer state dict with the keys each
    variant reads besides the default form's."""
    sd = make_style_transformer_sd(rng)
    dim = 256
    pre = "decoder.decoder_MHA_for_sigma_and_mu"
    extra = {
        "dual_wq": [f"{pre}.Wq"],
        "regular": ["decoder.linear_transformation_Key",
                    "decoder.linear_transformation_Scale",
                    "decoder.linear_transformation_Shift",
                    "decoder.proj_sigma", "decoder.proj_mu"],
    }.get(variant, [])
    for name in extra:
        sd[f"{name}.weight"] = _r(rng, dim, dim)
        sd[f"{name}.bias"] = _r(rng, dim)
    if variant == "norms":
        for name in ("encoder.shared_MHA_without_MLP.norm1",
                     "decoder.instance_norm_Query",
                     "decoder.instance_norm_Key"):
            sd[f"{name}.weight"] = _r(rng, dim)
            sd[f"{name}.bias"] = _r(rng, dim)
    if variant == "regular":
        for key in [k for k in sd if k.startswith(pre)]:
            del sd[key]
    return sd


STYLE_VARIANTS = {
    "default": {},
    "dual_wq": {},
    "regular": {"decoder_use_regular_MHA_instead_of_Swin_at_the_end": True},
    "exclude_mlp": {"decoder_exclude_MLP_after_Fcs_self_MHA": True},
    "no_decoder_norm": {"decoder_use_norm": False},
    "norms": {"encoder_use_norm": True,
              "decoder_use_instance_norm_with_affine": True},
}


@pytest.mark.parametrize("variant", ["swin_T", "swin_B"])
def test_convert_swin_backbone_matches_jax(rng, variant):
    jc = jcfg.SwinConfig.for_variant(variant)
    sd = make_swin_backbone_sd(rng, jc)
    _same(tconvert.convert_swin_backbone(
        sd, tcfg.SwinConfig.for_variant(variant)),
        jconvert.convert_swin_backbone(sd, jc))


@pytest.mark.parametrize("variant", sorted(STYLE_VARIANTS))
def test_convert_style_transformer_matches_jax(rng, variant):
    fields = STYLE_VARIANTS[variant]
    sd = _style_sd(rng, variant)
    got = tconvert.convert_style_transformer(
        sd, tcfg.StyleTransformerConfig(**fields))
    _same(got, jconvert.convert_style_transformer(
        sd, jcfg.StyleTransformerConfig(**fields)))
    dec = got["decoder"]
    assert ("dual_mha" in dec) == (variant != "regular")
    assert ("wq" in dec.get("dual_mha", {})) == (variant == "dual_wq")
    assert ("mlp" in dec["self_mha"]) == (variant != "exclude_mlp")


def test_convert_cnn_decoder_matches_jax(rng):
    sd = _decoder_sd(rng)
    _same(tconvert.convert_cnn_decoder(sd), jconvert.convert_cnn_decoder(sd))
    del sd["decoder.19.weight"]
    with pytest.raises(ValueError, match="expected 9 convs"):
        tconvert.convert_cnn_decoder(sd)
    with pytest.raises(AssertionError, match="expected 9 convs"):
        jconvert.convert_cnn_decoder(sd)


@pytest.mark.parametrize("case", ["default", "dual_wq", "other_table",
                                  "norms"])
def test_seed_from_swin_block_matches_jax(rng, case):
    """The seeding on a template, the port's draw shared with JAX: JAX's
    result bit for bit; the template left as it was; a bias table replaced
    only where its shape is the block's."""
    fields = STYLE_VARIANTS["norms"] if case == "norms" else {}
    cfg = tcfg.StyleTransformerConfig(**fields)
    template = init_style_transformer(torch.Generator().manual_seed(3), cfg)
    if case == "dual_wq":
        d = template["decoder"]["dual_mha"]
        d["wq"] = {k: v.clone() + 1 for k, v in d["wk"].items()}
    block = make_swin_block_sd(rng, 256)
    if case == "other_table":
        block["1.relative_position_bias_table"] = _r(rng, 169, 4)
    before = {k: v.clone() for k, v in flatten_params(template).items()}
    got = tconvert.seed_style_transformer_from_swin_block(block, template,
                                                          cfg)
    want = jconvert.seed_style_transformer_from_swin_block(
        block, _numpy(template), jcfg.StyleTransformerConfig(**fields))
    _same(got, want)
    assert all(torch.equal(v, before[k])
               for k, v in flatten_params(template).items())
    table = torch.from_numpy(block["1.relative_position_bias_table"])
    for path in (("encoder", "shared_mha", "attn"),
                 ("decoder", "self_mha", "attn"), ("decoder", "dual_mha")):
        node = got
        for p in path:
            node = node[p]
        assert torch.equal(node["rel_bias_table"], table) == (
            case != "other_table"), path


def test_seed_needs_dim_256():
    cfg = tcfg.StyleTransformerConfig(encoder_dim=64, decoder_dim=64,
                                      encoder_num_heads=4,
                                      decoder_num_heads=4)
    template = init_style_transformer(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="dim 256"):
        tconvert.seed_style_transformer_from_swin_block(
            make_swin_block_sd(np.random.default_rng(0), 256), template, cfg)


def _whole_sd(rng, cfg: jcfg.ModelConfig, groups=("swin_encoder",
                                                 "style_transformer",
                                                 "decoder")):
    parts = {"swin_encoder": make_swin_backbone_sd(rng, cfg.swin),
             "style_transformer": make_style_transformer_sd(rng),
             "decoder": _decoder_sd(rng)}
    return {f"{g}.{k}": v for g in groups for k, v in parts[g].items()}


def test_split_whole_model_state_dict_matches_jax(rng):
    cfg = jcfg.ModelConfig()
    whole = _whole_sd(rng, cfg)
    got = tconvert.split_whole_model_state_dict(whole)
    want = jconvert.split_whole_model_state_dict(whole)
    assert len(got) == 3 and all(set(g) == set(w) for g, w in zip(got,
                                                                   want))
    part = _whole_sd(rng, cfg, groups=("style_transformer",))
    s, t, d = tconvert.split_whole_model_state_dict(part)
    assert s is None and d is None and set(t) == set(
        make_style_transformer_sd(rng))
    for bad in ({"bogus.key": _r(rng, 2)},
                {**whole, "swin.0.0.weight": _r(rng, 2)}):
        with pytest.raises(ValueError, match="unrecognized"):
            tconvert.split_whole_model_state_dict(bad)


@pytest.mark.parametrize("groups", [
    ("swin_encoder", "style_transformer", "decoder"),
    ("style_transformer",)])
def test_convert_whole_model_matches_jax(rng, groups):
    """The converted components JAX's; an absent one the template's, as it
    was."""
    cfg = tcfg.ModelConfig()
    template = init_master_model(cfg, torch.Generator().manual_seed(4),
                                 device="cpu")
    whole = _whole_sd(rng, jcfg.ModelConfig(), groups)
    got = tconvert.convert_whole_model(whole, template, cfg)
    want = jconvert.convert_whole_model(whole, _numpy(template),
                                        jcfg.ModelConfig())
    assert set(got) == set(want) == {"swin", "style_transformer", "decoder"}
    for name in got:
        if name == "decoder" or name == "swin":
            prefix = "swin_encoder" if name == "swin" else "decoder"
            if prefix not in groups:
                assert got[name] is template[name]
                continue
        _same(got[name], want[name])


def _tv_block_layouts(rng):
    """One stage-2 block of a torchvision swin in its three layouts."""
    full = make_swin_backbone_sd(rng, jcfg.SwinConfig.for_variant("swin_B"))
    return {"cut": full,
            "features": {f"features.{k}": v for k, v in full.items()},
            "block": make_swin_block_sd(rng, 256)}


@pytest.mark.parametrize("layout", ["cut", "features", "block"])
def test_extract_swin_block_matches_jax(rng, layout):
    sd = _tv_block_layouts(rng)[layout]
    got, want = tcli._extract_swin_block(sd), jcli._extract_swin_block(sd)
    assert got.keys() == want.keys()
    assert all(got[k] is want[k] for k in got)
    assert any(k.startswith("1.qkv.") for k in got)
    if layout != "block":
        assert got["1.qkv.weight"] is sd[
            ("features." if layout == "features" else "") +
            "3.1.attn.qkv.weight"]


def test_extract_swin_block_without_one_raises(rng):
    with pytest.raises(ValueError, match="3.1"):
        tcli._extract_swin_block({"0.0.weight": _r(rng, 2)})


def _state_dict_for(kind, rng):
    if kind in ("swin", "seed_from_swin"):
        return make_swin_backbone_sd(rng,
                                     jcfg.SwinConfig.for_variant("swin_B"))
    if kind == "vgg19":
        from tests.test_torch_trainer import _vgg_state_dict
        return _vgg_state_dict(True, "features.")
    if kind == "style_transformer":
        return make_style_transformer_sd(rng)
    if kind == "decoder":
        return _decoder_sd(rng)
    return _whole_sd(rng, jcfg.ModelConfig())


@pytest.mark.parametrize("kind", ["swin", "vgg19", "style_transformer",
                                  "decoder", "seed_from_swin",
                                  "whole_model"])
def test_convert_cli_kind_matches_jax(tmp_path, rng, monkeypatch, kind):
    """Each kind's .npz: JAX's keys and arrays (JAX's initializers return
    the port's template, the draw of ``convert_cli.TEMPLATE_SEED``)."""
    from mastermetastyletransfer_tpu import models as jmodels
    from mastermetastyletransfer_tpu.models import style_transformer as jst

    def gen():
        return torch.Generator().manual_seed(tcli.TEMPLATE_SEED)

    monkeypatch.setattr(jmodels, "init_master_model", lambda key, cfg: _numpy(
        init_master_model(tcfg.ModelConfig(), gen(), device="cpu")))
    monkeypatch.setattr(jst, "init_style_transformer", lambda key, cfg: _numpy(
        init_style_transformer(gen(), tcfg.StyleTransformerConfig())))
    sd = _state_dict_for(kind, rng)
    pt = str(tmp_path / "in.pt")
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
               pt)
    extra = ["--batchnorm"] if kind == "vgg19" else []
    outs = {}
    for side, main in (("port", tcli.main), ("jax", jcli.main)):
        outs[side] = str(tmp_path / f"{side}.npz")
        main([kind, "--input", pt, "--output", outs[side], *extra])
    with np.load(outs["port"]) as got, np.load(outs["jax"]) as want:
        assert sorted(got.files) == sorted(want.files)
        assert len(got.files) > 10
        for key in want.files:
            assert got[key].dtype == np.float32
            assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("kernels", [False, True])
def test_torchvision_swin_converted_matches_oracle(kernels):
    """torchvision's swin features[:4] (the oracle of tests/torch_swin_ref.py,
    fused qkv, its own key scheme) converted by the port: the port's Swin
    forward (kernels on: their plain versions) within 1e-5 of the
    oracle's, max abs."""
    from tests.torch_swin_ref import build_tv_swin_features

    tv = build_tv_swin_features(embed_dim=32, num_heads=(2, 4),
                                window_size=(7, 7), seed=7).eval()
    sd = {k: v.detach().numpy() for k, v in tv.state_dict().items()}
    cfg = tcfg.SwinConfig(variant="swin_custom", embed_dim=32,
                          num_heads=(2, 4), use_pallas=kernels,
                          stochastic_depth_probs=(0.0, 0.0, 0.0, 0.0))
    img = torch.from_numpy(np.random.default_rng(50).random(
        (2, 3, 64, 64), dtype=np.float32))
    with torch.no_grad():
        want = tv(img)
        got = swin_backbone_apply(tconvert.convert_swin_backbone(sd, cfg),
                                  img.permute(0, 2, 3, 1), cfg)
    assert got.shape == want.shape == (2, 8, 8, 64)
    assert (got - want).abs().max().item() <= 1e-5
