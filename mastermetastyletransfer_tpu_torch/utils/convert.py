"""Weight converters: PyTorch state dicts (the reference's and
torchvision's layouts) -> the port's parameter trees (JAX counterpart:
utils/convert.py).

Covers the reference's whole weight-acquisition surface:
  * torchvision swin_{t,s,b} features[:4] (the pickled Sequential the
    reference torch.loads, codes/full_model.py:69), the fused qkv split
    into separate Q/K/V;
  * torch vgg19 / vgg19_bn features for the loss (codes/utils.py:10-56),
    batch norm folded into the conv before it (exact in eval mode);
  * the reference StyleTransformer and Decoder state dicts
    (direct_pretrained_* paths, codes/full_model.py:147-155), and a whole
    model's (``split_whole_model_state_dict``);
  * the surgery that seeds the style transformer from one original-Swin
    block (codes/load_pretrained_weights_to_style_transformer.py).

Inputs are plain dicts name -> numpy array (``load_torch_state_dict``
reads a .pt/.pth file on the CPU). The converters return float32 tensors
in the JAX package's layouts, on ``device`` (the CPU by default), every
leaf a tensor of its own (none shares storage with another leaf or with
the input):

  torch Linear weight (out, in)       -> kernel (in, out)     [transpose]
  torch Conv2d weight (out, in, kh, kw) -> kernel (kh, kw, in, out)
  fused qkv weight (3C, C)            -> thirds, each transposed
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Union

import numpy as np
import torch

from mastermetastyletransfer_tpu_torch.config import (
    ModelConfig, StyleTransformerConfig, SwinConfig,
)
from mastermetastyletransfer_tpu_torch.losses.vgg import VGG19_LAYER_PLAN
from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map

Device = Union[str, torch.device]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's state dict as numpy arrays, read on the CPU;
    weights only where the file allows it (a pickled module otherwise, as
    the JAX package reads it: load only files you trust)."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


def _tensors(tree, device: Device):
    """A tree of numpy arrays -> float32 tensors on ``device``, each a copy
    of its own."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def _lin(sd, prefix, use_bias=True):
    p = {"kernel": sd[f"{prefix}.weight"].T}
    if use_bias and f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _norm(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _mlp(sd, prefix):
    """torchvision's MLP is Sequential[Linear, act, Dropout, Linear,
    Dropout]: keys .0 and .3 (the reference's key scheme, e.g.
    load_pretrained_weights_to_style_transformer.py:250-253)."""
    return {"fc1": _lin(sd, f"{prefix}.0"), "fc2": _lin(sd, f"{prefix}.3")}


def _split_qkv(sd, prefix):
    """A fused qkv Linear as separate wq/wk/wv (the surgery of reference
    codes/load_pretrained_weights_to_style_transformer.py:52-60)."""
    w = sd[f"{prefix}.weight"]          # (3C, C)
    c = w.shape[0] // 3
    out = {}
    for i, name in enumerate(("wq", "wk", "wv")):
        out[name] = {"kernel": w[i * c:(i + 1) * c].T}
        if f"{prefix}.bias" in sd:
            out[name]["bias"] = sd[f"{prefix}.bias"][i * c:(i + 1) * c]
    return out


def _attn_separate(sd, prefix):
    """The reference's ShiftedWindowAttention (separate Wq/Wk/Wv)."""
    return {
        "wq": _lin(sd, f"{prefix}.Wq"),
        "wk": _lin(sd, f"{prefix}.Wk"),
        "wv": _lin(sd, f"{prefix}.Wv"),
        "proj": _lin(sd, f"{prefix}.proj"),
        "rel_bias_table": sd[f"{prefix}.relative_position_bias_table"],
    }


# ---------------------------------------------------------------------------
# Swin backbone (torchvision features[:4] Sequential key scheme)
# ---------------------------------------------------------------------------

def convert_swin_backbone(sd: Dict[str, np.ndarray], cfg: SwinConfig,
                          device: Device = "cpu") -> dict:
    """torchvision swin features[:4] state dict -> the Swin backbone's tree.

    Key scheme: "0.0" the patch conv, "0.2" the patch norm, "1.{b}.*" the
    stage-1 blocks, "2.*" PatchMerging, "3.{b}.*" the stage-2 blocks.
    """
    params = {
        "patch_embed": {
            "conv": {"kernel": sd["0.0.weight"].transpose(2, 3, 1, 0),
                     "bias": sd["0.0.bias"]},
            "norm": _norm(sd, "0.2"),
        },
        "patch_merge": {
            "norm": _norm(sd, "2.norm"),
            "reduction": {"kernel": sd["2.reduction.weight"].T},
        },
    }
    for stage, seq in ((0, "1"), (1, "3")):
        for blk in range(cfg.depths[stage]):
            pre = f"{seq}.{blk}"
            attn = _split_qkv(sd, f"{pre}.attn.qkv")
            attn["proj"] = _lin(sd, f"{pre}.attn.proj")
            attn["rel_bias_table"] = sd[
                f"{pre}.attn.relative_position_bias_table"]
            params[f"stage{stage}_block{blk}"] = {
                "attn": attn,
                "norm1": _norm(sd, f"{pre}.norm1"),
                "norm2": _norm(sd, f"{pre}.norm2"),
                "mlp": {"fc1": _lin(sd, f"{pre}.mlp.0"),
                        "fc2": _lin(sd, f"{pre}.mlp.3")},
            }
    return _tensors(params, device)


# ---------------------------------------------------------------------------
# VGG19 loss backbone
# ---------------------------------------------------------------------------

_VGG19_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28]
_VGG19_BN_CONV_IDX = [0, 3, 7, 10, 14, 17, 20, 23, 27, 30, 33, 36, 40]


def convert_vgg19(sd: Dict[str, np.ndarray], use_batchnorm: bool = False,
                  eps: float = 1e-5,
                  device: Device = "cpu") -> dict:
    """torch vgg19(_bn).features state dict -> the VGG19 loss tree
    ({"conv0": {"kernel", "bias"}, ...}, float32 on ``device``). Keys may
    carry a "features." prefix (a whole model's dict) or be bare indices
    (the cut Sequential). Batch norm (eval mode) folds into the conv before
    it, in float64, as in the JAX package."""
    if any(k.startswith("features.") for k in sd):
        sd = {k[len("features."):]: v for k, v in sd.items()
              if k.startswith("features.")}
    idxs = _VGG19_BN_CONV_IDX if use_batchnorm else _VGG19_CONV_IDX
    n_convs = sum(1 for sl in VGG19_LAYER_PLAN for kind, _, _ in sl
                  if kind == "C")
    params = {}
    for i in range(n_convs):
        ci = idxs[i]
        w = sd[f"{ci}.weight"].astype(np.float64)
        b = sd[f"{ci}.bias"].astype(np.float64)
        if use_batchnorm:
            gamma = sd[f"{ci + 1}.weight"].astype(np.float64)
            beta = sd[f"{ci + 1}.bias"].astype(np.float64)
            mean = sd[f"{ci + 1}.running_mean"].astype(np.float64)
            var = sd[f"{ci + 1}.running_var"].astype(np.float64)
            scale = gamma / np.sqrt(var + eps)
            w = w * scale[:, None, None, None]
            b = (b - mean) * scale + beta
        params[f"conv{i}"] = {
            "kernel": torch.from_numpy(np.ascontiguousarray(
                w.transpose(2, 3, 1, 0), dtype=np.float32)).to(device),
            "bias": torch.from_numpy(b.astype(np.float32)).to(device)}
    return params


# ---------------------------------------------------------------------------
# StyleTransformer / CNN decoder (reference state dict key schemes)
# ---------------------------------------------------------------------------

def convert_style_transformer(sd: Dict[str, np.ndarray],
                              cfg: StyleTransformerConfig,
                              device: Device = "cpu") -> dict:
    """Reference StyleTransformer.state_dict() -> the style transformer's
    tree (key scheme of
    codes/load_pretrained_weights_to_style_transformer.py:183-400): the
    dual-MHA decoder tail (its Wq optional) or the regular-MHA one, the
    norms and the self block's MLP as the configuration has them."""
    enc = {
        "shared_mha": {"attn": _attn_separate(
            sd, "encoder.shared_MHA_without_MLP.attn")},
        "mlp_key": _mlp(sd, "encoder.encoder_MLP_Key"),
        "mlp_scale": _mlp(sd, "encoder.encoder_MLP_Scale"),
        "mlp_shift": _mlp(sd, "encoder.encoder_MLP_Shift"),
    }
    if cfg.encoder_use_norm:
        enc["shared_mha"]["norm1"] = _norm(
            sd, "encoder.shared_MHA_without_MLP.norm1")

    self_mha = {"attn": _attn_separate(sd, "decoder.MHA_self_attn.attn")}
    if cfg.decoder_use_norm:
        self_mha["norm1"] = _norm(sd, "decoder.MHA_self_attn.norm1")
        if not cfg.decoder_exclude_MLP_after_Fcs_self_MHA:
            self_mha["norm2"] = _norm(sd, "decoder.MHA_self_attn.norm2")
    if not cfg.decoder_exclude_MLP_after_Fcs_self_MHA:
        self_mha["mlp"] = _mlp(sd, "decoder.MHA_self_attn.mlp")

    dec = {"self_mha": self_mha, "last_mlp": _mlp(sd, "decoder.last_MLP")}

    if cfg.decoder_use_instance_norm_with_affine:
        dec["in_q"] = _norm(sd, "decoder.instance_norm_Query")
        dec["in_k"] = _norm(sd, "decoder.instance_norm_Key")

    if not cfg.decoder_use_regular_MHA_instead_of_Swin_at_the_end:
        pre = "decoder.decoder_MHA_for_sigma_and_mu"
        dual = {
            "wk": _lin(sd, f"{pre}.Wk"),
            "wv_scale": _lin(sd, f"{pre}.Wv_scale"),
            "wv_shift": _lin(sd, f"{pre}.Wv_shift"),
            "proj": _lin(sd, f"{pre}.proj"),
            "rel_bias_table": sd[f"{pre}.relative_position_bias_table"],
        }
        if f"{pre}.Wq.weight" in sd:
            dual["wq"] = _lin(sd, f"{pre}.Wq")
        dec["dual_mha"] = dual
    else:
        dec["lin_key"] = _lin(sd, "decoder.linear_transformation_Key")
        dec["lin_scale"] = _lin(sd, "decoder.linear_transformation_Scale")
        dec["lin_shift"] = _lin(sd, "decoder.linear_transformation_Shift")
        dec["proj_sigma"] = _lin(sd, "decoder.proj_sigma")
        dec["proj_mu"] = _lin(sd, "decoder.proj_mu")

    return _tensors({"encoder": enc, "decoder": dec}, device)


def convert_cnn_decoder(sd: Dict[str, np.ndarray],
                        device: Device = "cpu") -> dict:
    """Reference Decoder.state_dict() (Sequential "decoder.{i}", convs at
    0, 3, 5, 7, 9, 12, 14, 17, 19; codes/decoder.py:23-55) -> the CNN
    decoder's tree. Raises ValueError unless it finds nine convs."""
    conv_idxs = [i for i in range(20) if f"decoder.{i}.weight" in sd]
    if len(conv_idxs) != 9:
        raise ValueError(f"expected 9 convs, found {conv_idxs}")
    return _tensors({f"conv{n}": {
        "kernel": sd[f"decoder.{i}.weight"].transpose(2, 3, 1, 0),
        "bias": sd[f"decoder.{i}.bias"]}
        for n, i in enumerate(conv_idxs)}, device)


# ---------------------------------------------------------------------------
# Pretrained-weight surgery: seed the style transformer from one original
# Swin block (reference: codes/load_pretrained_weights_to_style_transformer.py)
# ---------------------------------------------------------------------------

def seed_style_transformer_from_swin_block(
        block_sd: Dict[str, np.ndarray], params: dict,
        cfg: StyleTransformerConfig, device: Device = "cpu") -> dict:
    """Inject one Swin block's state dict (keys "0.*" norm1, "1.*" attn,
    "3.*" norm2, "4.*" mlp; the ModuleList -> 2nd BasicLayer -> 2nd block
    cut) into every attention module and MLP of the style transformer, the
    fused qkv split. The mapping of
    codes/load_pretrained_weights_to_style_transformer.py:65-683:
      - encoder shared attn + decoder self attn: Wq/Wk/Wv <- qkv thirds;
      - decoder dual attn: Wk <- k, Wv_scale <- v, Wv_shift <- v (and Wq
        <- q where it has one);
      - all five MLPs <- the block's MLP (fc1/fc2);
      - norms (where present) <- the block's norm1/norm2;
      - relative-position bias tables <- the block's where the shapes
        match.
    Returns a new tree on ``device``; ``params`` is left as it is. Raises
    ValueError unless both widths are 256 (the reference's assert,
    :85-86)."""
    if cfg.encoder_dim != 256 or cfg.decoder_dim != 256:
        raise ValueError("pretrained Swin-block seeding requires dim 256 "
                         "(reference assert :85-86)")
    p = tree_map(lambda t: t.detach().to(device, torch.float32, copy=True),
                 params)

    qkv = _split_qkv(block_sd, "1.qkv")
    proj = _lin(block_sd, "1.proj")
    table = block_sd["1.relative_position_bias_table"]
    mlp = {"fc1": _lin(block_sd, "4.fc1"), "fc2": _lin(block_sd, "4.fc2")}

    def new(tree):
        return _tensors(tree, device)

    def fill_attn(attn):
        for name in ("wq", "wk", "wv"):
            attn[name] = new(qkv[name])
        attn["proj"] = new(proj)
        if tuple(attn["rel_bias_table"].shape) == table.shape:
            attn["rel_bias_table"] = new(table)

    enc, dec = p["encoder"], p["decoder"]
    fill_attn(enc["shared_mha"]["attn"])
    if "norm1" in enc["shared_mha"]:
        enc["shared_mha"]["norm1"] = new(_norm(block_sd, "0"))
    for name in ("mlp_key", "mlp_scale", "mlp_shift"):
        enc[name] = new(mlp)

    fill_attn(dec["self_mha"]["attn"])
    if "norm1" in dec["self_mha"]:
        dec["self_mha"]["norm1"] = new(_norm(block_sd, "0"))
    if "norm2" in dec["self_mha"]:
        dec["self_mha"]["norm2"] = new(_norm(block_sd, "3"))
    if "mlp" in dec["self_mha"]:
        dec["self_mha"]["mlp"] = new(mlp)

    if "dual_mha" in dec:
        dual = dec["dual_mha"]
        dual["wk"] = new(qkv["wk"])
        dual["wv_scale"] = new(qkv["wv"])
        dual["wv_shift"] = new(qkv["wv"])
        dual["proj"] = new(proj)
        if tuple(dual["rel_bias_table"].shape) == table.shape:
            dual["rel_bias_table"] = new(table)
        if "wq" in dual:
            dual["wq"] = new(qkv["wq"])
    dec["last_mlp"] = new(mlp)
    return p


def split_whole_model_state_dict(sd: Dict[str, np.ndarray]):
    """Split a whole model's state dict -- the layout ``save_whole_model``
    writes (reference train_only_inner_loop.py:382-385), which the missing
    pretrained_model_lambda_is_{2,4}.pt checkpoints use -- into the three
    component dicts the converters take. Prefixes follow
    codes/full_model.py's attribute names: ``swin_encoder.*`` (torchvision
    cut-Sequential keys), ``style_transformer.*`` and ``decoder.*`` (the CNN
    decoder, whose own Sequential is also named ``decoder``).

    Returns (swin_sd, style_transformer_sd, decoder_sd), None for a group
    absent from the input; raises ValueError on any other key."""
    groups: Dict[str, Dict[str, np.ndarray]] = {
        "swin_encoder": {}, "style_transformer": {}, "decoder": {}}
    unknown = []
    for k, v in sd.items():
        for prefix, g in groups.items():
            if k.startswith(prefix + "."):
                g[k[len(prefix) + 1:]] = v
                break
        else:
            unknown.append(k)
    if unknown:
        raise ValueError(
            "not a whole-model state dict; unrecognized keys (expected "
            f"swin_encoder./style_transformer./decoder. prefixes): "
            f"{unknown[:5]}")
    return tuple(g or None for g in
                 (groups["swin_encoder"], groups["style_transformer"],
                  groups["decoder"]))


def convert_whole_model(sd: Dict[str, np.ndarray], params: dict,
                        cfg: ModelConfig, device: Device = "cpu") -> dict:
    """A whole model's state dict (``save_whole_model``'s layout) -> the
    model's tree, ``params`` standing in for any absent component."""
    swin_sd, st_sd, dec_sd = split_whole_model_state_dict(sd)
    return convert_master_model(st_sd, dec_sd, swin_sd, params, cfg,
                                device=device)


def convert_master_model(style_transformer_sd: Optional[Dict[str, np.ndarray]],
                         decoder_sd: Optional[Dict[str, np.ndarray]],
                         swin_sd: Optional[Dict[str, np.ndarray]],
                         params: dict, cfg: ModelConfig,
                         device: Device = "cpu") -> dict:
    """The model's tree from any subset of reference checkpoints, the
    components of ``params`` (e.g. random weights) for the others, as they
    are (the direct_pretrained_* loading of codes/full_model.py:144-155)."""
    out = dict(params)
    if swin_sd is not None:
        out["swin"] = convert_swin_backbone(swin_sd, cfg.swin, device)
    if style_transformer_sd is not None:
        out["style_transformer"] = convert_style_transformer(
            style_transformer_sd, cfg.transformer, device)
    if decoder_sd is not None:
        out["decoder"] = convert_cnn_decoder(decoder_sd, device)
    return out
