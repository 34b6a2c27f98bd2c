"""The style transformer: shared-weight shifted-window cross-attention
encoder + decoder producing per-pixel scale/shift modulation (JAX
counterpart: models/style_transformer.py; reference:
codes/style_transformer.py:303-398 StyleSwinTransformerBlock, :777-912
StyleEncoder, :918-1128 StyleDecoder, :1133-1245 StyleTransformer).

This is the generic evaluation path at a static k. The JAX package's
window-resident path and its kernels (K3, K4) come with the next slice;
until then ``use_pallas=True`` on this stage raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mastermetastyletransfer_tpu_torch.config import (
    AttentionConfig, StyleTransformerConfig,
)
from mastermetastyletransfer_tpu_torch.ops.attention import (
    block_kernel_supports, fused_self_attention_block,
    init_dual_value_window_attention, init_window_attention,
    shifted_window_attention, shifted_window_attention_dual_value,
)
from mastermetastyletransfer_tpu_torch.ops.mlp import (
    init_linear, init_mlp, linear, mlp_apply,
)
from mastermetastyletransfer_tpu_torch.ops.norm import (
    instance_norm, layer_norm,
)


def _norm_params(d: int) -> dict:
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def init_style_swin_block(g: torch.Generator, attn_cfg: AttentionConfig, *,
                          use_norm: bool, exclude_mlp: bool,
                          mlp_ratio: float) -> dict:
    """Swin block generalized to cross attention, with optional norms and
    MLP (reference: codes/style_transformer.py:319-373)."""
    p = {"attn": init_window_attention(g, attn_cfg)}
    d = attn_cfg.dim
    if use_norm:
        p["norm1"] = _norm_params(d)
        if not exclude_mlp:
            p["norm2"] = _norm_params(d)
    if not exclude_mlp:
        p["mlp"] = init_mlp(g, d, int(d * mlp_ratio), init="xavier_uniform")
    return p


def style_swin_block_apply(params: dict, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, attn_cfg: AttentionConfig, *,
                           use_norm: bool, exclude_mlp: bool,
                           calculating_key: bool = False) -> torch.Tensor:
    """Generalized Swin block. The residual comes from q for the Key and
    MLP-bearing blocks, from v for Scale/Shift (reference:
    codes/style_transformer.py:382-386). A full self-attention block with
    ``use_pallas`` runs through the block kernel, norm1 included."""
    if (attn_cfg.use_pallas and not exclude_mlp and q is k and k is v
            and block_kernel_supports(attn_cfg.dim, attn_cfg.num_heads,
                                      attn_cfg.window_size)):
        return fused_self_attention_block(params, q, attn_cfg,
                                          use_norm=use_norm)
    x = q if (calculating_key or not exclude_mlp) else v
    if use_norm:
        n1 = params["norm1"]
        a = shifted_window_attention(
            params["attn"], layer_norm(q, n1["scale"], n1["bias"]),
            layer_norm(k, n1["scale"], n1["bias"]),
            layer_norm(v, n1["scale"], n1["bias"]), attn_cfg)
        x = x + a
        if not exclude_mlp:
            n2 = params["norm2"]
            x = x + mlp_apply(params["mlp"],
                              layer_norm(x, n2["scale"], n2["bias"]))
    else:
        x = x + shifted_window_attention(params["attn"], q, k, v, attn_cfg)
        if not exclude_mlp:
            x = x + mlp_apply(params["mlp"], x)
    return x


def init_style_transformer(g: torch.Generator,
                           cfg: StyleTransformerConfig) -> dict:
    d = cfg.encoder_dim
    hidden = int(d * cfg.encoder_mlp_ratio)
    encoder = {
        "shared_mha": init_style_swin_block(
            g, cfg.encoder_attn(), use_norm=cfg.encoder_use_norm,
            exclude_mlp=True, mlp_ratio=cfg.encoder_mlp_ratio),
        "mlp_key": init_mlp(g, d, hidden, init="xavier_uniform"),
        "mlp_scale": init_mlp(g, d, hidden, init="xavier_uniform"),
        "mlp_shift": init_mlp(g, d, hidden, init="xavier_uniform"),
    }
    d = cfg.decoder_dim
    hidden = int(d * cfg.decoder_mlp_ratio)
    regular = cfg.decoder_use_regular_MHA_instead_of_Swin_at_the_end
    decoder = {
        "self_mha": init_style_swin_block(
            g, cfg.decoder_attn(), use_norm=cfg.decoder_use_norm,
            exclude_mlp=cfg.decoder_exclude_MLP_after_Fcs_self_MHA,
            mlp_ratio=cfg.decoder_mlp_ratio),
        # xavier in the regular-MHA tail, torch default in the Swin tail
        # (reference: codes/style_transformer.py:1037-1041)
        "last_mlp": init_mlp(g, d, hidden, init=(
            "xavier_uniform" if regular else "torch_default")),
    }
    if cfg.decoder_use_instance_norm_with_affine:
        decoder["in_q"] = _norm_params(d)
        decoder["in_k"] = _norm_params(d)
    if regular:
        for name in ("lin_key", "lin_scale", "lin_shift", "proj_sigma",
                     "proj_mu"):
            decoder[name] = init_linear(g, d, d)
    else:
        decoder["dual_mha"] = init_dual_value_window_attention(
            g, cfg.decoder_attn())
    return {"encoder": encoder, "decoder": decoder}


def style_encoder_apply(params: dict, Key: torch.Tensor, Scale: torch.Tensor,
                        Shift: torch.Tensor, cfg: StyleTransformerConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shared MHA applied three times (Key self-attention; Scale and
    Shift cross-attention with the Key as Q and K), each followed by its own
    MLP residual (reference: codes/style_transformer.py:855-912)."""
    acfg = cfg.encoder_attn()

    def block(q, k, v, calc_key):
        return style_swin_block_apply(
            params["shared_mha"], q, k, v, acfg,
            use_norm=cfg.encoder_use_norm, exclude_mlp=True,
            calculating_key=calc_key)

    def mlp_res(x, mlp_params):
        return x + mlp_apply(mlp_params, x)

    if cfg.encoder_if_use_processed_Key_in_Scale_and_Shift_calculation:
        Key = mlp_res(block(Key, Key, Key, True), params["mlp_key"])
        Scale, Shift = (block(Key, Key, Scale, False),
                        block(Key, Key, Shift, False))
        Scale = mlp_res(Scale, params["mlp_scale"])
        Shift = mlp_res(Shift, params["mlp_shift"])
    else:
        Scale, Shift = (block(Key, Key, Scale, False),
                        block(Key, Key, Shift, False))
        Scale = mlp_res(Scale, params["mlp_scale"])
        Shift = mlp_res(Shift, params["mlp_shift"])
        Key = mlp_res(block(Key, Key, Key, True), params["mlp_key"])
    return Key, Scale, Shift


def style_decoder_apply(params: dict, Fcs: torch.Tensor, Key: torch.Tensor,
                        Scale: torch.Tensor, Shift: torch.Tensor,
                        cfg: StyleTransformerConfig) -> torch.Tensor:
    """Fcs self-attention -> IN(Q)/IN(K) -> dual-value MHA -> Fcs' =
    Query * sigma + mu -> last MLP residual (reference:
    codes/style_transformer.py:1045-1128)."""
    acfg = cfg.decoder_attn()
    Query = style_swin_block_apply(
        params["self_mha"], Fcs, Fcs, Fcs, acfg, use_norm=cfg.decoder_use_norm,
        exclude_mlp=cfg.decoder_exclude_MLP_after_Fcs_self_MHA,
        calculating_key=True)
    affine = cfg.decoder_use_instance_norm_with_affine

    def _in(x, which):
        if affine:
            return instance_norm(x, scale=params[which]["scale"],
                                 bias=params[which]["bias"])
        return instance_norm(x)

    if not cfg.decoder_use_regular_MHA_instead_of_Swin_at_the_end:
        # IN here AND again inside the dual attention, as the reference
        # (codes/style_transformer.py:1053-1057, then :468, :520-530).
        in_params = ({"q": params["in_q"], "k": params["in_k"]}
                     if affine else None)
        sigma, mu = shifted_window_attention_dual_value(
            params["dual_mha"], _in(Query, "in_q"), _in(Key, "in_k"),
            Scale, Shift, acfg, use_q_proj=False,
            key_instance_norm_after_linear=(
                cfg.decoder_use_Key_instance_norm_after_linear_transformation),
            instance_norm_params=in_params)
    else:
        # plain (non-windowed) MHA over flattened tokens (reference:
        # codes/style_transformer.py:1063-1119)
        b, h, w, c = Query.shape
        Q = Query.reshape(b, h * w, c)
        K = Key.reshape(b, h * w, c)
        if cfg.decoder_use_Key_instance_norm_after_linear_transformation:
            K = _in(linear(params["lin_key"], K), "in_k")
        else:
            K = linear(params["lin_key"], _in(K, "in_k"))
        Q_IN = _in(Q, "in_q") * (c ** -0.5)
        S = linear(params["lin_scale"], Scale.reshape(b, h * w, c))
        Sh = linear(params["lin_shift"], Shift.reshape(b, h * w, c))
        attn = torch.softmax(Q_IN.float() @ K.float().transpose(1, 2),
                             dim=-1).to(Q.dtype)
        sigma = linear(params["proj_sigma"], attn @ S).reshape(b, h, w, c)
        mu = linear(params["proj_mu"], attn @ Sh).reshape(b, h, w, c)
    Query = Query * sigma + mu
    return Query + mlp_apply(params["last_mlp"], Query)


def style_transformer_apply(params: dict, Fc: torch.Tensor, Fs: torch.Tensor,
                            cfg: StyleTransformerConfig, *,
                            k: int = 1) -> torch.Tensor:
    """k stacked iterations of (encoder, decoder) with shared params
    (reference: codes/style_transformer.py:1229-1245)."""
    if cfg.use_pallas:
        raise NotImplementedError(
            "the style transformer's kernels are not ported yet; run it "
            "with StyleTransformerConfig.use_pallas=False")
    Scale = Shift = Fs
    for _ in range(int(k)):
        Fs, Scale, Shift = style_encoder_apply(params["encoder"], Fs, Scale,
                                               Shift, cfg)
        Fc = style_decoder_apply(params["decoder"], Fc, Fs, Scale, Shift, cfg)
    return Fc
