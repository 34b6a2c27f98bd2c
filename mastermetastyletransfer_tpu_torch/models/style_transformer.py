"""The style transformer: shared-weight shifted-window cross-attention
encoder + decoder producing per-pixel scale/shift modulation (JAX
counterpart: models/style_transformer.py; reference:
codes/style_transformer.py:303-398 StyleSwinTransformerBlock, :777-912
StyleEncoder, :918-1128 StyleDecoder, :1133-1245 StyleTransformer).

In evaluation with ``use_pallas`` the stage takes the JAX package's
window-resident path (``style_transformer_apply_windowed``): Fc and Fs are
partitioned into rolled, padded windows once, all k iterations run in the
(B, nW, N, C) layout through the evaluation kernels -- the block kernel K2
for the encoder Key block and the decoder self block (ops/window_block.py),
K3 for the encoder's Scale/Shift update and K4 for the decoder tail
(ops/style_block.py) -- and the result is merged once. Its split route
(``fuse_iteration=False``) runs the Scale/Shift update and the tail as K9
and K10 instead (ops/window_attention.py, ops/ln_mlp.py), and a decoder
without its self-block MLP (``decoder_exclude_MLP_after_Fcs_self_MHA``)
runs its self attention as K8, in either route.

Otherwise (training, or a configuration the windowed gate refuses) the
generic path runs every attention through its own pad/roll/partition round
trip, at the k it is given (a Python loop; the JAX package's masked scan
over a traced k is a TPU-compiler workaround). With ``use_pallas`` its
attentions run K8 and K9 (ops/window_attention.py) and its MLP residuals
K10 (ops/ln_mlp.py), all differentiable; without it, plain PyTorch.
Training (``deterministic=False``) draws the stochastic-depth and dropout
masks from ``generator`` in the same order on both routes, as the JAX
package keeps its rng streams aligned, so the two can be compared at one
seed.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from mastermetastyletransfer_tpu_torch.config import (
    AttentionConfig, StyleTransformerConfig, check_matmul_mode,
)
from mastermetastyletransfer_tpu_torch.ops import style_block, window_block
from mastermetastyletransfer_tpu_torch.ops.attention import (
    _finalize, _pallas_dim_ok, _prepare, _shift_mask, _valid_mask,
    block_kernel_supports, fused_self_attention_block,
    init_dual_value_window_attention, init_window_attention,
    shifted_window_attention, shifted_window_attention_dual_value,
    shifted_window_attention_two_v,
)
from mastermetastyletransfer_tpu_torch.ops.ln_mlp import ln_mlp_residual
from mastermetastyletransfer_tpu_torch.ops.mlp import (
    init_linear, init_mlp, linear, mlp_apply, sd_lerp, stochastic_depth,
)
from mastermetastyletransfer_tpu_torch.ops.norm import (
    instance_norm, layer_norm,
)
from mastermetastyletransfer_tpu_torch.ops.window_attention import (
    Proj, window_attention, window_attention_dual, window_attention_plain,
)
from mastermetastyletransfer_tpu_torch.ops.windows import (
    relative_position_bias,
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


def _fuse_mlp_ok(attn_cfg: AttentionConfig, deterministic: bool) -> bool:
    """K10 serves evaluation and training where the MLP dropout is off;
    stochastic depth is applied around it (``sd_lerp``)."""
    return attn_cfg.use_pallas and (deterministic or attn_cfg.dropout == 0.0)


def style_swin_block_apply(params: dict, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, attn_cfg: AttentionConfig, *,
                           use_norm: bool, exclude_mlp: bool,
                           sd_prob: float = 0.0,
                           calculating_key: bool = False,
                           deterministic: bool = True,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """Generalized Swin block. The residual comes from q for the Key and
    MLP-bearing blocks, from v for Scale/Shift (reference:
    codes/style_transformer.py:382-386). In evaluation a full
    self-attention block with ``use_pallas`` runs through the block kernel,
    norm1 included; otherwise the attention takes K8 and the MLP residual
    K10 under ``use_pallas`` (JAX models/style_transformer.py:86-152)."""
    if (deterministic and attn_cfg.use_pallas and not exclude_mlp
            and q is k and k is v
            and block_kernel_supports(attn_cfg.dim, attn_cfg.num_heads,
                                      attn_cfg.window_size)):
        return fused_self_attention_block(params, q, attn_cfg,
                                          use_norm=use_norm)
    x = q if (calculating_key or not exclude_mlp) else v
    rand = dict(deterministic=deterministic, generator=generator)
    n1 = params.get("norm1") if use_norm else None
    if n1 is not None:
        def norm(t):
            return layer_norm(t, n1["scale"], n1["bias"])
        q, k, v = norm(q), norm(k), norm(v)
    a = shifted_window_attention(params["attn"], q, k, v, attn_cfg, **rand)
    x = x + stochastic_depth(a, sd_prob, **rand)
    if exclude_mlp:
        return x
    n2 = params["norm2"] if use_norm else None
    if _fuse_mlp_ok(attn_cfg, deterministic):
        return sd_lerp(x, ln_mlp_residual(x, params["mlp"], n2), sd_prob,
                       **rand)
    h = layer_norm(x, n2["scale"], n2["bias"]) if n2 is not None else x
    m = mlp_apply(params["mlp"], h, dropout_p=attn_cfg.dropout, **rand)
    return x + stochastic_depth(m, sd_prob, **rand)


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
                        Shift: torch.Tensor, cfg: StyleTransformerConfig, *,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shared MHA applied three times (Key self-attention; Scale and
    Shift cross-attention with the Key as Q and K), each followed by its own
    MLP and stochastic-depth residual (reference:
    codes/style_transformer.py:855-912). With ``use_pallas`` the Scale and
    Shift attentions share one softmax through K9 and the MLP residuals run
    K10, where no dropout is on (JAX models/style_transformer.py:176-252)."""
    acfg = cfg.encoder_attn()
    sd = cfg.encoder_stochastic_depth_prob
    rand = dict(deterministic=deterministic, generator=generator)

    def block(q, k, v, calc_key):
        return style_swin_block_apply(
            params["shared_mha"], q, k, v, acfg,
            use_norm=cfg.encoder_use_norm, exclude_mlp=True, sd_prob=sd,
            calculating_key=calc_key, **rand)

    def mlp_res(x, mlp_params):
        if _fuse_mlp_ok(acfg, deterministic):
            return sd_lerp(x, ln_mlp_residual(x, mlp_params), sd, **rand)
        m = mlp_apply(mlp_params, x, dropout_p=cfg.encoder_dropout, **rand)
        return x + stochastic_depth(m, sd, **rand)

    def scale_shift(Key, Scale, Shift):
        # One softmax for both streams (the reference computes it twice),
        # where the kernels have no dropout to skip; the masks are drawn in
        # the order of the two block() calls.
        if (_fuse_mlp_ok(acfg, deterministic) and _pallas_dim_ok(acfg.dim)
                and (deterministic or acfg.attention_dropout == 0.0)):
            qk, v1, v2 = Key, Scale, Shift
            if cfg.encoder_use_norm:
                n1 = params["shared_mha"]["norm1"]
                qk, v1, v2 = (layer_norm(t, n1["scale"], n1["bias"])
                              for t in (Key, Scale, Shift))
            a1, a2 = shifted_window_attention_two_v(
                params["shared_mha"]["attn"], qk, qk, v1, v2, acfg)
            return (Scale + stochastic_depth(a1, sd, **rand),
                    Shift + stochastic_depth(a2, sd, **rand))
        return block(Key, Key, Scale, False), block(Key, Key, Shift, False)

    if cfg.encoder_if_use_processed_Key_in_Scale_and_Shift_calculation:
        Key = mlp_res(block(Key, Key, Key, True), params["mlp_key"])
        Scale, Shift = scale_shift(Key, Scale, Shift)
        Scale = mlp_res(Scale, params["mlp_scale"])
        Shift = mlp_res(Shift, params["mlp_shift"])
    else:
        Scale, Shift = scale_shift(Key, Scale, Shift)
        Scale = mlp_res(Scale, params["mlp_scale"])
        Shift = mlp_res(Shift, params["mlp_shift"])
        Key = mlp_res(block(Key, Key, Key, True), params["mlp_key"])
    return Key, Scale, Shift


def style_decoder_apply(params: dict, Fcs: torch.Tensor, Key: torch.Tensor,
                        Scale: torch.Tensor, Shift: torch.Tensor,
                        cfg: StyleTransformerConfig, *,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Fcs self-attention -> IN(Q)/IN(K) -> dual-value MHA -> Fcs' =
    Query * sigma + mu -> last MLP residual (reference:
    codes/style_transformer.py:1045-1128)."""
    acfg = cfg.decoder_attn()
    sd = cfg.decoder_stochastic_depth_prob
    rand = dict(deterministic=deterministic, generator=generator)
    Query = style_swin_block_apply(
        params["self_mha"], Fcs, Fcs, Fcs, acfg, use_norm=cfg.decoder_use_norm,
        exclude_mlp=cfg.decoder_exclude_MLP_after_Fcs_self_MHA, sd_prob=sd,
        calculating_key=True, **rand)
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
            instance_norm_params=in_params, **rand)
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
    if _fuse_mlp_ok(acfg, deterministic):
        return sd_lerp(Query, ln_mlp_residual(Query, params["last_mlp"]), sd,
                       **rand)
    m = mlp_apply(params["last_mlp"], Query, dropout_p=cfg.decoder_dropout,
                  **rand)
    return Query + stochastic_depth(m, sd, **rand)


# ---------------------------------------------------------------------------
# The window-resident evaluation path
# ---------------------------------------------------------------------------

def _st_windowed_ok(cfg: StyleTransformerConfig,
                    deterministic: bool = True) -> bool:
    """The window-resident path (evaluation kernels) needs evaluation, the
    kernels on, the JAX package's 128-aligned width, no dropout, one window
    geometry for encoder and decoder (so one partition serves every
    attention) and the windowed decoder tail (JAX
    models/style_transformer.py:371-385)."""
    return (deterministic and cfg.use_pallas
            and _pallas_dim_ok(cfg.encoder_dim)
            and cfg.encoder_dropout == 0.0 and cfg.decoder_dropout == 0.0
            and cfg.encoder_attention_dropout == 0.0
            and cfg.decoder_attention_dropout == 0.0
            and cfg.encoder_dim == cfg.decoder_dim
            and cfg.encoder_window_size == cfg.decoder_window_size
            and cfg.encoder_shift_size == cfg.decoder_shift_size
            and not cfg.decoder_use_regular_MHA_instead_of_Swin_at_the_end)


def _masked_instance_norm(x4: torch.Tensor, vm: Optional[torch.Tensor],
                          count: float, eps: float = 1e-5,
                          scale: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          reduce: Optional[Callable] = None) -> torch.Tensor:
    """InstanceNorm over the valid tokens of a window tensor (B, nW, N, C):
    the image-layout statistics of the un-padded image (the reference
    normalizes before padding). One-pass biased variance E[x^2] - mean^2,
    f32 statistics, eps 1e-5, as the JAX package. vm (1, nW, N, 1) marks
    the valid tokens (None: all); ``reduce`` sums the two per-instance sums
    over the parts of the image held elsewhere (the band path's bands)."""
    xf = x4.float()
    xm = xf if vm is None else xf * vm
    sums = torch.stack([xm.sum((1, 2), keepdim=True),
                        (xm * xm).sum((1, 2), keepdim=True)])
    if reduce is not None:
        sums = reduce(sums)
    mean = sums[0] / count
    var = sums[1] / count - mean * mean
    y = (xf - mean) * (var + eps) ** -0.5
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x4.dtype)


def _to4(x: torch.Tensor, b: int) -> torch.Tensor:
    bn, n, c = x.shape
    return x.reshape(b, bn // b, n, c)


def _finalize_windowed(x4: torch.Tensor, geom: dict,
                       window: Tuple[int, int]) -> torch.Tensor:
    return _finalize(x4.reshape(-1, x4.shape[2], x4.shape[3]), geom, window)


class WindowedStyleStream:
    """The k (Key, Scale, Shift) encoder triples of one style in the window
    layout (B, nW, N, C), with the feature-map (h, w) they were partitioned
    at: window shapes alone cannot tell a 56x28 grid from a 28x56 one, or
    26x26 from 28x28 (same padded grid, other valid tokens), so the consumer
    checks (h, w)."""

    def __init__(self, triples, hw):
        self.triples = list(triples)
        self.hw = tuple(hw)

    def __iter__(self):
        return iter(self.triples)

    def __len__(self):
        return len(self.triples)

    def __getitem__(self, i):
        return self.triples[i]


def _bcast_stream_batch(t: torch.Tensor, bc: int) -> torch.Tensor:
    """One batch-1 style stream serves a whole content batch (style-locked
    serving); equal batches pass through. The copy is contiguous, as the
    kernels take it."""
    if t.shape[0] == bc:
        return t
    if t.shape[0] == 1:
        return t.expand(bc, *t.shape[1:]).contiguous()
    raise ValueError(f"stream batch {t.shape[0]} vs content batch {bc}")


class WindowGrid(NamedTuple):
    """The window grid the window-resident machinery runs on: the shift
    mask (nW, N, N) or None, the validity mask (nW, N) of the grid's tokens
    or None where none is padding, and the image's count of valid tokens.
    Two hooks serve the band path (parallel/spatial_shmap.py), whose grid
    is one band of the image's: ``reduce`` sums the instance norms'
    statistics over the bands, and ``key_in`` gives the post-linear Key IN
    the validity mask (nW, N) and token count of the reference's padded
    grid. On one device both are None: no sum, and that IN over the whole
    grid held."""
    mask: Optional[torch.Tensor]
    padmask: Optional[torch.Tensor]
    count: float
    reduce: Optional[Callable] = None
    key_in: Optional[Tuple[torch.Tensor, float]] = None


def _grid(geom: dict, cfg: StyleTransformerConfig,
          device: torch.device) -> WindowGrid:
    """The WindowGrid of a whole image partitioned by ``_prepare``."""
    wh, ww = cfg.encoder_attn().window_size
    h, w = geom["h"], geom["w"]
    ph, pw, sh, sw = geom["pad_h"], geom["pad_w"], geom["sh"], geom["sw"]
    return WindowGrid(
        mask=_shift_mask(ph, pw, wh, ww, sh, sw, device) if sh or sw
        else None,
        padmask=_valid_mask(h, w, ph, pw, wh, ww, sh, sw, device),
        count=float(h * w))


def _plain_window_attention(params: dict, q, k, v, bias, mask, heads):
    """K8's plain version on the parameters ``window_attention`` takes."""
    projs = (Proj(params[p]["kernel"], params[p].get("bias"))
             for p in ("wq", "wk", "wv", "proj"))
    return window_attention_plain(q, k, v, *projs, bias, mask, heads)


def _windowed_machinery(params: dict, cfg: StyleTransformerConfig,
                        grid: WindowGrid, dtype: torch.dtype,
                        fuse_iteration: Optional[bool] = None,
                        kernels: bool = True):
    """The window-resident (encoder, decoder) closures for one grid.
    encoder: (Key, Scale, Shift) -> the updated triple; decoder: (Fcs, Key,
    Scale, Shift) -> Fcs'; all (B, nW, N, C). Shared by the interleaved path,
    the style-stream API (the encoder triple evolves from the style alone)
    and the band path, which runs it on its band of the grid.

    ``fuse_iteration`` picks the route of the Scale/Shift update and the
    decoder tail: fused, K3 and K4; split, K9 and K10 as the JAX package's
    ``:592-604`` and ``:673-683``. None fuses at both dtypes. The JAX
    package fuses only at 2-byte dtypes because at f32 its fused kernels
    overflow the TPU's 16 MB of scoped VMEM; the card has no such limit,
    so its default waits for the two routes' measured times.
    ``kernels=False`` runs the fused route's K2-K4, and K8 for the
    exclude-MLP self block, as their plain versions: the band path's route
    where the JAX package's band gate takes no kernel (it never asks for
    the split route)."""
    if fuse_iteration is None:
        fuse_iteration = True
    window = cfg.encoder_attn().window_size
    wh, ww = window
    heads_e, heads_d = cfg.encoder_num_heads, cfg.decoder_num_heads
    mask, padmask = grid.mask, grid.padmask
    vm = None if padmask is None else padmask[None, :, :, None]

    def entry(module, name):
        """A kernel entry, or with the kernels off its plain version (looked
        up at the call)."""
        return getattr(module, name if kernels else name + "_plain")

    def zp(x4):
        """Re-zero the pad tokens (the identity when the window divides the
        grid)."""
        return x4 if vm is None else x4 * vm.to(x4.dtype)

    def kernel_args(heads):
        return dict(heads=heads, mask=mask, padmask=padmask)

    def rel_bias(attn):
        """K8's and K9's bias (heads, N, N); they take only the shift mask,
        the pad tokens reaching them re-zeroed by zp, as in JAX."""
        return relative_position_bias(attn["rel_bias_table"], wh,
                                      ww).float().contiguous()

    enc, dec = params["encoder"], params["decoder"]
    e_attn = enc["shared_mha"]["attn"]
    n1p = enc["shared_mha"].get("norm1") if cfg.encoder_use_norm else None
    # The Key block is the block kernel's chain with the norm-free MLP_Key
    # and no LN2 (reference: codes/style_transformer.py:859-865).
    key_w = window_block.block_weights(
        {"attn": e_attn, "mlp": enc["mlp_key"], "norm1": n1p}, window, dtype,
        n1p is not None, norm2=False)

    def key_block(Key):
        return entry(window_block, "window_block_windows")(
            Key, key_w, **kernel_args(heads_e))

    if fuse_iteration:
        ss_w = style_block.encoder_weights(e_attn, enc["mlp_scale"],
                                           enc["mlp_shift"], n1p, window,
                                           dtype)

        def scale_shift(Key, Scale, Shift):
            return entry(style_block, "encoder_scale_shift")(
                Key, Scale, Shift, ss_w, **kernel_args(heads_e))
    else:
        bias_e = rel_bias(e_attn)
        shared = {"wv_scale": e_attn["wv"], "wv_shift": e_attn["wv"],
                  "proj": e_attn["proj"]}

        def ln_e(t):
            return t if n1p is None else layer_norm(t, n1p["scale"],
                                                    n1p["bias"])

        def scale_shift(Key, Scale, Shift):
            qk = zp(ln_e(Key))
            a1, a2 = window_attention_dual(
                shared, linear(e_attn["wq"], qk), linear(e_attn["wk"], qk),
                zp(ln_e(Scale)), zp(ln_e(Shift)), bias_e, mask, heads_e)
            return (ln_mlp_residual(Scale + a1, enc["mlp_scale"]),
                    ln_mlp_residual(Shift + a2, enc["mlp_shift"]))

    def encoder(Key, Scale, Shift):
        if cfg.encoder_if_use_processed_Key_in_Scale_and_Shift_calculation:
            Key = key_block(Key)
            Scale, Shift = scale_shift(Key, Scale, Shift)
        else:
            Scale, Shift = scale_shift(Key, Scale, Shift)
            Key = key_block(Key)
        return Key, Scale, Shift

    d_self, d_dual = dec["self_mha"], dec["dual_mha"]
    if cfg.decoder_exclude_MLP_after_Fcs_self_MHA:
        # The self attention and its residual alone (JAX :628-637).
        bias_self = rel_bias(d_self["attn"])
        dn1 = d_self.get("norm1") if cfg.decoder_use_norm else None
        attention = window_attention if kernels else _plain_window_attention

        def self_block(Fcs):
            x = zp(Fcs if dn1 is None
                   else layer_norm(Fcs, dn1["scale"], dn1["bias"]))
            return Fcs + attention(d_self["attn"], x, x, x, bias_self, mask,
                                   heads_d)
    else:
        self_w = window_block.block_weights(d_self, window, dtype,
                                            cfg.decoder_use_norm)

        def self_block(Fcs):
            return entry(window_block, "window_block_windows")(
                Fcs, self_w, **kernel_args(heads_d))

    if fuse_iteration:
        tail_w = style_block.decoder_tail_weights(d_dual, dec["last_mlp"],
                                                  window, dtype)

        def tail(q, kk, Scale, Shift, Query):
            return entry(style_block, "decoder_tail")(
                q, kk, Scale, Shift, Query, tail_w, **kernel_args(heads_d))
    else:
        bias_dual = rel_bias(d_dual)

        def tail(q, kk, Scale, Shift, Query):
            sigma, mu = window_attention_dual(d_dual, q, kk, zp(Scale),
                                              zp(Shift), bias_dual, mask,
                                              heads_d)
            return ln_mlp_residual(Query * sigma + mu, dec["last_mlp"])
    affine = cfg.decoder_use_instance_norm_with_affine

    def affine_of(which):
        aff = dec.get(which) if affine else None
        return {} if aff is None else {"scale": aff["scale"],
                                       "bias": aff["bias"]}

    def in_masked(x4, which):
        return _masked_instance_norm(x4, vm, grid.count, reduce=grid.reduce,
                                     **affine_of(which))

    def decoder(Fcs, Key, Scale, Shift):
        Query = self_block(Fcs)
        # The entry INs see the un-padded image: masked statistics
        # (reference: codes/style_transformer.py:1053-1057).
        query_in = in_masked(Query, "in_q")
        key_in = in_masked(Key, "in_k")
        # The in-attention Q IN (reference :468), applied again, masked.
        q = zp(in_masked(query_in, "in_q"))
        if cfg.decoder_use_Key_instance_norm_after_linear_transformation:
            # Post-linear IN over the padded grid, where the pad tokens
            # hold the wk bias (reference :520-530). A band's grid holds
            # all-pad window rows past the reference's: its statistics
            # take the reference grid's tokens (grid.key_in).
            kk = linear(d_dual["wk"], zp(key_in))
            if grid.key_in is None:
                kk = instance_norm(kk.reshape(kk.shape[0], -1, kk.shape[-1]),
                                   **affine_of("in_k")).reshape(kk.shape)
            else:
                ref_mask, ref_count = grid.key_in
                kk = _masked_instance_norm(
                    kk, ref_mask[None, :, :, None], ref_count,
                    reduce=grid.reduce, **affine_of("in_k"))
        else:
            kk = linear(d_dual["wk"], zp(in_masked(key_in, "in_k")))
        return tail(q, kk, Scale, Shift, Query)

    return encoder, decoder


def _partition(x: torch.Tensor, cfg: StyleTransformerConfig):
    acfg = cfg.encoder_attn()
    (xw,), geom = _prepare([x], acfg.window_size, acfg.shift_size)
    return _to4(xw, geom["b"]), geom


def style_transformer_apply_windowed(params: dict, Fc: torch.Tensor,
                                     Fs: torch.Tensor,
                                     cfg: StyleTransformerConfig, *, k: int,
                                     fuse_iteration: Optional[bool] = None
                                     ) -> torch.Tensor:
    """Partition Fc and Fs into (rolled, padded) windows once, run all k
    iterations of encoder and decoder in the (B, nW, N, C) layout, merge
    once. Every attention of the style transformer shares one geometry, and
    every op between them is token-local or permutation-invariant, so the
    generic path's per-attention round trips are pure overhead.

    Parity: pad tokens are re-zeroed before each attention (the reference
    pads fresh zeros each time, and pad tokens take part as keys in border
    windows); the decoder's entry INs take masked statistics, the
    post-linear Key IN full padded-grid ones; residuals come from q for the
    Key and self blocks and from v for Scale/Shift (reference:
    codes/style_transformer.py:382-386)."""
    acfg = cfg.encoder_attn()
    (fc_w, fs_w), geom = _prepare([Fc, Fs], acfg.window_size,
                                  acfg.shift_size)
    fc_w, fs_w = _to4(fc_w, geom["b"]), _to4(fs_w, geom["b"])
    encoder, decoder = _windowed_machinery(
        params, cfg, _grid(geom, cfg, fc_w.device), fc_w.dtype,
        fuse_iteration)
    Key = Scale = Shift = fs_w
    Fcs = fc_w
    for _ in range(int(k)):
        Key, Scale, Shift = encoder(Key, Scale, Shift)
        Fcs = decoder(Fcs, Key, Scale, Shift)
    return _finalize_windowed(Fcs, geom, acfg.window_size)


def style_stream_windowed(params: dict, Fs: torch.Tensor,
                          cfg: StyleTransformerConfig, *, k: int,
                          fuse_iteration: Optional[bool] = None
                          ) -> WindowedStyleStream:
    """The k encoder triples of one style, in the window layout. They evolve
    from Fs alone (reference: codes/style_transformer.py:1229-1245), so a
    fixed style's stream serves any number of contents of its size."""
    fs_w, geom = _partition(Fs, cfg)
    encoder, _ = _windowed_machinery(
        params, cfg, _grid(geom, cfg, fs_w.device), fs_w.dtype,
        fuse_iteration)
    Key = Scale = Shift = fs_w
    stream = []
    for _ in range(int(k)):
        Key, Scale, Shift = encoder(Key, Scale, Shift)
        stream.append((Key, Scale, Shift))
    return WindowedStyleStream(stream, (geom["h"], geom["w"]))


def style_apply_windowed_from_stream(params: dict, Fc: torch.Tensor, stream,
                                     cfg: StyleTransformerConfig, *,
                                     fuse_iteration: Optional[bool] = None
                                     ) -> torch.Tensor:
    """The decoder half of the windowed path against a precomputed style
    stream. Fc must have the feature size the stream was built at."""
    fc_w, geom = _partition(Fc, cfg)
    if isinstance(stream, WindowedStyleStream):
        if stream.hw != (geom["h"], geom["w"]):
            raise ValueError(
                f"style stream was built at feature size {stream.hw}; "
                f"content features are {(geom['h'], geom['w'])}: stream "
                f"and content must share (H, W)")
    elif len(stream) and stream[0][0].shape[1:] != fc_w.shape[1:]:
        raise ValueError(
            f"style stream geometry {tuple(stream[0][0].shape[1:])} does not "
            f"match content windows {tuple(fc_w.shape[1:])}")
    _, decoder = _windowed_machinery(
        params, cfg, _grid(geom, cfg, fc_w.device), fc_w.dtype,
        fuse_iteration)
    bc = fc_w.shape[0]
    Fcs = fc_w
    for Key, Scale, Shift in stream:
        Fcs = decoder(Fcs, _bcast_stream_batch(Key, bc),
                      _bcast_stream_batch(Scale, bc),
                      _bcast_stream_batch(Shift, bc))
    return _finalize_windowed(Fcs, geom, cfg.encoder_attn().window_size)


def style_transformer_apply(params: dict, Fc: torch.Tensor, Fs: torch.Tensor,
                            cfg: StyleTransformerConfig, *, k: int = 1,
                            deterministic: bool = True,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """k stacked iterations of (encoder, decoder) with shared params
    (reference: codes/style_transformer.py:1229-1245). Training passes
    ``deterministic=False`` and the generator of its random masks. A Python
    loop over k serves both of the JAX package's ``traced_k_impl`` forms
    (graph shapes of one function there)."""
    check_matmul_mode(cfg, "style transformer")
    if _st_windowed_ok(cfg, deterministic):
        return style_transformer_apply_windowed(params, Fc, Fs, cfg, k=int(k))
    rand = dict(deterministic=deterministic, generator=generator)
    Scale = Shift = Fs
    for _ in range(int(k)):
        Fs, Scale, Shift = style_encoder_apply(params["encoder"], Fs, Scale,
                                               Shift, cfg, **rand)
        Fc = style_decoder_apply(params["decoder"], Fc, Fs, Scale, Shift, cfg,
                                 **rand)
    return Fc


def style_transformer_stream(params: dict, Fs: torch.Tensor,
                             cfg: StyleTransformerConfig, *, k: int):
    """The content-independent half of the style transformer: the k encoder
    triples evolved from Fs. Pair it with
    ``style_transformer_apply_from_stream`` under the same cfg (the stream
    is windowed exactly when the windowed path is taken)."""
    check_matmul_mode(cfg, "style transformer")
    if _st_windowed_ok(cfg):
        return style_stream_windowed(params, Fs, cfg, k=int(k))
    Key = Scale = Shift = Fs
    stream = []
    for _ in range(int(k)):
        Key, Scale, Shift = style_encoder_apply(params["encoder"], Key,
                                                Scale, Shift, cfg)
        stream.append((Key, Scale, Shift))
    return stream


def style_transformer_apply_from_stream(params: dict, Fc: torch.Tensor,
                                        stream, cfg: StyleTransformerConfig
                                        ) -> torch.Tensor:
    """Decode Fc against a precomputed style stream. A batch-1 stream
    serves any content batch (style-locked serving)."""
    check_matmul_mode(cfg, "style transformer")
    if _st_windowed_ok(cfg):
        return style_apply_windowed_from_stream(params, Fc, stream, cfg)
    if len(stream) and stream[0][0].shape[1:3] != Fc.shape[1:3]:
        raise ValueError(
            f"style stream feature size {tuple(stream[0][0].shape[1:3])} "
            f"does not match content features {tuple(Fc.shape[1:3])}")
    bc = Fc.shape[0]
    for Key, Scale, Shift in stream:
        Fc = style_decoder_apply(
            params["decoder"], Fc, _bcast_stream_batch(Key, bc),
            _bcast_stream_batch(Scale, bc), _bcast_stream_batch(Shift, bc),
            cfg)
    return Fc
