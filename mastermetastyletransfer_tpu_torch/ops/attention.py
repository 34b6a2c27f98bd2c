"""Shifted-window attention (JAX counterpart: ops/attention.py; reference:
codes/style_transformer.py:37-169 for W-MSA/SW-MSA with separate Q/K/V,
:414-611 for the dual-value attention).

The composed ops below are plain PyTorch. With ``use_pallas`` (and the
JAX package's gate, ``_pallas_ok``) the attentions run through the
differentiable kernels K8 and K9 (ops/window_attention.py), in evaluation
and in training; ``fused_self_attention_block`` runs a whole
self-attention block through the evaluation-only block kernel
(ops/window_block.py), ``fused_self_attention_block_pair`` a Swin stage's
two blocks through the pair kernel (ops/block_pair.py).

Parity rule: inputs are zero-padded BEFORE the projections, so pad tokens
carry the qkv bias into border windows as keys, as in the reference
(codes/style_transformer.py:77-87).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from mastermetastyletransfer_tpu_torch.config import AttentionConfig
from mastermetastyletransfer_tpu_torch.ops import block_pair, window_block
from mastermetastyletransfer_tpu_torch.ops.mlp import (
    dropout, init_linear, linear, trunc_normal,
)
from mastermetastyletransfer_tpu_torch.ops.window_attention import (
    window_attention, window_attention_dual,
)
from mastermetastyletransfer_tpu_torch.ops.norm import instance_norm
from mastermetastyletransfer_tpu_torch.ops.windows import (
    effective_shift, pad_to_windows, relative_position_bias,
    shift_attention_mask, valid_token_mask, window_merge, window_partition,
)


def init_window_attention(g: torch.Generator, cfg: AttentionConfig) -> dict:
    """Params of the separate-Q/K/V window attention (reference:
    codes/style_transformer.py:175-239)."""
    d, (wh, ww) = cfg.dim, cfg.window_size
    return {"wq": init_linear(g, d, d, cfg.qkv_bias),
            "wk": init_linear(g, d, d, cfg.qkv_bias),
            "wv": init_linear(g, d, d, cfg.qkv_bias),
            "proj": init_linear(g, d, d, cfg.proj_bias),
            "rel_bias_table": trunc_normal(
                g, ((2 * wh - 1) * (2 * ww - 1), cfg.num_heads))}


def init_dual_value_window_attention(g: torch.Generator,
                                     cfg: AttentionConfig) -> dict:
    """Params of the decoder's dual-value attention (reference:
    codes/style_transformer.py:616-688)."""
    d, (wh, ww) = cfg.dim, cfg.window_size
    return {"wk": init_linear(g, d, d, cfg.qkv_bias),
            "wv_scale": init_linear(g, d, d, cfg.qkv_bias),
            "wv_shift": init_linear(g, d, d, cfg.qkv_bias),
            "proj": init_linear(g, d, d, cfg.proj_bias),
            "rel_bias_table": trunc_normal(
                g, ((2 * wh - 1) * (2 * ww - 1), cfg.num_heads))}


def _prepare(imgs: Sequence[torch.Tensor], window: Tuple[int, int],
             shift: Tuple[int, int]):
    """Shared pad -> effective shift -> roll -> window partition."""
    b, h, w, _ = imgs[0].shape
    wh, ww = window
    padded = [pad_to_windows(x, wh, ww)[0] for x in imgs]
    pad_h, pad_w = padded[0].shape[1], padded[0].shape[2]
    sh, sw = effective_shift(pad_h, pad_w, window, shift)
    if sh or sw:
        padded = [torch.roll(x, (-sh, -sw), (1, 2)) for x in padded]
    wins = [window_partition(x, wh, ww) for x in padded]
    geom = dict(b=b, h=h, w=w, pad_h=pad_h, pad_w=pad_w, sh=sh, sw=sw)
    return wins, geom


def _finalize(x_win: torch.Tensor, geom: dict,
              window: Tuple[int, int]) -> torch.Tensor:
    """Shared window merge -> un-roll -> un-pad."""
    wh, ww = window
    x = window_merge(x_win, geom["b"], geom["pad_h"], geom["pad_w"], wh, ww)
    if geom["sh"] or geom["sw"]:
        x = torch.roll(x, (geom["sh"], geom["sw"]), (1, 2))
    return x[:, :geom["h"], :geom["w"], :]


# The cached constants are built outside inference mode: a tensor first
# built under a served call's inference_mode could not take part in a later
# training step's autograd.

@functools.lru_cache(maxsize=64)
def _shift_mask(pad_h, pad_w, wh, ww, sh, sw, device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(
            shift_attention_mask(pad_h, pad_w, wh, ww, sh, sw)).to(device)


@functools.lru_cache(maxsize=64)
def _valid_mask(vh, vw, pad_h, pad_w, wh, ww, sh, sw, device):
    m = valid_token_mask(vh, vw, pad_h, pad_w, wh, ww, sh, sw)
    if m.min() >= 1.0:
        return None
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device)


def _attention_weights(q_win, k_win, params, cfg: AttentionConfig, geom,
                       deterministic: bool = True, generator=None):
    """softmax(q k^T / sqrt(d) + rel_bias + shift_mask) in float32, then the
    attention dropout (training only)."""
    wh, ww = cfg.window_size
    n = wh * ww
    heads, d_head = cfg.num_heads, cfg.dim // cfg.num_heads
    bn = q_win.shape[0]
    q = q_win.reshape(bn, n, heads, d_head).transpose(1, 2)
    k = k_win.reshape(bn, n, heads, d_head).transpose(1, 2)
    q = q * (d_head ** -0.5)
    attn = q.float() @ k.float().transpose(-1, -2)       # (bn, heads, n, n)
    bias = relative_position_bias(params["rel_bias_table"], wh, ww)
    attn = attn + bias[None].float()
    if geom["sh"] or geom["sw"]:
        mask = _shift_mask(geom["pad_h"], geom["pad_w"], wh, ww, geom["sh"],
                           geom["sw"], attn.device)
        nw = mask.shape[0]
        attn = attn.reshape(geom["b"], nw, heads, n, n) + mask[None, :, None]
        attn = attn.reshape(bn, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    return dropout(attn, cfg.attention_dropout, deterministic=deterministic,
                   generator=generator)


def _apply_values(attn, v_win, proj_params, cfg: AttentionConfig):
    wh, ww = cfg.window_size
    n = wh * ww
    heads, d_head = cfg.num_heads, cfg.dim // cfg.num_heads
    bn = v_win.shape[0]
    v = v_win.reshape(bn, n, heads, d_head).transpose(1, 2)
    x = attn.to(v.dtype).float() @ v.float()             # (bn, heads, n, dh)
    x = x.transpose(1, 2).reshape(bn, n, cfg.dim).to(v_win.dtype)
    return linear(proj_params, x)


def _pallas_dim_ok(dim: int) -> bool:
    """The JAX package's gate for its attention kernels (128-aligned
    widths: swin_B's 128 and 256 and the style transformer's 256), kept so
    that the same calls take the kernels as there."""
    return dim % 128 == 0


def _pallas_ok(cfg: AttentionConfig, deterministic: bool) -> bool:
    """K8 and K9 have backward kernels, so they serve training too where
    no dropout is on (the kernels have none), as in the JAX package
    (ops/attention.py:160-167 there)."""
    return cfg.use_pallas and _pallas_dim_ok(cfg.dim) and (
        deterministic or (cfg.dropout == 0.0
                          and cfg.attention_dropout == 0.0))


def _kernel_geometry(params: dict, cfg: AttentionConfig, geom: dict,
                     device: torch.device):
    """The kernels' expanded bias (heads, N, N) (a differentiable gather
    from the table) and the shift mask (nW, N, N) or None."""
    wh, ww = cfg.window_size
    bias = relative_position_bias(params["rel_bias_table"], wh,
                                  ww).float().contiguous()
    mask = (_shift_mask(geom["pad_h"], geom["pad_w"], wh, ww, geom["sh"],
                        geom["sw"], device)
            if geom["sh"] or geom["sw"] else None)
    return bias, mask


def _win4(x_win: torch.Tensor, b: int) -> torch.Tensor:
    """(B*nW, N, C) -> the kernels' (B, nW, N, C), contiguous."""
    bn, n, c = x_win.shape
    return x_win.reshape(b, bn // b, n, c).contiguous()


def _finalize4(out4: torch.Tensor, geom: dict,
               window: Tuple[int, int]) -> torch.Tensor:
    return _finalize(out4.reshape(-1, out4.shape[2], out4.shape[3]), geom,
                     window)


def shifted_window_attention(params: dict, q_in: torch.Tensor,
                             k_in: torch.Tensor, v_in: torch.Tensor,
                             cfg: AttentionConfig, *,
                             deterministic: bool = True,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
    """W-MSA / SW-MSA with separate Q/K/V inputs and weights; NHWC in and
    out: pad -> roll -> partition -> project -> attention -> proj -> merge ->
    un-roll -> un-pad. Under ``_pallas_ok`` the projections and the
    attention run in K8."""
    (qw, kw, vw), geom = _prepare([q_in, k_in, v_in], cfg.window_size,
                                  cfg.shift_size)
    if _pallas_ok(cfg, deterministic):
        bias, mask = _kernel_geometry(params, cfg, geom, q_in.device)
        b = geom["b"]
        out4 = window_attention(params, _win4(qw, b), _win4(kw, b),
                                _win4(vw, b), bias, mask, cfg.num_heads)
        return _finalize4(out4, geom, cfg.window_size)
    q = linear(params["wq"], qw)
    k = linear(params["wk"], kw)
    v = linear(params["wv"], vw)
    attn = _attention_weights(q, k, params, cfg, geom, deterministic,
                              generator)
    x = _apply_values(attn, v, params["proj"], cfg)
    x = dropout(x, cfg.dropout, deterministic=deterministic,
                generator=generator)
    return _finalize(x, geom, cfg.window_size)


def shifted_window_attention_two_v(params: dict, q_in: torch.Tensor,
                                   k_in: torch.Tensor, v1_in: torch.Tensor,
                                   v2_in: torch.Tensor, cfg: AttentionConfig
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention map, two value inputs through the same Wv and proj
    (the style encoder's Scale and Shift blocks, reference:
    codes/style_transformer.py:867-882, which computes the softmax twice).
    With ``use_pallas`` (the callers gate it as the JAX package does: no
    dropout) q and k are projected outside and the rest runs in K9 with wv
    passed as both value projections."""
    (qw, kw, v1w, v2w), geom = _prepare(
        [q_in, k_in, v1_in, v2_in], cfg.window_size, cfg.shift_size)
    q = linear(params["wq"], qw)
    k = linear(params["wk"], kw)
    if cfg.use_pallas and _pallas_dim_ok(cfg.dim):
        bias, mask = _kernel_geometry(params, cfg, geom, q_in.device)
        b = geom["b"]
        shared = {"wv_scale": params["wv"], "wv_shift": params["wv"],
                  "proj": params["proj"]}
        o1, o2 = window_attention_dual(shared, _win4(q, b), _win4(k, b),
                                       _win4(v1w, b), _win4(v2w, b), bias,
                                       mask, cfg.num_heads)
        return (_finalize4(o1, geom, cfg.window_size),
                _finalize4(o2, geom, cfg.window_size))
    attn = _attention_weights(q, k, params, cfg, geom)
    outs = []
    for vw in (v1w, v2w):
        x = _apply_values(attn, linear(params["wv"], vw), params["proj"], cfg)
        outs.append(_finalize(x, geom, cfg.window_size))
    return outs[0], outs[1]


def shifted_window_attention_dual_value(
        params: dict, q_in: torch.Tensor, k_in: torch.Tensor,
        v_scale_in: torch.Tensor, v_shift_in: torch.Tensor,
        cfg: AttentionConfig, *, use_q_proj: bool = False,
        key_instance_norm_after_linear: bool = True,
        instance_norm_params: Optional[dict] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One softmax(QK^T), two value streams through a shared output
    projection -> (sigma, mu). Q is instance-normed on entry; K before its
    linear or after it, then with statistics over the whole padded, rolled
    grid (reference: codes/style_transformer.py:468-530). Under
    ``_pallas_ok`` the value projections and the attention run in K9."""
    inp = instance_norm_params or {}

    def _in(x, which):
        aff = inp.get(which)
        if aff is None:
            return instance_norm(x)
        return instance_norm(x, scale=aff["scale"], bias=aff["bias"])

    q_in = _in(q_in, "q")
    if not key_instance_norm_after_linear:
        k_in = _in(k_in, "k")
    (qw, kw, vsw, vshw), geom = _prepare(
        [q_in, k_in, v_scale_in, v_shift_in], cfg.window_size, cfg.shift_size)
    q = linear(params["wq"], qw) if use_q_proj else qw
    k = linear(params["wk"], kw)
    if key_instance_norm_after_linear:
        bn, n, c = k.shape
        k = _in(k.reshape(geom["b"], (bn // geom["b"]) * n, c),
                "k").reshape(bn, n, c)
    if _pallas_ok(cfg, deterministic):
        bias, mask = _kernel_geometry(params, cfg, geom, q_in.device)
        b = geom["b"]
        s4, m4 = window_attention_dual(params, _win4(q, b), _win4(k, b),
                                       _win4(vsw, b), _win4(vshw, b), bias,
                                       mask, cfg.num_heads)
        return (_finalize4(s4, geom, cfg.window_size),
                _finalize4(m4, geom, cfg.window_size))
    attn = _attention_weights(q, k, params, cfg, geom, deterministic,
                              generator)
    sigma = _apply_values(attn, linear(params["wv_scale"], vsw),
                          params["proj"], cfg)
    sigma = dropout(sigma, cfg.dropout, deterministic=deterministic,
                    generator=generator)
    mu = _apply_values(attn, linear(params["wv_shift"], vshw),
                       params["proj"], cfg)
    mu = dropout(mu, cfg.dropout, deterministic=deterministic,
                 generator=generator)
    return (_finalize(sigma, geom, cfg.window_size),
            _finalize(mu, geom, cfg.window_size))


# Entry choice, the JAX package's own dispatch, kept so that each entry
# serves the configurations its TPU counterpart serves and the tests hold
# the same pairs: bf16 takes the row entry, f32 the window entry, and so do
# rows wider than this many elements (tokens in one row of windows x C).
ROWS_MAX_ELEMENTS = 262144


def fused_self_attention_block(block_params: dict, x_in: torch.Tensor,
                               cfg: AttentionConfig, *, use_norm: bool,
                               valid_hw: Optional[Tuple[int, int]] = None
                               ) -> torch.Tensor:
    """Whole self-attention block (norm1 -> attn -> +res -> [norm2 ->] MLP
    -> +res) through the block kernel; NHWC in and out.

    valid_hw: the true (h, w) of the content when x_in arrives already
    padded (a padded-resident Swin stage); tokens beyond it are padding
    whatever they hold."""
    wh, ww = cfg.window_size
    b, h, w, c = x_in.shape
    xp, pad_h, pad_w = pad_to_windows(x_in, wh, ww)
    sh, sw = effective_shift(pad_h, pad_w, cfg.window_size, cfg.shift_size)
    dev = x_in.device
    mask = (_shift_mask(pad_h, pad_w, wh, ww, sh, sw, dev)
            if sh or sw else None)
    vh, vw = valid_hw if valid_hw is not None else (h, w)
    padmask = _valid_mask(vh, vw, pad_h, pad_w, wh, ww, sh, sw, dev)
    weights = window_block.block_weights(block_params, cfg.window_size,
                                         x_in.dtype, use_norm)
    row_elements = (pad_w // ww) * wh * ww * c
    if x_in.dtype == torch.bfloat16 and row_elements <= ROWS_MAX_ELEMENTS:
        out = window_block.window_block_rows(
            xp.contiguous(), weights, heads=cfg.num_heads,
            window=cfg.window_size, shift=(sh, sw), mask=mask,
            padmask=padmask)
        return out[:, :h, :w]
    (xw,), geom = _prepare([x_in], cfg.window_size, cfg.shift_size)
    out = window_block.window_block_windows(
        xw.reshape(b, -1, wh * ww, c).contiguous(), weights,
        heads=cfg.num_heads, mask=mask, padmask=padmask)
    return _finalize(out.reshape(-1, wh * ww, c), geom, cfg.window_size)


def fused_self_attention_block_pair(bp0: dict, bp1: dict,
                                    x_in: torch.Tensor,
                                    cfg0: AttentionConfig,
                                    cfg1: AttentionConfig, *, use_norm: bool,
                                    valid_hw: Optional[Tuple[int, int]] = None
                                    ) -> torch.Tensor:
    """A Swin stage's (W-MSA, SW-MSA) block pair through the pair kernel
    K11: the same function as ``fused_self_attention_block`` with cfg0 and
    then with cfg1, in one launch. x_in may arrive padded (a padded-resident
    stage), valid_hw marking the true content. The output is in the plain
    frame (the JAX kernel gives block 1's rolled frame and its caller here
    un-rolls). The caller gates on a nonzero effective shift of block 1,
    which the pair's one-window-row dependence assumes in JAX."""
    wh, ww = cfg1.window_size
    b, h, w, c = x_in.shape
    xp, pad_h, pad_w = pad_to_windows(x_in, wh, ww)
    sh, sw = effective_shift(pad_h, pad_w, cfg1.window_size, cfg1.shift_size)
    dev = x_in.device
    mask1 = (_shift_mask(pad_h, pad_w, wh, ww, sh, sw, dev)
             if sh or sw else None)
    vh, vw = valid_hw if valid_hw is not None else (h, w)
    pm0 = _valid_mask(vh, vw, pad_h, pad_w, wh, ww, 0, 0, dev)
    pm1 = _valid_mask(vh, vw, pad_h, pad_w, wh, ww, sh, sw, dev)
    w0, w1 = (window_block.block_weights(bp, cfg1.window_size, x_in.dtype,
                                         use_norm) for bp in (bp0, bp1))
    out = block_pair.window_block_pair_rows(
        xp.contiguous(), w0, w1, heads=cfg1.num_heads,
        window=cfg1.window_size, shift=(sh, sw), mask1=mask1, padmask0=pm0,
        padmask1=pm1)
    return out[:, :h, :w]


def block_kernel_supports(dim: int, heads: int,
                          window: Tuple[int, int]) -> bool:
    """Shapes the block kernel takes (its shared-memory tile bounds C and
    N): the Swin stages of swin_T/S/B all qualify."""
    n = window[0] * window[1]
    return dim % heads == 0 and dim <= 256 and n <= 64
