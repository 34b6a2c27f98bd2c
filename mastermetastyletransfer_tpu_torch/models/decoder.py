"""CNN upsampling decoder (AdaIN-paper architecture): nine reflect-padded
3x3 convs with ReLU and three nearest 2x upsamples, 256 channels -> RGB
(JAX counterpart: models/decoder.py; reference: codes/decoder.py:23-55).

This is the plain nine-conv form. The JAX package computes the same
function in phase space (an exact rewrite, ``fuse_upsample``) to feed its
stencil kernels (K5-K7), which are not ported yet; ``use_pallas=True`` on
this stage raises until they are.
"""

from __future__ import annotations

import torch

from mastermetastyletransfer_tpu_torch.config import DecoderConfig
from mastermetastyletransfer_tpu_torch.ops.conv import (
    init_conv, reflect_conv, upsample_nearest,
)


def _channel_plan(c: int):
    """(in_ch, out_ch, upsample_after) per conv (codes/decoder.py:23-55)."""
    return [
        (c, c // 2, True),
        (c // 2, c // 2, False),
        (c // 2, c // 2, False),
        (c // 2, c // 2, False),
        (c // 2, c // 4, True),
        (c // 4, c // 4, False),
        (c // 4, c // 8, True),
        (c // 8, c // 8, False),
        (c // 8, 3, False),
    ]


def init_cnn_decoder(g: torch.Generator, cfg: DecoderConfig) -> dict:
    return {f"conv{i}": init_conv(g, ci, co, cfg.initializer)
            for i, (ci, co, _) in enumerate(_channel_plan(cfg.channel_dim))}


def cnn_decoder_apply(params: dict, x: torch.Tensor,
                      cfg: DecoderConfig) -> torch.Tensor:
    """NHWC features (B, H/8, W/8, C) -> RGB (B, H, W, 3); the last conv
    has no activation (reference: codes/decoder.py:54)."""
    if cfg.use_pallas:
        raise NotImplementedError(
            "the decoder's kernels are not ported yet; run it with "
            "DecoderConfig.use_pallas=False")
    plan = _channel_plan(cfg.channel_dim)
    for i, (_, _, up) in enumerate(plan):
        x = reflect_conv(params[f"conv{i}"], x, relu=i < len(plan) - 1)
        if up:
            x = upsample_nearest(x, 2)
    return x
