"""Swin first-two-stages backbone (JAX counterpart: models/swin.py;
reference: codes/utils.py:59-102, torchvision swin_{t,s,b} cut to
features[:4]).

NHWC: patch embedding (4x4 stride-4 conv + LayerNorm, as a space-to-depth
GEMM or, with ``patch_embed_impl="conv"``, a strided convolution) -> stage
1 (dim E, shift 0 then window//2) -> patch merging (-> 2E) -> stage 2 (dim
2E). Output (B, H/8, W/8, 2E).

In evaluation with ``cfg.use_pallas`` every block runs through the block
kernel and each stage stays padded: pad to the window multiple once, run
both blocks on the padded grid (the kernel's validity mask keeps the pad
tokens inert), crop once at the end of the stage. With ``MMST_BLOCK_PAIR=1``
in the environment (read at each call, as the JAX package reads it) a
stage of two blocks runs them as one pair kernel K11 (ops/block_pair.py),
where block 1's effective shift is nonzero in both axes; elsewhere, as on
a grid of one window, the blocks run one by one. In training
(``deterministic=False``) every block is the generic block with stochastic
depth at ``cfg.stochastic_depth_probs`` (active on the frozen encoder too,
as the reference runs the whole model in train mode), its attention
through K8 and its MLP residual through K10 under ``use_pallas``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from mastermetastyletransfer_tpu_torch.config import (
    AttentionConfig, SwinConfig, check_matmul_mode,
)
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    init_style_swin_block, style_swin_block_apply,
)
from mastermetastyletransfer_tpu_torch.ops.attention import (
    block_kernel_supports, fused_self_attention_block,
    fused_self_attention_block_pair,
)
from mastermetastyletransfer_tpu_torch.ops.mlp import uniform
from mastermetastyletransfer_tpu_torch.ops.norm import layer_norm
from mastermetastyletransfer_tpu_torch.ops.windows import (
    effective_shift, pad_to_windows,
)


def _block_cfg(cfg: SwinConfig, stage: int, block_idx: int) -> AttentionConfig:
    wh, ww = cfg.window_size
    shifted = block_idx % 2 == 1  # torchvision alternates 0 / window//2
    return AttentionConfig(
        dim=cfg.embed_dim * 2 ** stage, num_heads=cfg.num_heads[stage],
        window_size=(wh, ww),
        shift_size=(wh // 2, ww // 2) if shifted else (0, 0),
        use_pallas=cfg.use_pallas)


def init_swin_backbone(g: torch.Generator, cfg: SwinConfig) -> dict:
    e = cfg.embed_dim
    params = {
        "patch_embed": {
            "conv": {"kernel": uniform(g, (4, 4, 3, e), (1.0 / 48) ** 0.5),
                     "bias": torch.zeros(e)},
            "norm": {"scale": torch.ones(e), "bias": torch.zeros(e)}},
        "patch_merge": {
            "norm": {"scale": torch.ones(4 * e), "bias": torch.zeros(4 * e)},
            "reduction": {"kernel": uniform(g, (4 * e, 2 * e),
                                            (1.0 / (4 * e)) ** 0.5)}},
    }
    for stage in range(2):
        for blk in range(cfg.depths[stage]):
            params[f"stage{stage}_block{blk}"] = init_style_swin_block(
                g, _block_cfg(cfg, stage, blk), use_norm=True,
                exclude_mlp=False, mlp_ratio=cfg.mlp_ratio)
    return params


def patch_merging(params: dict, x: torch.Tensor) -> torch.Tensor:
    """torchvision PatchMerging: pad H, W to even, concat the 2x2
    neighbourhood (even-even, odd-even, even-odd, odd-odd), LayerNorm(4C),
    Linear(4C -> 2C, no bias)."""
    _, h, w, _ = x.shape
    if h % 2 or w % 2:
        x = torch.nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1)
    x = layer_norm(x, params["norm"]["scale"], params["norm"]["bias"])
    return x @ params["reduction"]["kernel"].to(x.dtype)


def patch_embed(params: dict, images: torch.Tensor,
                cfg: SwinConfig) -> torch.Tensor:
    """4x4 stride-4 patch embedding + LayerNorm: (B, H, W, 3) ->
    (B, H/4, W/4, E), as a space-to-depth GEMM or a strided convolution
    (``cfg.patch_embed_impl``). Each patch is its own, so an H-band of the
    image embeds to the band of the features."""
    b, h, w, cin = images.shape
    pe = params["conv"]
    e = pe["kernel"].shape[-1]
    kernel = pe["kernel"].to(images.dtype)
    if cfg.patch_embed_impl == "conv":
        x = F.conv2d(images.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                     stride=4).permute(0, 2, 3, 1)
    else:
        patches = images.reshape(b, h // 4, 4, w // 4, 4, cin)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(
            b, h // 4, w // 4, 16 * cin)
        x = patches @ kernel.reshape(16 * cin, e)
    x = x + pe["bias"].to(images.dtype)
    return layer_norm(x, params["norm"]["scale"], params["norm"]["bias"])


def swin_backbone_apply(params: dict, images: torch.Tensor,
                        cfg: SwinConfig, *, deterministic: bool = True,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """NHWC images (B, H, W, 3) -> features (B, H/8, W/8, 2E)."""
    check_matmul_mode(cfg, "swin")
    x = patch_embed(params["patch_embed"], images, cfg)

    # A stage stays padded only where every block runs through the kernel:
    # the composed path has no validity mask for the pad tokens.
    resident = deterministic and cfg.use_pallas and all(
        block_kernel_supports(cfg.embed_dim * 2 ** s, cfg.num_heads[s],
                              cfg.window_size) for s in range(2))
    # The pair kernel's only shape gate is the block kernel's shared memory
    # (``resident``); the JAX gate's bf16 and row-width terms are TPU
    # scoped-VMEM limits, and its MMST_PAIR_BUDGET (a VMEM tile budget) has
    # no counterpart here.
    pair_on = os.environ.get("MMST_BLOCK_PAIR", "0") == "1"
    wh, ww = cfg.window_size
    sd_idx = 0
    for stage in range(2):
        if stage == 1:
            x = patch_merging(params["patch_merge"], x)
        vh, vw = x.shape[1], x.shape[2]
        if resident:
            x = pad_to_windows(x, wh, ww)[0]
        cfgs = [_block_cfg(cfg, stage, blk)
                for blk in range(cfg.depths[stage])]
        if (pair_on and resident and len(cfgs) == 2
                and all(effective_shift(x.shape[1], x.shape[2],
                                        cfg.window_size,
                                        cfgs[1].shift_size))):
            x = fused_self_attention_block_pair(
                params[f"stage{stage}_block0"], params[f"stage{stage}_block1"],
                x, cfgs[0], cfgs[1], use_norm=True, valid_hw=(vh, vw))
            sd_idx += 2
            x = x[:, :vh, :vw]
            continue
        for blk, bcfg in enumerate(cfgs):
            bp = params[f"stage{stage}_block{blk}"]
            if resident:
                x = fused_self_attention_block(bp, x, bcfg, use_norm=True,
                                               valid_hw=(vh, vw))
            else:
                x = style_swin_block_apply(
                    bp, x, x, x, bcfg, use_norm=True, exclude_mlp=False,
                    sd_prob=cfg.stochastic_depth_probs[sd_idx],
                    calculating_key=True, deterministic=deterministic,
                    generator=generator)
            sd_idx += 1
        if resident:
            x = x[:, :vh, :vw]
    return x
