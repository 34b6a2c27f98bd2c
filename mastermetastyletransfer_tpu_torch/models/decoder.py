"""CNN upsampling decoder (AdaIN-paper architecture): nine reflect-padded
3x3 convs with ReLU and three nearest 2x upsamples, 256 channels -> RGB
(JAX counterpart: models/decoder.py; reference: codes/decoder.py:23-55).

With ``fuse_upsample`` (the default) the decoder runs the JAX package's
conv plan in phase space (ops/conv.py), an exact rewrite of the nine convs:
each upsample -> conv pair is one coarse-grid phase conv, the convs after
it stay phase-packed until the next upsample, and in eval
(``phase2_tail``) the last upsample enters a second phase level, so the
fine RGB grid is built once, at the end. With ``use_pallas`` the phase
convs run the stencil kernels K5/K6 and the realign K7
(ops/phase_conv.py); with ``rgb_tail="l2k128"`` the RGB conv runs the
RGB-tail kernel K12 (its ``rgb128`` entry), with or without ``use_pallas``,
as in the JAX package. Without ``fuse_upsample``, the plain nine convs.
"""

from __future__ import annotations

import torch

from mastermetastyletransfer_tpu_torch.config import (
    DecoderConfig, check_matmul_mode,
)
from mastermetastyletransfer_tpu_torch.ops.conv import (
    init_conv, l2_to_l1, phase2_conv3x3, phase_conv3x3, phase_interleave,
    phase_interleave2, reflect_conv, upsample_conv_fused, upsample_nearest,
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


def cnn_decoder_apply(params: dict, x: torch.Tensor, cfg: DecoderConfig,
                      deterministic: bool = True) -> torch.Tensor:
    """NHWC features (B, H/8, W/8, C) -> RGB (B, H, W, 3); the last conv
    has no activation (reference: codes/decoder.py:54). ``deterministic``
    (eval) allows the double-phase tail, as in the JAX package. A conv
    that emits the L2 tail's padded output always does so when the stencil
    kernels run (the JAX package's default padded-output chaining)."""
    check_matmul_mode(cfg, "decoder")
    plan = _channel_plan(cfg.channel_dim)
    n = len(plan)
    pending_up = False   # the previous conv is marked upsample-after
    level = 0            # phase level of x: 0 plain, 1 (2x2), 2 (4x4)
    x_padded = False     # x carries the L2 pad border already
    stencil_on = cfg.use_pallas and cfg.use_stencil_conv

    def consumes_pp(j):
        # conv j takes a padded L2 tensor directly (stays in the L2 tail
        # and is not the RGB conv through l2_to_l1)
        return (j < n and j < cfg.phase_exit
                and not (j == n - 1 and cfg.rgb_tail == "l1"))

    for i, (_, _, up) in enumerate(plan):
        p = params[f"conv{i}"]
        relu = i < n - 1
        if not cfg.fuse_upsample or i >= cfg.phase_exit:
            if level == 2:
                x = phase_interleave2(x)
            elif level == 1:
                x = phase_interleave(x)
            level = 0
            if pending_up:
                x = upsample_nearest(x, 2)
                pending_up = False
            x = reflect_conv(p, x, relu=relu)
            if up:
                x = upsample_nearest(x, 2)
            continue
        # does the next conv take this upsample inside L2 space? (eval only)
        phase2_next = (cfg.phase2_tail and deterministic and up and i + 1 < n
                       and i + 1 < cfg.phase_exit
                       and not any(u2 for _, _, u2 in plan[i + 1:]))
        if pending_up and level == 1:
            # the last upsample -> L2 up-conv
            emit = stencil_on and consumes_pp(i + 1)
            x = phase2_conv3x3(p, x, up=True, relu=relu,
                               use_pallas=stencil_on, emit_padded=emit)
            x_padded = emit
            level = 2
        elif pending_up:
            x = upsample_conv_fused(p, x, relu=relu, keep_phase=True,
                                    use_pallas=cfg.use_pallas,
                                    stencil=cfg.use_stencil_conv)
            level = 1
        elif level == 1:
            # leave phase space at an upsample the next conv does not take
            # in L2, and for the RGB conv
            leave = (up and not phase2_next) or i == n - 1
            x = phase_conv3x3(p, x, relu=relu, interleave=leave,
                              use_pallas=cfg.use_pallas,
                              stencil=cfg.use_stencil_conv)
            level = 0 if leave else 1
        elif level == 2:
            leave = i == n - 1
            if leave and cfg.rgb_tail == "l1":
                x = phase_conv3x3(p, l2_to_l1(x), relu=relu, interleave=True,
                                  use_pallas=cfg.use_pallas,
                                  stencil=cfg.use_stencil_conv)
            else:
                emit = (not leave) and stencil_on and consumes_pp(i + 1)
                x = phase2_conv3x3(p, x, up=False, relu=relu,
                                   interleave=leave, use_pallas=stencil_on,
                                   k128=leave and cfg.rgb_tail == "l2k128",
                                   in_padded=x_padded, emit_padded=emit)
                x_padded = emit
            level = 0 if leave else 2
        else:
            x = reflect_conv(p, x, relu=relu)
        pending_up = up
    return x
