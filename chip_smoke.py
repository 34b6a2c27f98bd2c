"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA sources (csrc/ -> build/, one nvcc per source, side
by side, at first use), holds each kernel entry against its plain PyTorch
version at the shapes of the slice, then drives the slice -- pair serving,
``StylizeService`` -> ``master_apply`` at swin_B widths, 512x512 images,
k=1, with the Swin, style-transformer and decoder kernels on -- through its
entry points with weights drawn from a seeded ``torch.Generator``. One JSON line
per phase, flushed as it goes; any failed phase raises and the exit code is
not 0. The last line is {"ok": true, "device": {...}}; before it come the
card's name and power limit as nvidia-smi gives them, and the kernel
summary.

Phases: device, build; kernels (each entry against its plain version, with
ms per call, the bound, the plain version's ms and shared memory per
block): the four Swin blocks of one pass (K1 row entry, K2 window entry),
the style transformer's K2 blocks (encoder Key block without norms, decoder
self block with both), K3 and K4 at the shapes of one request batch, and a
swin_S-width block (C=192, 6 heads), the decoder's stencil and align
kernels at the convs of one request batch (K5 at conv1-4 and conv6, K6 with
pad columns at conv7 and without them at the same shape, K7 at conv5; with
the time of one cuDNN conv of the same composed kernel and padded input as
the library yardstick, a conv without the align); slice (the bf16 and f32
services, launches per path counted from zero just before each path's run,
each against the reference services: every kernel off and the decoder's
nine plain convs, so that the reference shares no phase algebra with
K5-K7); f32_entry (one float32 pair through ``make_stylize_fn`` on the card
against the same call on the CPU, with PyTorch's own TF32 settings);
stages (CUDA-event times of one batch-8 pair call at bf16 per stage,
kernels on, off, and as the reference service runs).

Needs only torch, numpy and the standard library, and one CUDA card.

Tolerances, kernel against plain version, element by element. float32:
1e-4 of the largest magnitude of the plain output (order of sums).
bfloat16: two units in the last place of the plain output element (the two
sides round the same f32 value to bf16, and a value near a rounding
boundary may land on either side) plus 2^-6 of the largest update
|out - x| (an intermediate rounded to bf16 on the other side of a boundary
moves the update by about 2^-8 of itself); x is the block's input, K3's
Scale or Shift input, K4's Query. The decoder's stencil kernels at bfloat16:
two units in the last place plus 2^-8 of the largest |output| (both sides
sum the same products in f32 and round once); the phase align exactly.
Slice, float32: the kernel-path service against the float32 reference
service, per-pixel MAE at most 1e-4 of the mean output magnitude; the same
1e-4 for the float32 entry point on the card against the CPU. Slice,
bfloat16: every bf16 route carries bf16 rounding noise through the whole
model, and its size against the output moves with the weight draw, so the
kernel path is held to the plain bf16 route on the same draw and pairs:
its per-pixel MAE against the float32 reference at most 1.5 times the
plain bf16 reference service's.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from mastermetastyletransfer_tpu_torch.config import (
    AttentionConfig, ModelConfig,
)
from mastermetastyletransfer_tpu_torch.models.decoder import cnn_decoder_apply
from mastermetastyletransfer_tpu_torch.models.master import (
    _TF32_OFF, init_master_model, make_stylize_fn,
)
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    init_style_swin_block, style_transformer_apply,
)
from mastermetastyletransfer_tpu_torch.models.swin import swin_backbone_apply
from mastermetastyletransfer_tpu_torch.ops import _build
from mastermetastyletransfer_tpu_torch.ops import conv as tconv
from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc
from mastermetastyletransfer_tpu_torch.ops import style_block as sb
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from mastermetastyletransfer_tpu_torch.ops.attention import (
    init_dual_value_window_attention, init_window_attention,
)
from mastermetastyletransfer_tpu_torch.ops.mlp import init_mlp
from mastermetastyletransfer_tpu_torch.ops.windows import (
    effective_shift, shift_attention_mask, valid_token_mask, window_partition,
)
from mastermetastyletransfer_tpu_torch.serve import StylizeService
from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL_F32 = 1e-4
TOL_BF16_ULPS, TOL_BF16_UPDATE = 2, 2.0 ** -6
TOL_SLICE_MAE = 1e-4
TOL_BF16_NOISE = 1.5
TOL_CONV_BF16_SCALE = 2.0 ** -8
LAUNCHES = (wb.LAUNCHES, sb.LAUNCHES, pc.LAUNCHES)

DEVICE = "cuda"
SIZE, MAX_BATCH, K = 512, 8, 1
REQUESTS, CLIENTS = 16, 4
F32_REQUESTS = 4
F32_ENTRY_SIZE = 128
# Launches per request batch on each slice path (the main path is bf16).
DECODER_PER_BATCH = {"stencil_phase_conv": 5, "stencil_phase2_conv": 0,
                     "stencil_phase2_conv_padcols": 1, "phase_align": 1}
PER_BATCH = {
    "bfloat16": {"window_block_rows": 4, "window_block_windows": 2 * K,
                 "encoder_scale_shift": K, "decoder_tail": K,
                 **DECODER_PER_BATCH},
    "float32": {"window_block_rows": 0, "window_block_windows": 4 + 2 * K,
                "encoder_scale_shift": K, "decoder_tail": K,
                **DECODER_PER_BATCH},
}
ST_C, ST_HEADS = 256, 8
T0 = time.perf_counter()


def padded(n: int) -> int:
    """n tokens padded to the 7-token window."""
    return -(-n // 7) * 7


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase,
                      "elapsed_s": round(time.perf_counter() - T0, 3),
                      **fields}), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters runs, after one warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def all_launches() -> dict:
    return {k: v for counts in LAUNCHES for k, v in counts.items()}


def reset_launches() -> None:
    for counts in LAUNCHES:
        for key in counts:
            counts[key] = 0


# ---------------------------------------------------------------------------
# 2. kernels at the slice's shapes
# ---------------------------------------------------------------------------

def kernel_error(got: torch.Tensor, ref: torch.Tensor, x: torch.Tensor):
    """(max-abs error, largest error / tolerance over the elements): the
    check passes when the second is <= 1. See the module docstring."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if x.dtype == torch.float32:
        tol = TOL_F32 * max(1.0, ref.abs().max().item())
    else:
        # |ref| = m 2^e with m in [0.5, 1): bf16 (8 significant bits) has
        # a unit in the last place of 2^(e - 8) there.
        ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
        ulp = torch.where(ref == 0, 0.0, ulp)
        tol = (TOL_BF16_ULPS * ulp
               + TOL_BF16_UPDATE * (ref - x.float()).abs().max())
    return err.max().item(), (err / tol).max().item()


def item_bytes(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def mask_bytes(nw: int, n: int, has_mask: bool, has_padmask: bool) -> int:
    return ((nw * n * n * 4 if has_mask else 0)
            + (nw * n * 4 if has_padmask else 0))


def block_cost(b: int, nw: int, n: int, c: int, heads: int, hidden: int,
               dtype, has_mask: bool, has_padmask: bool):
    """(operations, bytes) one block call needs: every token of the padded
    grid goes through the block; each input byte is read once and each
    output byte written once."""
    tokens = b * nw * n
    flops = tokens * (2 * c * 3 * c + 2 * c * c + 2 * 2 * c * hidden)
    flops += b * nw * heads * 2 * (2 * n * n * (c // heads))
    weights = (3 * c * c + c * c + 2 * c * hidden) * item_bytes(dtype)
    vectors = (3 * c + c + hidden + c + 4 * c) * 4 + heads * n * n * 4
    return flops, (2 * tokens * c * item_bytes(dtype) + weights + vectors
                   + mask_bytes(nw, n, has_mask, has_padmask))


def style_cost(kernel: str, b: int, nw: int, n: int, c: int, heads: int,
               dtype, has_mask: bool, has_padmask: bool):
    """(operations, bytes) of one K3 or K4 call, per window: K3 44 N C^2 +
    6 N^2 C (q and k from Key, v of two streams through the shared wv, the
    shared proj twice, two MLPs of width 4C), K4 24 N C^2 + 6 N^2 C; one
    softmax per head shared by two value products. Bytes: K3 reads three
    window tensors and writes two, K4 reads five and writes one."""
    per_window = {"encoder_scale_shift": 44, "decoder_tail": 24}[kernel]
    flops = b * nw * (per_window * n * c * c + 6 * n * n * c)
    tiles = {"encoder_scale_shift": 5, "decoder_tail": 6}[kernel]
    mats = {"encoder_scale_shift": 20, "decoder_tail": 11}[kernel]
    vecs = {"encoder_scale_shift": 14, "decoder_tail": 8}[kernel]
    nbytes = (tiles * b * nw * n * c * item_bytes(dtype)
              + mats * c * c * item_bytes(dtype) + vecs * c * 4
              + heads * n * n * 4 + mask_bytes(nw, n, has_mask, has_padmask))
    return flops, nbytes


def conv_error(got: torch.Tensor, ref: torch.Tensor):
    """The stencil kernels' (max-abs error, largest error / tolerance): at
    float32 1e-4 of the largest |output|, at bfloat16 two units in the last
    place of the element plus 2^-8 of the largest |output|."""
    bf16 = got.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = max(1.0, ref.abs().max().item())
    if bf16:
        ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
        tol = (TOL_BF16_ULPS * torch.where(ref == 0, 0.0, ulp)
               + TOL_CONV_BF16_SCALE * scale)
    else:
        tol = TOL_F32 * scale
    return err.max().item(), (err / tol).max().item()


def exact_error(got: torch.Tensor, ref: torch.Tensor):
    """A permutation: (max-abs error, 0 if bit-equal else inf)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, 0.0 if torch.equal(got, ref) else float("inf")


def run_case(rows: list, entry: str, label: str, dtype, kern, plain, xs,
             cost, smem: int, check=None, library=None, **meta) -> None:
    """Check kern() against plain() output by output, time both, and emit
    one kernels line. ``check(got, ref)`` gives (max-abs error, error /
    tolerance); by default kernel_error against xs, the input each output's
    bf16 tolerance measures its update from. ``library``: one PyTorch call
    timed beside the kernel as its yardstick."""
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    if check is None:
        errs = [kernel_error(g, r, x) for g, r, x in zip(got, ref, xs)]
    else:
        errs = [check(g, r) for g, r in zip(got, ref)]
    err = max(e[0] for e in errs)
    err_over_tol = max(e[1] for e in errs)
    if not err_over_tol <= 1.0:
        raise AssertionError(f"{entry} {label} {dtype}: max-abs {err}, "
                             f"error/tolerance {err_over_tol} > 1")
    del got, ref
    ms = cuda_ms(kern, 5)
    plain_ms = cuda_ms(plain, 3)
    library_ms = cuda_ms(library, 5) if library is not None else None
    flops, nbytes = cost
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    row = dict(entry=entry, case=label, dtype=str(dtype).replace("torch.", ""),
               shape=list(xs[0].shape), max_abs_err=err,
               err_over_tol=err_over_tol, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms,
               bound_ms=max(t_ops, t_bytes), ops_ms=t_ops, bytes_ms=t_bytes,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, mbytes=nbytes / 1e6, smem_bytes=smem,
               **meta)
    emit("kernels", **row)
    rows.append(row)


def swin_block_cases(gen, rows, *, b, c, heads, hp, valid, shift, label,
                     entries):
    """One Swin block (norms on both sides) on a (b, hp, hp, c) padded grid
    of which valid x valid tokens are real, through the given (entry,
    dtype) pairs."""
    dev = torch.device(DEVICE)
    sh, sw = effective_shift(hp, hp, (7, 7), shift)
    acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                           shift_size=(sh, sw))
    params = tree_map(lambda t: t.to(dev), init_style_swin_block(
        gen, acfg, use_norm=True, exclude_mlp=False, mlp_ratio=4.0))
    mask = (torch.from_numpy(shift_attention_mask(hp, hp, 7, 7, sh, sw))
            .to(dev) if sh or sw else None)
    padmask = torch.from_numpy(
        valid_token_mask(valid, valid, hp, hp, 7, 7, sh, sw)).to(dev)
    x32 = torch.randn((b, hp, hp, c), generator=gen).to(dev)
    nw = (hp // 7) ** 2
    for entry, dtype in entries:
        w = wb.block_weights(params, (7, 7), dtype, use_norm=True)
        kw = dict(heads=heads, mask=mask, padmask=padmask)
        if entry == "window_block_rows":
            x = x32.to(dtype).contiguous()
            kw.update(window=(7, 7), shift=(sh, sw))
            kern, plain = wb.window_block_rows, wb.window_block_rows_plain
        else:
            xr = torch.roll(x32, (-sh, -sw), (1, 2)) if sh or sw else x32
            x = window_partition(xr, 7, 7).reshape(b, nw, 49, c)
            x = x.to(dtype).contiguous()
            kern = wb.window_block_windows
            plain = wb.window_block_windows_plain
        run_case(rows, entry, label, dtype,
                 lambda: [kern(x, w, **kw)], lambda: [plain(x, w, **kw)],
                 [x], block_cost(b, nw, 49, c, heads, 4 * c, dtype,
                                 mask is not None, True),
                 wb._lib().mmst_window_block_smem_bytes(
                     49, c, heads, item_bytes(dtype)),
                 shift=[sh, sw])


def style_cases(gen, rows):
    """The style transformer's kernels at the shapes of one request batch:
    at 512^2, (8, 100, 49, 256) windows of the 64x64 token grid padded to
    70x70, shift (4, 4), 8 heads -- K2 as the encoder Key block (no norms)
    and as the decoder self block (both norms), K3 and K4."""
    dev = torch.device(DEVICE)
    grid = SIZE // 8
    pad = padded(grid)
    b, nw, n, c, heads = MAX_BATCH, (pad // 7) ** 2, 49, ST_C, ST_HEADS
    sh, sw = effective_shift(pad, pad, (7, 7), (4, 4))
    mask = torch.from_numpy(shift_attention_mask(pad, pad, 7, 7, sh, sw)
                            ).to(dev)
    padmask = torch.from_numpy(valid_token_mask(
        grid, grid, pad, pad, 7, 7, sh, sw)).to(dev)
    kw = dict(heads=heads, mask=mask, padmask=padmask)
    acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                           shift_size=(sh, sw))
    block = init_style_swin_block(gen, acfg, use_norm=True, exclude_mlp=False,
                                  mlp_ratio=4.0)
    params = tree_map(lambda t: t.to(dev), {
        "block": block, "attn": init_window_attention(gen, acfg),
        "dual": init_dual_value_window_attention(gen, acfg),
        **{m: init_mlp(gen, c, 4 * c, init="xavier_uniform")
           for m in ("mlp_scale", "mlp_shift", "last_mlp")}})
    x32 = [torch.randn((b, nw, n, c), generator=gen).to(dev)
           for _ in range(5)]
    for dtype in (torch.bfloat16, torch.float32):
        xs = [x.to(dtype).contiguous() for x in x32]
        for label, use_norm in (("st_encoder_key", False),
                                ("st_decoder_self", True)):
            w = wb.block_weights(params["block"], (7, 7), dtype, use_norm)
            run_case(rows, "window_block_windows", label, dtype,
                     lambda: [wb.window_block_windows(xs[0], w, **kw)],
                     lambda: [wb.window_block_windows_plain(xs[0], w, **kw)],
                     [xs[0]], block_cost(b, nw, n, c, heads, 4 * c, dtype,
                                         True, True),
                     wb._lib().mmst_window_block_smem_bytes(
                         n, c, heads, item_bytes(dtype)))
        w = sb.encoder_weights(params["attn"], params["mlp_scale"],
                               params["mlp_shift"], None, (7, 7), dtype)
        run_case(rows, "encoder_scale_shift", "st_encoder", dtype,
                 lambda: sb.encoder_scale_shift(*xs[:3], w, **kw),
                 lambda: sb.encoder_scale_shift_plain(*xs[:3], w, **kw),
                 xs[1:3], style_cost("encoder_scale_shift", b, nw, n, c,
                                     heads, dtype, True, True),
                 sb.smem_bytes(n, c, heads, dtype))
        w = sb.decoder_tail_weights(params["dual"], params["last_mlp"],
                                    (7, 7), dtype)
        run_case(rows, "decoder_tail", "st_decoder", dtype,
                 lambda: [sb.decoder_tail(*xs, w, **kw)],
                 lambda: [sb.decoder_tail_plain(*xs, w, **kw)],
                 [xs[4]], style_cost("decoder_tail", b, nw, n, c, heads,
                                     dtype, True, True),
                 sb.smem_bytes(n, c, heads, dtype))


def stencil_cost(pp: torch.Tensor, table: pc.GroupTable, c_out: int,
                 out_numel: int, w_numel: int):
    """(operations, bytes) of one stencil call: the products of the nonzero
    weight blocks of the table (the function's own work, as the kernel runs
    it), each input read once and the output written once."""
    b, hp, wp, cin = pp.shape
    pixels = b * (hp - 2) * (wp - 2)
    chunk = cin // table.nchunks
    nblocks = sum(bin(m).count("1") for m in table.blocks)
    flops = 2 * pixels * nblocks * chunk * c_out
    groups = len(table.offsets)
    nbytes = ((pp.numel() + w_numel + out_numel) * pp.element_size()
              + groups * c_out * 4)
    return flops, nbytes


def decoder_cases(gen, rows):
    """The decoder's kernels at the convs of one request batch (B=8 at
    512^2, decoder input (8, 64, 64, 256)): K5 at conv1 (the upsample
    kernel, 128 -> 4 x 128 over (8, 66, 66, 128)), conv2 and conv3 (L1
    phase, 4 x 128 -> 4 x 128 over (8, 66, 66, 512)), conv4 (-> 4 x 64) and
    conv6 (4 x 64 -> 4 x 32 over (8, 130, 130, 256)); K6 at conv7 (L1 4 x 32
    -> L2 16 x 32 over (8, 130, 130, 128)), with and without the pad
    columns; K7 at conv5 ((8, 129, 129, 256), C' = 64). Inputs and weights
    random; the library yardstick is one cuDNN conv of the same composed
    kernel over the same padded input, with bias (no align)."""
    dev = torch.device(DEVICE)
    b = MAX_BATCH
    g0 = SIZE // 8
    convs = (  # (label, entry, input shape, 3x3 kernel Cin, C', form)
        ("conv1", "stencil_phase_conv", (b, g0, g0, 128), 128, 128, "up"),
        ("conv2", "stencil_phase_conv", (b, g0, g0, 512), 128, 128, "l1"),
        ("conv3", "stencil_phase_conv", (b, g0, g0, 512), 128, 128, "l1"),
        ("conv4", "stencil_phase_conv", (b, g0, g0, 512), 128, 64, "l1"),
        ("conv6", "stencil_phase_conv", (b, 2 * g0, 2 * g0, 256), 64, 32,
         "l1"),
        ("conv7", "stencil_phase2_conv_padcols", (b, 2 * g0, 2 * g0, 128),
         32, 32, "l2"),
        ("conv7", "stencil_phase2_conv", (b, 2 * g0, 2 * g0, 128), 32, 32,
         "l2"))
    for label, entry, shape, cin, c_out, form in convs:
        w3 = tconv.init_conv(gen, cin, c_out)["kernel"]
        bias = torch.randn(c_out, generator=gen) * 0.1
        x32 = torch.randn(shape, generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            if form == "up":
                pk = tconv._phase_kernel(w3)
                pp, table = tconv._edge_pad(x32), tconv._UPSAMPLE_TABLE
            elif form == "l1":
                pk = tconv._phase_space_kernel(w3)
                pp, table = tconv._edge_pad(x32), tconv._phase_space_table()
            else:
                pk, _ = tconv._phase2_kernel(w3, True)
                pp = tconv._phase2_pad(x32, 2, cin, True)
                table = tconv._phase2_table(True)
            groups = len(table.offsets)
            pp = pp.to(dev, dtype).contiguous()
            pk = pk.to(dev, dtype).contiguous()
            bias_n = bias.repeat(groups).to(dev).contiguous()
            args = (pp, pk, bias_n, table)
            out_w = shape[2] + (2 if entry.endswith("padcols") else 0)
            if entry.endswith("padcols"):
                args += (tconv._phase2_pad_maps(shape[2], 4, False),)
            kern_fn = getattr(pc, entry)
            plain_fn = getattr(pc, entry + "_plain")
            w_lib = pk.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            x_lib = pp.permute(0, 3, 1, 2)
            b_lib = bias_n.to(dtype)

            def library():
                with (_TF32_OFF if dtype == torch.float32
                      else contextlib.nullcontext()):
                    return F.conv2d(x_lib, w_lib, b_lib)

            smem, regs = pc.kernel_attributes("stencil", dtype)
            run_case(rows, entry, label, dtype,
                     lambda: [kern_fn(*args)], lambda: [plain_fn(*args)],
                     [pp], stencil_cost(pp, table, c_out,
                                        shape[0] * shape[1] * out_w
                                        * groups * c_out, pk.numel()),
                     smem, check=conv_error, library=library,
                     registers=regs)
    # K7 at conv5: the realign of the (8, 129, 129, 4 x 64) conv output
    big32 = torch.randn((b, 2 * g0 + 1, 2 * g0 + 1, 256), generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        big = big32.to(dev, dtype).contiguous()
        nbytes = (big.numel() + b * 4 * g0 * g0 * 256) * big.element_size()
        smem, regs = pc.kernel_attributes("align", dtype)
        run_case(rows, "phase_align", "conv5", dtype,
                 lambda: [pc.phase_align(big, 64)],
                 lambda: [pc.phase_align_plain(big, 64)], [big],
                 (0, nbytes), smem, check=exact_error, registers=regs)


def check_kernels(gen: torch.Generator):
    rows = []
    # The Swin pass of one request batch: 2 x max_batch images; at 512^2
    # stage 1 on 133x133 padded tokens (valid 128), stage 2 on 70x70 (valid
    # 64); shift 0 and window // 2. Both entries at f32 too.
    swin_entries = (("window_block_rows", torch.bfloat16),
                    ("window_block_rows", torch.float32),
                    ("window_block_windows", torch.float32))
    for stage, (c, heads, valid) in enumerate(((128, 4, SIZE // 4),
                                               (256, 8, SIZE // 8))):
        for shift in ((0, 0), (3, 3)):
            swin_block_cases(gen, rows, b=2 * MAX_BATCH, c=c, heads=heads,
                             hp=padded(valid), valid=valid, shift=shift,
                             label=f"swin_stage{stage + 1}",
                             entries=swin_entries)
    style_cases(gen, rows)
    # A swin_S/T-width block (stage 2: C=192, 6 heads, head dim 32), which
    # the port's gate sends through the block kernel too.
    swin_block_cases(gen, rows, b=2 * MAX_BATCH, c=192, heads=6,
                     hp=padded(SIZE // 8), valid=SIZE // 8, shift=(3, 3),
                     label="swin_S_stage2",
                     entries=(("window_block_rows", torch.bfloat16),
                              ("window_block_windows", torch.float32)))
    decoder_cases(gen, rows)
    return rows


# ---------------------------------------------------------------------------
# 3. the slice: pair serving at 512^2
# ---------------------------------------------------------------------------

def slice_config(dtype: str, kernels: bool) -> ModelConfig:
    return ModelConfig(compute_dtype=dtype).with_kernels(kernels)


def reference_config(dtype: str) -> ModelConfig:
    """The slice's reference: every kernel off and the decoder as its nine
    plain convs, independent of the phase algebra that feeds K5-K7."""
    cfg = slice_config(dtype, False)
    return cfg.replace(decoder=cfg.decoder.replace(fuse_upsample=False))


def bf16_noise_verdict(got: np.ndarray, plain: np.ndarray,
                       ref32: np.ndarray) -> dict:
    """The bf16 slice check's numbers: the per-pixel MAE of the kernel path
    (got) and of the plain bf16 route (plain) against the float32
    reference, and their ratio, which may be at most TOL_BF16_NOISE."""
    mae = float(np.abs(got - ref32).mean())
    plain_mae = float(np.abs(plain - ref32).mean())
    return dict(mae_vs_f32=mae, plain_mae_vs_f32=plain_mae,
                noise_ratio=mae / plain_mae, noise_ratio_tol=TOL_BF16_NOISE,
                mae_vs_plain=float(np.abs(got - plain).mean()),
                mean_abs_output=float(np.abs(ref32).mean()))


def serve_requests(svc: StylizeService, pairs, clients: int):
    """Send the pairs from `clients` threads, each in turn; returns outputs,
    per-request latencies (s) and the wall time (s)."""
    outs, lat = [None] * len(pairs), [None] * len(pairs)
    errors = []

    def client(idx):
        for i in idx:
            t = time.perf_counter()
            try:
                outs[i] = svc.stylize(*pairs[i], timeout=600.0)
            except Exception as e:  # re-raised below, in the main thread
                errors.append(e)
                return
            lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=client,
                                args=(range(j, len(pairs), clients),))
               for j in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or any(o is None for o in outs):
        raise RuntimeError("requests did not complete")
    return outs, lat, wall


def check_launches(dtype: str, launches: dict) -> int:
    """Every entry launched its expected count per request batch on this
    path; returns the number of batches."""
    batches = launches["encoder_scale_shift"] // K
    want = {e: n * batches for e, n in PER_BATCH[dtype].items()}
    if batches <= 0 or launches != want:
        raise AssertionError(f"{dtype} path launched {launches}, expected "
                             f"{PER_BATCH[dtype]} per batch")
    return batches


def run_slice(params, pairs):
    """Both kernel services (bf16 on every pair, f32 on the first
    F32_REQUESTS), then the f32 and bf16 reference services on every
    pair."""
    results = {}
    services = {}
    for dtype in ("bfloat16", "float32"):
        svc = StylizeService(params, slice_config(dtype, True), size=SIZE,
                             k=K, max_batch=MAX_BATCH, device=DEVICE)
        svc.warmup()
        services[dtype] = svc
    torch.cuda.synchronize()
    emit("slice_warmup", launches=all_launches())

    # Each path's launch counts from zero, read right after its own run.
    for dtype, reqs in (("bfloat16", pairs),
                        ("float32", pairs[:F32_REQUESTS])):
        reset_launches()
        outs, lat, wall = serve_requests(services[dtype], reqs, CLIENTS)
        results[dtype] = dict(outs=np.stack(outs), lat=lat, wall=wall,
                              launches=all_launches())
    for svc in services.values():
        svc.close()
    batches = {dtype: check_launches(dtype, r["launches"])
               for dtype, r in results.items()}

    before = all_launches()
    refs = {}
    for dtype in ("float32", "bfloat16"):
        ref_svc = StylizeService(params, reference_config(dtype), size=SIZE,
                                 k=K, max_batch=MAX_BATCH, device=DEVICE)
        refs[dtype] = np.stack(serve_requests(ref_svc, pairs, CLIENTS)[0])
        ref_svc.close()
    if all_launches() != before:
        raise AssertionError("a reference service launched a kernel")
    for name, out in (*((f"{d} kernel path", r["outs"])
                        for d, r in results.items()),
                      *((f"{d} reference", o) for d, o in refs.items())):
        if out.shape[1:] != (SIZE, SIZE, 3) or not np.isfinite(out).all():
            raise AssertionError(f"{name}: output of shape {out.shape}, "
                                 "or not finite")

    ref32 = refs["float32"]
    got32 = results["float32"]["outs"]
    mae32 = float(np.abs(got32 - ref32[:F32_REQUESTS]).mean())
    mean32 = float(np.abs(ref32[:F32_REQUESTS]).mean())
    checks = {
        "bfloat16": bf16_noise_verdict(results["bfloat16"]["outs"],
                                       refs["bfloat16"], ref32),
        "float32": dict(mae_vs_f32=mae32, mae_tol=TOL_SLICE_MAE * mean32,
                        mean_abs_output=mean32,
                        max_abs_vs_f32=float(np.abs(
                            got32 - ref32[:F32_REQUESTS]).max())),
    }
    summary = {}
    for dtype, r in results.items():
        summary[dtype] = dict(
            requests=len(r["outs"]), clients=CLIENTS, batches=batches[dtype],
            imgs_per_s=len(r["outs"]) / r["wall"],
            p50_ms=float(np.median(r["lat"])) * 1e3,
            max_ms=float(np.max(r["lat"])) * 1e3,
            launches=r["launches"], launches_per_batch=PER_BATCH[dtype],
            **checks[dtype])
        emit("slice", dtype=dtype, size=SIZE, k=K, max_batch=MAX_BATCH,
             **summary[dtype])
    bf16 = checks["bfloat16"]
    if not bf16["noise_ratio"] <= TOL_BF16_NOISE:
        raise AssertionError(
            f"bfloat16 slice: MAE {bf16['mae_vs_f32']} against float32 is "
            f"{bf16['noise_ratio']} times the plain bf16 route's "
            f"{bf16['plain_mae_vs_f32']} (at most {TOL_BF16_NOISE})")
    if not mae32 <= TOL_SLICE_MAE * mean32:
        raise AssertionError(f"float32 slice MAE {mae32} > "
                             f"{TOL_SLICE_MAE * mean32}")
    return results["bfloat16"]["launches"], summary


def check_f32_entry(params, rng) -> None:
    """One float32 pair through make_stylize_fn, every ported kernel on, on
    the card under PyTorch's own TF32 defaults, against the same call on
    the CPU (plain versions, no TF32)."""
    cfg = slice_config("float32", True)
    c, s = (rng.random((1, F32_ENTRY_SIZE, F32_ENTRY_SIZE, 3),
                       dtype=np.float32) for _ in range(2))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    got = make_stylize_fn(cfg, k=K, device=DEVICE)(params, c, s).cpu().numpy()
    if (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) != flags:
        raise AssertionError("the float32 call left the TF32 flags changed")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    ref = make_stylize_fn(cfg, k=K, device="cpu")(cpu_params, c, s).numpy()
    mae = float(np.abs(got - ref).mean())
    ref_mean = float(np.abs(ref).mean())
    tol = TOL_SLICE_MAE * ref_mean
    emit("f32_entry", size=F32_ENTRY_SIZE, k=K, mae_vs_cpu=mae, mae_tol=tol,
         mean_abs_output=ref_mean,
         max_abs_vs_cpu=float(np.abs(got - ref).max()),
         tf32_flags_matmul_cudnn=list(flags))
    if not (np.isfinite(got).all() and mae <= tol):
        raise AssertionError(f"float32 entry point MAE {mae} > {tol}")


def stage_times(params, content: np.ndarray, style: np.ndarray) -> dict:
    """CUDA-event times (ms) of one batch-8 pair call at bf16, stage by
    stage, through the functions master_apply runs, with the kernels on,
    off, and as the reference service runs (kernels off, nine-conv
    decoder): host-to-device copies, the Swin pass of content and style
    together, the style transformer, the decoder, the device-to-host
    copy."""
    out = {}
    names = ("h2d", "swin", "style_transformer", "decoder", "d2h")
    dtype = torch.bfloat16
    for label, cfg in (("kernels_on", slice_config("bfloat16", True)),
                       ("kernels_off", slice_config("bfloat16", False)),
                       ("reference", reference_config("bfloat16"))):

        def once():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            c = torch.as_tensor(content, device=DEVICE)
            s = torch.as_tensor(style, device=DEVICE)
            ev[1].record()
            both = swin_backbone_apply(params["swin"],
                                       torch.cat([c, s]).to(dtype), cfg.swin)
            ev[2].record()
            fcs = style_transformer_apply(
                params["style_transformer"], both[:len(content)],
                both[len(content):], cfg.transformer, k=K)
            ev[3].record()
            rgb = cnn_decoder_apply(params["decoder"], fcs, cfg.decoder)
            ev[4].record()
            rgb.float().cpu()
            ev[5].record()
            torch.cuda.synchronize()
            return [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]

        with torch.inference_mode():
            once()
            runs = [once() for _ in range(3)]
        ms = {n: float(np.mean([r[i] for r in runs]))
              for i, n in enumerate(names)}
        ms["total"] = sum(ms.values())
        out[label] = ms
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; nothing run",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)

    fresh = not _build.BUILD_DIR.exists()
    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", from_scratch=fresh, seconds=built,
         wall_s=time.perf_counter() - t0, build_dir=_build.BUILD_DIR.name)

    gen = torch.Generator().manual_seed(0)
    rows = check_kernels(gen)

    params = init_master_model(slice_config("bfloat16", True), gen,
                               device=DEVICE)
    rng = np.random.default_rng(0)

    def pairs(n):
        return [(rng.random((SIZE, SIZE, 3), dtype=np.float32),
                 rng.random((SIZE, SIZE, 3), dtype=np.float32))
                for _ in range(n)]

    launches, _ = run_slice(params, pairs(REQUESTS))
    check_f32_entry(params, rng)
    batch = np.stack([p for pair in pairs(MAX_BATCH) for p in pair])
    emit("stages", dtype="bfloat16", batch=MAX_BATCH, size=SIZE, k=K,
         **stage_times(params, batch[0::2], batch[1::2]))

    # The main path is the bf16 slice: each entry's launches from its run,
    # its times summed over the calls of one request batch.
    kernels = []
    for entry, source, replaces, cases, per in (
            ("window_block_rows", "window_block.cu",
             "ops/pallas_attention.py:961", ("swin_stage1", "swin_stage2"),
             "the 4 Swin blocks of one 16-image pass"),
            ("window_block_windows", "window_block.cu",
             "ops/pallas_attention.py:1036",
             ("st_encoder_key", "st_decoder_self"),
             "the style transformer's Key and self blocks of one batch, k=1"),
            ("encoder_scale_shift", "style_block.cu",
             "ops/pallas_attention.py:1284", ("st_encoder",),
             "one call on one batch"),
            ("decoder_tail", "style_block.cu",
             "ops/pallas_attention.py:1386", ("st_decoder",),
             "one call on one batch"),
            ("stencil_phase_conv", "phase_conv.cu",
             "ops/pallas_conv.py:221",
             ("conv1", "conv2", "conv3", "conv4", "conv6"),
             "the decoder's five K5 convs of one batch"),
            ("stencil_phase2_conv_padcols", "phase_conv.cu",
             "ops/pallas_conv.py:499", ("conv7",),
             "conv7 of one batch (the path's K6 entry)"),
            ("phase_align", "phase_conv.cu", "ops/pallas_conv.py:80",
             ("conv5",), "conv5's realign of one batch")):
        mine = [r for r in rows if r["entry"] == entry
                and r["dtype"] == "bfloat16" and r["case"] in cases]
        lib_ms = [r["library_ms"] for r in mine]
        kernels.append(dict(
            name=entry, route="cuda",
            source=f"mastermetastyletransfer_tpu_torch/csrc/{source}",
            replaces=replaces, launches=launches[entry],
            launches_from="bfloat16 slice run",
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sum(r["ms"] for r in mine),
            plain_ms=sum(r["plain_ms"] for r in mine),
            bound_ms=sum(r["bound_ms"] for r in mine),
            bound_by=("operations" if sum(r["ops_ms"] for r in mine)
                      >= sum(r["bytes_ms"] for r in mine) else "bytes"),
            library_ms=(None if None in lib_ms else sum(lib_ms)),
            dtype="bfloat16", per=per,
            smem_bytes=max(r["smem_bytes"] for r in mine)))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
