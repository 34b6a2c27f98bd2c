"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only-train-grads   # the training gradient
                                               # checks alone, no result line

Builds the port's CUDA sources (csrc/ -> build/, one nvcc per source, side
by side, at first use), holds each kernel entry against its plain PyTorch
version at the shapes of the two slices, then drives them through their
entry points with weights drawn from seeded ``torch.Generator``s: pair
serving -- ``StylizeService`` -> ``master_apply`` at swin_B widths, 512x512
images, k=1, with the Swin, style-transformer and decoder kernels on,
then in the JAX package's round-5 configuration (the pair slice: each Swin
stage's two blocks as one K11 launch under MMST_BLOCK_PAIR=1, the RGB conv
through K12 with rgb_tail="l2k128") -- and the plain training step --
``make_train_step`` at 256x256, batch 8, bf16, k fixed at 1 and 4 and then
random in [1, 4], with K5, K7 and the training kernels K8-K10 on. One JSON
line per phase, flushed as it goes; any failed phase raises and the exit
code is not 0. The last line is {"ok": true, "device": {...}}; before it
come the card's name and power limit as nvidia-smi gives them, and the
kernel summary (K1-K13).

Phases: device, build; kernels (each entry against its plain version, with
ms per call, the bound and the share of it reached, the plain version's
ms and shared memory per block; ms is the card's time alone: a sleep
kernel ahead of each timed window lets the host queue every call first,
and the host's own ms per call is kept beside as host_ms): the four Swin
blocks of one pass (K1 row entry, K2 window entry),
the style transformer's K2 blocks (encoder Key block without norms, decoder
self block with both), K3 and K4 at the shapes of one request batch, and a
swin_S-width block (C=192, 6 heads), the decoder's stencil and align
kernels at the convs of one request batch (K5 at conv1-4 and conv6, K6 with
pad columns at conv7 and without them at the same shape, K7 at conv5; with
the time of one cuDNN conv of the same composed kernel and padded input as
the library yardstick, a conv without the align; for K1-K6, K11 and K12
the body that ran -- the tensor-core block body and its form at bf16 (K1,
K2 in both of the style transformer's forms, K11 per ticket), K3's and
K4's tensor-core bodies at bf16, the tensor-core stencil body's plan and
compiled table (K6 and K12 at f32 too, its FMA form), the scalar bodies
otherwise -- with its registers and static and dynamic shared memory);
stencil_shapes (K5 at the training step's five
convs, decoder input (8, 32, 32, 256), bf16 and f32, as at the serving
shapes); slice (the bf16 and f32
services, launches per path counted from zero just before each path's run,
each against the reference services: every kernel off and the decoder's
nine plain convs, so that the reference shares no phase algebra with
K5-K7); concurrent (two bf16 services, k=1 and k=3, serving the slice's
requests at once from client threads of their own, so that kernels launch
from two host threads at shared-memory sizes that differ: no request may
fail, and each output must equal bit for bit what the same service gave
alone); f32_entry (one float32 pair through ``make_stylize_fn`` on the card
against the same call on the CPU, with PyTorch's own TF32 settings);
stages (CUDA-event times of one batch-8 pair call at bf16 per stage,
kernels on, off, as the reference service runs, and in the pair slice's
configuration); slice_pair (the pair slice's bf16 and f32 services and a
bf16 one with _RGB_KERNEL_ON, which routes the RGB conv to K12's rgb entry,
their launches checked as the slice's, each against the slice's reference
outputs by the slice's criteria); the training
kernels (K8 at the Swin's two stages and the style transformer's shape, K9
in its two forms, K10 at the three row shapes with and without LN, each
forward and backward, bf16 and f32, against the plain forward and
torch.autograd of it, K8's, K9's and K10's rows with the body that ran
-- K10's and K8's and K9's tensor-core bodies, forward and backward, at
bf16 -- and its registers, local memory (spills) and shared memory; the
backward passes of K5 and K7 at the decoder's training shapes);
train_grads (the first step's gradients per parameter
group: f32 with every kernel on against the f32 route with every kernel
off, and the bf16 kernel path's error against the bf16 plain route's);
train_step (one line per step: k, loss, ms, imgs/s, peak memory, the
launches of each step checked against ``train_per_step``), train and a
stages line of the step (forward, backward, optimizer); then, from a
generator of their own, the kernels of the pair slice and K13: K11 at the
Swin's two stages (bf16, f32) and at C=192, K12's two entries at conv8
(bf16, f32; cuDNN's conv of the same composed kernel as the yardstick) and
their plain backward passes, K13 at the patch embedding of one 16-image
pass; refusals (K11 and K13 raise under autograd and launch nothing);
then, on the slice's weights with draws of their own, style-locked
serving: locked (``LockedStyleService`` with two locked styles at bf16,
k=1 and k=3, and at f32, k=1: the stream builds' launches and each k's
launches counted from zero and checked exactly against
``locked_per_stream`` and ``locked_per_batch``, the outputs held to the
reference services on the same contents paired with the locked style by
the slice's criteria, the f32 ones to the f32 kernel pair service too),
locked_blend (``blend_style_streams`` with weights [1, 0] decodes to its
first stream's output bit for bit), locked_stages (CUDA-event times of
one locked batch, stage by stage) and sweep (a ``SweepService`` over the
slice's weights and a second set: launches exactly two batches', each
set's output equal bit for bit to a run of that set alone). Last, on the
training phase's weights with draws of their own, the other training
modes at 256^2, bf16, batch 8: meta (``make_meta_train_step`` as the JAX
meta bench runs it, 4 inner updates, outer_lr 1e-4: 3 steps with the
kernels on and 3 off, per step imgs/s counting 4 x 8 images, ms, peak
memory, launches against the sum of ``train_per_step`` over its ks, the
frozen Swin bit for bit), meta_checks (one meta step per route at fixed
ks, stochastic depth off: Adam's first moments at f32 by grad_checks'
bound, at bf16 by its noise ratio; theta' within 2.5 x outer_lr x n x lr
plus the f32 spacing of theta', a sanity check only (an update of about lr
per element either way cannot break it); the bf16 step, with deterministic
algorithms (under PyTorch's defaults cuDNN's differ run to run), bit for
bit with its composition, clone, plain inner steps through the shared
Adam state, interpolation), adapt (``adapt_to_style`` with the JAX command line's
defaults: 20 steps, batch 4, lr 1e-4, one style, 8 contents: each step's
launches against ``adapt_per_step``, only the style encoder's leaves
changed), and remat and accum (3 steps at k = 1 and 3 at k = 2 against the
plain step from one generator seed; launches against ``remat_per_step``,
every forward entry twice, and ``accum_per_step``; the first step's
gradients, stochastic depth off, by grad_checks' criteria; remat leaves the
generator where the plain step does); the kernels line's training entries
carry each mode's launches. Last, the training entry point: trainer
(``trainer.main`` on folders of JPEG files written here by the port's
encoder, 16 contents at 640x480 and 4 styles at 1024x768 from a seed
(the styles staged at 6/8, the JAX loader's prescale), the contents
joined by a CMYK JPEG, an arithmetic-coded JPEG, an Adam7 PNG, a
palette BMP, a lossy WebP with alpha and a lossless WebP at 640x480
(``TRAINER_KINDS``), at the train
phase's configuration: plain for 6 iterations, resumed to 9, meta with 4 inner
updates for 2, fast adaptation at batch 4 for 3, checkpoints and dumps
every 3; one finite JSONL line per iteration, checkpoints 3, 6 and 9, the
resumed run at step 6 with Adam's count 6, its restored state equal to
checkpoint 6's files bit for bit and its first lr the schedule's at 6,
each iteration's launches exactly its step's table plus
``DUMP_PER_CALL`` at a dump, the dumps 256x256x3 and not constant; the
loader's ms a batch of contents, of styles and of the six new kinds,
whether the native loader built, the trainer's imgs/s beside the step
alone's); every kernel of the kernels line carries ``trainer_launches``.
The trainer's checkpoints are the JAX package's Orbax train-state
checkpoints, written and read without Orbax. Then orbax (the JAX-written
checkpoints of tests/data/orbax/, one in Orbax's OCDBT layout and one a
zarr directory per leaf with bfloat16 leaves, each leaf read to its
digest with 0 values differing, restored on the card, one step of its
mode at k = 1 with its launches exactly ``fixture_per_step`` and a finite
loss, written back and read bit for bit; the full-width state's save and
restore, their host ms and the checkpoint's MB); every kernel of the
kernels line carries ``orbax_launches``. Last, the
evaluation and weight entry points, on folders of BMP files written here
(11 contents at 640x480, 20 styles at 1024x768): eval
(``evaluate_grid``, the JAX command line's 220 pairs at 256^2, style
batch 8: f32 with the kernels on and off at k = 1
and 3, bf16 on and off at k = 1; each kernels-on grid's launches exactly
``eval_per_grid``, a stream build per style chunk and the decoder half
per (content, chunk); f32 on against off, each pair's losses within
TOL_EVAL_LOSS relative and the outputs by the slice's f32 criterion; bf16
by the noise ratio against the f32 kernels-off outputs; pairs/s and ms
per batched call), eval_cli (``eval.cli.main --use_pallas``: its launches,
its 220 JPEG dumps 256x256x3), adapt_cli (``adapt.main --use_pallas``, 20
steps of batch 4 at 256^2 under deterministic algorithms: each step's
launches ``adapt_per_step``, the stylize calls ``PER_BATCH``,
``adapted.npz`` equal bit for bit to ``adapt_to_style`` called directly),
convert (every ``convert_cli`` kind on full-width state dicts written with
``torch.save``: the .npz leaves exactly ``expected_leaves``; the grid from
the converted whole model's .npz equal bit for bit to the grid from the
same conversion in memory) and calibrate (``calibrate.main`` on a BMP
triplet with plain and BN VGG19 .pt files: the card's rows within
TOL_EVAL_LOSS relative of the CPU's, which TF32 would break); every
kernel of the kernels line carries ``eval_launches`` and
``adapt_cli_launches``. Last, the serving routes, with draws of their
own: codecs (the port's JPEG decoder on the eleven fixtures of
tests/data/jpeg/, four of them progressive, against Pillow's pixels stored
beside them, and its batch loader on two sources at one target per scale
n/8 against the JAX loader's stored batches; ``decode_image`` on the
fixtures of the other kinds Pillow reads -- tests/data/jpeg_kinds/
(arithmetic-coded, CMYK, YCCK, block-smoothed progressive, lossless),
tests/data/png/ (1- to 16-bit, Adam7), tests/data/bmp/ (palettes, RLE,
bit fields, core to V5 headers), tests/data/webp/ (lossy, lossless,
alpha, animations; the port's own decoder, native/webp.cpp) and
tests/data/{pnm,gif,tiff,ico,dib,tiff_ccitt,tga,pcx,dcx,qoi}/ (Netpbm,
GIF, TIFF in every compression read -- ThunderScan, old-style JPEG and
CIELab among them --, ICO, headerless BMP, TGA, PCX, DCX, QOI;
utils/pnm.py, native/gif.cpp, utils/tiff.py with native/tiff.cpp,
utils/ojpeg.py, utils/cms.py, utils/ico.py, utils/bmp.py, utils/tga.py,
utils/pcx.py, utils/qoi.py) --
against Pillow's stored pixels (the 640x480 timing inputs by digest), and
the batch loader on five sources of those kinds against the JAX loader's
batches (prescaled, or through its fallback for CMYK, YCCK and lossless):
0 values may differ; the host's ms of each of those decodes, and of the
new kinds at 640x480 (``kinds_640x480``; ``formats_640x480``: a GIF, an
LZW TIFF with predictor 2, a Deflate TIFF, a JPEG TIFF, a T.6, an LZMA
and a Zstandard TIFF, an RLE TGA, a ThunderScan, an old-style JPEG and a
CIELab TIFF, an RLE PCX, a DCX, a QOI, a raw and a plain PPM); the
host's ms of a progressive decode and of the
loader on 8 large 4:2:0 JPEGs, prescaled, against the full decode and
numpy resize; a seeded 512^2 image encoded at quality 95 and decoded: the
host's ms each way and the PSNR), split_route (``style_transformer_apply_windowed`` with
``fuse_iteration`` False, True and the kernels-off route at serving's
shape, 512^2 batch 8 + 8, bf16
and f32, and at the eval grid's, 256^2 batch 8, f32, k = 1 and 3: the
card's ms per route, each call's launches exactly ``split_per_call``, f32
within the slice's MAE of the f32 kernels-off route, bf16 by the noise
ratio; the locked split route's stream build and batch, bf16),
exclude_mlp (``master_apply`` with an exclude-MLP decoder at 512^2, k=1,
batch 8, bf16 and f32, kernels on against the reference by the slice's
criteria, launches exactly ``exclude_per_batch``; its split route at
f32), http (serve's services behind ``make_handler`` on a
``ThreadingHTTPServer`` at 127.0.0.1: 16 /stylize requests at k 1 and 3
from 4 clients (the contents JPEG, PNG, an LZW TIFF, a Zstandard TIFF,
an Adam7 PNG, two WebP and an RLE TGA), 4 /stylize_locked (one locked
style read from
a Deflate TIFF), 2 /sweep, /healthz, two bad bodies
answered 400; each run's launches exact; each reply the encoder's bytes on
its own service's output on the same decoded inputs, and decoded by the
port's decoder within TOL_JPEG95_MEAN levels of it; p50, max, imgs/s, the
codecs' ms a request); every kernel of the kernels line carries
``split_launches``, ``exclude_mlp_launches`` and ``http_launches``.
Last, the band-owned spatial path (parallel/), with draws of its own: K1
at a band's geometry in the kernels phase (the last of 4 bands of a
1024^2 pass of 4 images, window rows padded past the reference grid,
shift (0, 3) with the H-roll outside the kernel, the band's mask slab
with -1e9 keys outside the reference grid; stage-1 and stage-2 widths,
bf16 and f32), and K2-K4 on the last band of 2 and of 4 of the style
transformer's grid with the band's mask slabs; then spatial_single (the single-device master_apply at
1024^2, batch 2: the f32 reference route and bf16 with the kernels at k
1 and 3, the f32 kernels-off route at k 1; ms and peak memory) and
spatial (``make_spatial_stylize_shmap`` at 1024^2, batch 2, ModelConfig
defaults: one band in a world-1 NCCL group in this process at bf16 k 1
and 3 and f32 with the kernels off; 2 and 4 bands as ranks started by
parallel/launch.py that share the card over gloo, bf16 k 1 and f32 off;
2 and 4 bands over NCCL where there are that many cards (one each): each
rank's launches of
one call exactly ``spatial_per_call``, the bands put together held to
the single-device outputs, bf16 by the noise verdict, f32 within MAE
1e-4; ms of one call, each rank's peak memory and its halo messages and
bytes); every kernel of the kernels line carries ``spatial_launches``.
To run them alone on a machine with a card: ``python3 -c "import torch, chip_smoke as
cs; cs._build.build_all(); cs.band_block_cases(
torch.Generator().manual_seed(cs.SPATIAL_SEED + 1), []);
cs.run_spatial()"`` from the repo root.
Then data parallelism (train/step.py with a mesh), with draws of its own:
data_parallel_single (each mode at the training slice's shape, 256^2,
global batch 8, ModelConfig defaults, kernels on, bf16 and f32, on one
device: plain at k 1 and with k drawn, meta with 2 inner updates, fast
adaptation, accumulation 2; ms a step and peak memory) and data_parallel
(each mode on 2 and 4 ranks that share the card over gloo, and over NCCL
with a card a rank where there are the cards: each rank's launches of a
step exactly the one-device table, the same k, Adam's first moments
against the one-device step's, f32 by ``f32_verdict``, bf16 by
``bf16_verdict``, every rank's state bit-equal to rank 0's after every
step; per rank ms of a step, global imgs/s, peak memory, all-reduce ms
and MB a step, beside the one-device step's), data_parallel_trainer
(``trainer.train`` with num_devices 2 in two gloo ranks on the trainer
phase's folders, 3 iterations, against the one-device trainer) and
data_parallel_phase; every kernel of the kernels line carries
``data_parallel_launches``. To run them alone: ``python3 -c "import
chip_smoke as cs; cs._build.build_all(); cs.run_data_parallel()"``.

Needs only torch, numpy and the standard library, and one CUDA card (the
spatial and data-parallel phases' NCCL runs need a card per rank, and are
left out with one).

Tolerances, kernel against plain version, element by element. float32:
1e-4 of the largest magnitude of the plain output (order of sums).
bfloat16: two units in the last place of the plain output element (the two
sides round the same f32 value to bf16, and a value near a rounding
boundary may land on either side) plus 2^-6 of the largest update
|out - x| (an intermediate rounded to bf16 on the other side of a boundary
moves the update by about 2^-8 of itself); x is the block's input, K3's
Scale or Shift input, K4's Query; K11 as the block, x its input image; K13
with the update measured from 0. The decoder's stencil kernels and K12 at
bfloat16: two units in the last place plus 2^-8 of the largest |output|
(both sides sum the same products in f32 and round once); the phase align
exactly.
Slice, float32: the kernel-path service against the float32 reference
service, per-pixel MAE at most 1e-4 of the mean output magnitude; the same
1e-4 for the float32 entry point on the card against the CPU. Slice,
bfloat16: every bf16 route carries bf16 rounding noise through the whole
model, and its size against the output moves with the weight draw, so the
kernel path is held to the plain bf16 route on the same draw and pairs:
its per-pixel MAE against the float32 reference at most 1.5 times the
plain bf16 reference service's, over the whole image and, apart, over the
outermost column on each side, which K6's pad columns feed and where a
wrong pad slot shows while the whole-image ratio averages it away (the
edge ratio measured 0.84 on an H100 before K6's tensor-core form, and a
planted wrong slot gave 5.4).

The training kernels' gradients: at float32 1e-4 of the largest |grad| of
the tensor, at bfloat16 two units in the last place plus 2^-6 of it (the
forward outputs as the other per-window kernels, with the update measured
from 0 for K8/K9 and from x for K10); a projection bias is scaled by the
largest |grad| of all the projection biases, since the key bias's own
gradient is zero up to rounding. The training step: at float32, the
kernel path's first-step gradients within 1e-3 (relative max-abs per
parameter group) of the route with every kernel off; at bfloat16, its
relative L1 gradient error against that float32 route at most 1.5 times
the plain bf16 route's, per group (the slice's noise-ratio idea); every
loss finite.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings
import zlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mastermetastyletransfer_tpu_torch import adapt as adapt_cli
from mastermetastyletransfer_tpu_torch.adapt import adapt_to_style
from mastermetastyletransfer_tpu_torch.config import (
    AttentionConfig, DataConfig, ExperimentConfig, ModelConfig,
)
from mastermetastyletransfer_tpu_torch.data import repeat_style_to_batch
from mastermetastyletransfer_tpu_torch.data.native_loader import (
    decode_jpeg, decode_resize_batch, encode_jpeg, native_available,
)
from mastermetastyletransfer_tpu_torch.data.pipeline import (
    ImageFolderDataset, _decode_resize, decode_image, list_images,
)
from mastermetastyletransfer_tpu_torch.eval import cli as eval_cli
from mastermetastyletransfer_tpu_torch.eval import harness as eval_harness
from mastermetastyletransfer_tpu_torch.eval.harness import (
    evaluate_grid, load_eval_images,
)
from mastermetastyletransfer_tpu_torch.losses import calibrate
from mastermetastyletransfer_tpu_torch.losses.loss import perceptual_loss
from mastermetastyletransfer_tpu_torch.losses.vgg import init_vgg19_features
from mastermetastyletransfer_tpu_torch.models.decoder import (
    _channel_plan, cnn_decoder_apply,
)
from mastermetastyletransfer_tpu_torch.inference import blend_style_streams
from mastermetastyletransfer_tpu_torch.models.master import (
    _TF32_OFF, encode_features, init_master_model, make_stylize_fn,
    master_apply, stylize_with_style_stream,
)
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    init_style_swin_block, init_style_transformer,
    style_apply_windowed_from_stream, style_stream_windowed,
    style_transformer_apply, style_transformer_apply_from_stream,
    style_transformer_apply_windowed,
)
from mastermetastyletransfer_tpu_torch.models.swin import swin_backbone_apply
from mastermetastyletransfer_tpu_torch.ops import _build
from mastermetastyletransfer_tpu_torch.ops import block_pair as bpr
from mastermetastyletransfer_tpu_torch.ops import conv as tconv
from mastermetastyletransfer_tpu_torch.ops import ln_mlp as lm
from mastermetastyletransfer_tpu_torch.ops import patch_embed as tpe
from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc
from mastermetastyletransfer_tpu_torch.ops import style_block as sb
from mastermetastyletransfer_tpu_torch.ops import window_attention as wa
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from mastermetastyletransfer_tpu_torch.ops.attention import (
    init_dual_value_window_attention, init_window_attention,
)
from mastermetastyletransfer_tpu_torch.ops.mlp import init_mlp
from mastermetastyletransfer_tpu_torch.ops.windows import (
    effective_shift, shift_attention_mask, valid_token_mask, window_partition,
)
from mastermetastyletransfer_tpu_torch.parallel import (
    DataShard, all_reduce_mean, make_mesh, make_spatial_stylize_shmap,
    replicate,
)
from mastermetastyletransfer_tpu_torch.parallel import mesh as port_mesh
from mastermetastyletransfer_tpu_torch.parallel import spatial_shmap
from mastermetastyletransfer_tpu_torch.parallel.launch import spawn_ranks
from mastermetastyletransfer_tpu_torch.parallel.spatial import (
    gather_images_spatial, shard_images_spatial,
)
from mastermetastyletransfer_tpu_torch import serve
from mastermetastyletransfer_tpu_torch.serve import (
    LockedStyleService, StylizeService, SweepService,
)
from mastermetastyletransfer_tpu_torch.train import trainer
from mastermetastyletransfer_tpu_torch.train.schedule import make_lr_schedule
from mastermetastyletransfer_tpu_torch.train.state import (
    TrainState, create_train_state, to_pytree, trainable_labels,
)
from mastermetastyletransfer_tpu_torch.train.step import (
    _interp, _loss_views, _sample_k, make_loss_and_grad,
    make_meta_train_step, make_train_step, prepare_batch_for_model,
)
from mastermetastyletransfer_tpu_torch.utils import convert as tconvert
from mastermetastyletransfer_tpu_torch.utils import convert_cli
from mastermetastyletransfer_tpu_torch.utils import checkpoint as ckpt_lib
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    flatten_params, load_params_npz, tree_map,
)
from mastermetastyletransfer_tpu_torch.utils.orbax import read_pytree
from mastermetastyletransfer_tpu_torch.utils import png as port_png
from mastermetastyletransfer_tpu_torch.utils.png import png_bytes
from scripts.make_image_fixtures import bmp_file, bmp_rows, png_file

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL_F32 = 1e-4
TOL_BF16_ULPS, TOL_BF16_UPDATE = 2, 2.0 ** -6
TOL_SLICE_MAE = 1e-4
TOL_BF16_NOISE = 1.5
# The same ratio over the output's outermost column on each side (F6).
EDGE_COLS = 1
TOL_BF16_EDGE_NOISE = 1.5
TOL_CONV_BF16_SCALE = 2.0 ** -8
LAUNCHES = (wb.LAUNCHES, sb.LAUNCHES, pc.LAUNCHES, wa.LAUNCHES, lm.LAUNCHES,
            bpr.LAUNCHES, tpe.LAUNCHES)

DEVICE = "cuda"
SIZE, MAX_BATCH, K = 512, 8, 1
REQUESTS, CLIENTS = 16, 4
F32_REQUESTS = 4
F32_ENTRY_SIZE = 128
# Launches per request batch on each slice path (the main path is bf16).
DECODER_PER_BATCH = {"stencil_phase_conv": 5, "stencil_phase2_conv": 0,
                     "stencil_phase2_conv_padcols": 1, "phase_align": 1,
                     "stencil_phase2_rgb": 0, "stencil_phase2_rgb128": 0,
                     # serving runs no training kernel, and no path runs
                     # the patch-embed kernel (nor does the JAX package's)
                     **{e: 0 for e in (*wa.LAUNCHES, *lm.LAUNCHES,
                                       *tpe.LAUNCHES)}}
PER_BATCH = {
    "bfloat16": {"window_block_rows": 4, "window_block_windows": 2 * K,
                 "window_block_pair_rows": 0,
                 "encoder_scale_shift": K, "decoder_tail": K,
                 **DECODER_PER_BATCH},
    "float32": {"window_block_rows": 0, "window_block_windows": 4 + 2 * K,
                "window_block_pair_rows": 0,
                "encoder_scale_shift": K, "decoder_tail": K,
                **DECODER_PER_BATCH},
}
# The round-5 configuration (the pair slice): each Swin stage's two blocks
# as one K11 launch (MMST_BLOCK_PAIR=1), the RGB conv through K12's rgb128
# entry (rgb_tail="l2k128"), at either dtype; and the same with the JAX
# package's _RGB_KERNEL_ON, which routes the RGB conv to K12's rgb entry.
PAIR_PER_BATCH = {
    route: {**PER_BATCH["bfloat16"], "window_block_rows": 0,
            "window_block_windows": 2 * K, "window_block_pair_rows": 2,
            "stencil_phase2_rgb128": int(route != "rgb"),
            "stencil_phase2_rgb": int(route == "rgb")}
    for route in ("bfloat16", "float32", "rgb")}
ST_C, ST_HEADS = 256, 8
T0 = time.perf_counter()


def padded(n: int) -> int:
    """n tokens padded to the 7-token window."""
    return -(-n // 7) * 7


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase,
                      "elapsed_s": round(time.perf_counter() - T0, 3),
                      **fields}), flush=True)


SLEEP_CYCLES = 20_000_000  # ~10 ms of a sleep kernel ahead of the window


def cuda_times(fn, iters: int):
    """(device ms, host ms) per run of fn() over iters runs, after one
    warm-up run. A sleep kernel runs first, so that the host queues the
    runs while the card sleeps and the window holds the card's time alone,
    not the host's between launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters runs (cuda_times)."""
    return cuda_times(fn, iters)[0]


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
             cost, smem: int, check=None, library=None, phase="kernels",
             **meta) -> None:
    """Check kern() against plain() output by output, time both, and emit
    one line of ``phase``. ``check(got, ref)`` gives (max-abs error, error /
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
    ms, host_ms = cuda_times(kern, 5)
    plain_ms = cuda_ms(plain, 3)
    library_ms = cuda_ms(library, 5) if library is not None else None
    flops, nbytes = cost
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    row = dict(entry=entry, case=label, dtype=str(dtype).replace("torch.", ""),
               shape=list(xs[0].shape), max_abs_err=err,
               err_over_tol=err_over_tol, ms=ms, host_ms=host_ms,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_ops, t_bytes), ops_ms=t_ops, bytes_ms=t_bytes,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               share_of_bound=max(t_ops, t_bytes) / ms,
               gflop=flops / 1e9, mbytes=nbytes / 1e6, smem_bytes=smem,
               **meta)
    emit(phase, **row)
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
        plan = wb.block_plan(entry, 49, c, heads, 4 * c, dtype)
        attrs = {}
        if entry == "window_block_rows":
            x = x32.to(dtype).contiguous()
            kw.update(window=(7, 7), shift=(sh, sw))
            kern, plain = wb.window_block_rows, wb.window_block_rows_plain
            # the body that runs, its registers and shared memory after one
            # launch of this call
            kern(x, w, **kw)
            torch.cuda.synchronize()
            smem, dyn, regs = wb.kernel_attributes(plan, dtype, c // heads)
            attrs = dict(
                body=(f"window_tc{c // heads}_x{plan.blocks_per_sm}"
                      if plan.body == "tc" else "block_window"),
                registers=regs, smem_static=smem, smem_dynamic=dyn)
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
                 wb.smem_bytes(plan, 49, c, heads, dtype),
                 shift=[sh, sw], **attrs)


def body_attributes(plan, tc_name: str, scalar_name: str, launch,
                    attributes) -> dict:
    """The body a K2, K3, K4 or K11 call runs (its plan's) and its
    registers, static and dynamic shared memory, read after one launch of
    the call, so that the dynamic size is at least the call's own."""
    launch()
    torch.cuda.synchronize()
    smem, dyn, regs = attributes()
    return dict(body=tc_name if plan.body == "tc" else scalar_name,
                registers=regs, smem_static=smem, smem_dynamic=dyn)


def style_cases(gen, rows):
    """The style transformer's kernels at the shapes of one request batch:
    at 512^2, (8, 100, 49, 256) windows of the 64x64 token grid padded to
    70x70, shift (4, 4), 8 heads -- K2 as the encoder Key block (no norms)
    and as the decoder self block (both norms), K3 and K4."""
    dev = torch.device(DEVICE)
    grid = SIZE // 8
    pad = padded(grid)
    sh, sw = effective_shift(pad, pad, (7, 7), (4, 4))
    mask = torch.from_numpy(shift_attention_mask(pad, pad, 7, 7, sh, sw)
                            ).to(dev)
    padmask = torch.from_numpy(valid_token_mask(
        grid, grid, pad, pad, 7, 7, sh, sw)).to(dev)
    st_kernel_cases(gen, rows, b=MAX_BATCH, mask=mask, padmask=padmask,
                    labels=("st_encoder_key", "st_decoder_self",
                            "st_encoder", "st_decoder"))


def st_kernel_cases(gen, rows, *, b, mask, padmask, labels, **meta):
    """K2 as the encoder Key block (no norms) and as the decoder self block
    (both norms), K3 and K4, on (b, nW, 49, 256) windows with the given
    shift mask (nW, 49, 49) and validity mask (nW, 49), 8 heads, bf16 and
    f32; ``labels`` name the four cases, ``meta`` goes on each line."""
    dev = torch.device(DEVICE)
    nw, n, c, heads = mask.shape[0], 49, ST_C, ST_HEADS
    kw = dict(heads=heads, mask=mask, padmask=padmask)
    acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                           shift_size=(4, 4))
    block = init_style_swin_block(gen, acfg, use_norm=True, exclude_mlp=False,
                                  mlp_ratio=4.0)
    params = tree_map(lambda t: t.to(dev), {
        "block": block, "attn": init_window_attention(gen, acfg),
        "dual": init_dual_value_window_attention(gen, acfg),
        **{m: init_mlp(gen, c, 4 * c, init="xavier_uniform")
           for m in ("mlp_scale", "mlp_shift", "last_mlp")}})
    x32 = [torch.randn((b, nw, n, c), generator=gen).to(dev)
           for _ in range(5)]
    key_label, self_label, enc_label, tail_label = labels
    for dtype in (torch.bfloat16, torch.float32):
        xs = [x.to(dtype).contiguous() for x in x32]
        for label, use_norm in ((key_label, False), (self_label, True)):
            w = wb.block_weights(params["block"], (7, 7), dtype, use_norm)
            plan = wb.block_plan("window_block_windows", n, c, heads, 4 * c,
                                 dtype)
            run_case(rows, "window_block_windows", label, dtype,
                     lambda: [wb.window_block_windows(xs[0], w, **kw)],
                     lambda: [wb.window_block_windows_plain(xs[0], w, **kw)],
                     [xs[0]], block_cost(b, nw, n, c, heads, 4 * c, dtype,
                                         True, True),
                     wb.smem_bytes(plan, n, c, heads, dtype),
                     **body_attributes(
                         plan, f"window_tc{c // heads}_x{plan.blocks_per_sm}",
                         "block_window",
                         lambda: wb.window_block_windows(xs[0], w, **kw),
                         lambda: wb.kernel_attributes(
                             plan, dtype, c // heads,
                             "window_block_windows")), **meta)
        w = sb.encoder_weights(params["attn"], params["mlp_scale"],
                               params["mlp_shift"], None, (7, 7), dtype)
        plan = sb.style_plan(n, c, heads, 4 * c, dtype)
        run_case(rows, "encoder_scale_shift", enc_label, dtype,
                 lambda: sb.encoder_scale_shift(*xs[:3], w, **kw),
                 lambda: sb.encoder_scale_shift_plain(*xs[:3], w, **kw),
                 xs[1:3], style_cost("encoder_scale_shift", b, nw, n, c,
                                     heads, dtype, True, True),
                 sb.smem_bytes(n, c, heads, dtype, plan),
                 **body_attributes(
                     plan, f"style_tc{c // heads}", "encoder_scale_shift",
                     lambda: sb.encoder_scale_shift(*xs[:3], w, **kw),
                     lambda: sb.kernel_attributes(plan, dtype, c // heads)),
                 **meta)
        w = sb.decoder_tail_weights(params["dual"], params["last_mlp"],
                                    (7, 7), dtype)
        plan = sb.tail_plan(n, c, heads, 4 * c, dtype)
        run_case(rows, "decoder_tail", tail_label, dtype,
                 lambda: [sb.decoder_tail(*xs, w, **kw)],
                 lambda: [sb.decoder_tail_plain(*xs, w, **kw)],
                 [xs[4]], style_cost("decoder_tail", b, nw, n, c, heads,
                                     dtype, True, True),
                 sb.smem_bytes(n, c, heads, dtype, plan),
                 **body_attributes(
                     plan, f"tail_tc{c // heads}", "decoder_tail",
                     lambda: sb.decoder_tail(*xs, w, **kw),
                     lambda: sb.kernel_attributes(plan, dtype, c // heads,
                                                  "decoder_tail")), **meta)


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


def stencil_attributes(entry: str, dtype, pp: torch.Tensor,
                       table: pc.GroupTable, c_out: int, launch) -> dict:
    """The body one stencil or K12 call runs and its attributes: K5 at bf16,
    K6 and K12 the tensor-core body (its plan's instantiation; static and
    dynamic shared memory after one launch of this call, so the dynamic
    size is at least this call's own), K5 at f32 the scalar-FMA body."""
    b, hp, wp, cin = pp.shape
    if entry != "stencil_phase_conv" or dtype == torch.bfloat16:
        kind = ("stencil" if entry == "stencil_phase_conv"
                else "phase2" if entry.startswith("stencil_phase2_conv")
                else entry.replace("stencil_phase2_", ""))
        plan = pc.stencil_plan(table, kind, b, hp - 2, wp - 2, cin, c_out,
                               dtype)
        launch()
        torch.cuda.synchronize()
        kernel, extra = plan.kernel, dict(
            tile=list(plan.tile), bn=plan.bn, stage_k=plan.stage_k,
            blocks=plan.blocks, plan_smem_bytes=plan.smem_bytes)
    else:
        kernel, extra = "stencil", {}
    smem, dyn, regs = pc.kernel_attributes(kernel, dtype)
    return dict(smem=smem, smem_dynamic=dyn, registers=regs, body=kernel,
                **extra)


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

            attrs = stencil_attributes(entry, dtype, pp, table, c_out,
                                       lambda: kern_fn(*args))
            run_case(rows, entry, label, dtype,
                     lambda: [kern_fn(*args)], lambda: [plain_fn(*args)],
                     [pp], stencil_cost(pp, table, c_out,
                                        shape[0] * shape[1] * out_w
                                        * groups * c_out, pk.numel()),
                     check=conv_error, library=library, **attrs)
    # K7 at conv5: the realign of the (8, 129, 129, 4 x 64) conv output
    big32 = torch.randn((b, 2 * g0 + 1, 2 * g0 + 1, 256), generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        big = big32.to(dev, dtype).contiguous()
        nbytes = (big.numel() + b * 4 * g0 * g0 * 256) * big.element_size()
        smem, _, regs = pc.kernel_attributes("align", dtype)
        run_case(rows, "phase_align", "conv5", dtype,
                 lambda: [pc.phase_align(big, 64)],
                 lambda: [pc.phase_align_plain(big, 64)], [big],
                 (0, nbytes), smem, check=exact_error, registers=regs)


def grad_error(got: torch.Tensor, ref: torch.Tensor, scale: float, dtype):
    """A gradient's (max-abs error, largest error / tolerance): at float32
    1e-4 of ``scale``, at bfloat16 two units in the last place of the
    element plus 2^-6 of ``scale``; ``scale`` is the largest |grad| of the
    tensor (of all the projection biases for a bias, whose key bias has a
    zero gradient up to rounding)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if dtype == torch.float32:
        tol = TOL_F32 * scale
    else:
        ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
        tol = (TOL_BF16_ULPS * torch.where(ref == 0, 0.0, ulp)
               + TOL_BF16_UPDATE * scale)
    return err.max().item(), (err / tol).max().item()


def attention_cost(nv: int, backward: bool, b: int, nw: int, n: int, c: int,
                   heads: int, dtype):
    """(operations, bytes) of one K8 (nv 1) or K9 (nv 2) call. Per window,
    forward: the projections (K8 q, k, v and wp: 8 N C^2; K9 two value
    streams and wp twice: 8 N C^2) and the attention (2 N^2 C for q k^T and
    2 N^2 C per value stream). Backward, from the inputs: the forward's
    projections and scores again, dO per stream, o per stream (for dWp), dP,
    dq, dk, dv per stream, the input grads through W^T and the weight grads
    (K8 22 N C^2 + 12 N^2 C, K9 20 N C^2 + 14 N^2 C). Bytes: the window
    tensors read and written once, the weights, the bias and the mask; the
    weight grads written in f32."""
    win = b * nw
    if backward:
        per = ((22 * n * c * c + 12 * n * n * c) if nv == 1
               else (20 * n * c * c + 14 * n * n * c))
        tiles = (3 + 1 + 3) if nv == 1 else (4 + 2 + 4)
        mats = 4 if nv == 1 else 3
        out_f32 = mats * c * c + (mats + 1) * c + heads * n * n
    else:
        per = 8 * n * c * c + (2 + 2 * nv) * n * n * c
        tiles = 4 if nv == 1 else 6
        mats = 4 if nv == 1 else 3
        out_f32 = 0
    nbytes = (tiles * win * n * c * item_bytes(dtype)
              + mats * c * c * item_bytes(dtype)
              + (mats * c + heads * n * n + nw * n * n) * 4 + out_f32 * 4)
    return win * per, nbytes


def mlp_cost(backward: bool, rows: int, c: int, hidden: int, dtype,
             use_norm: bool):
    """(operations, bytes) of one K10 call: forward 4 rows C hidden
    (fc1, fc2); backward 10 rows C hidden (fc1 again, dz, dh, dW1, dW2).
    Bytes: x (and g, dx) once, the weights, the grads in f32."""
    mats = 2 * c * hidden
    vecs = hidden + c + (2 * c if use_norm else 0)
    if backward:
        return (10 * rows * c * hidden,
                3 * rows * c * item_bytes(dtype) + mats * item_bytes(dtype)
                + (mats + vecs) * 4 + vecs * 4)
    return (4 * rows * c * hidden,
            2 * rows * c * item_bytes(dtype) + mats * item_bytes(dtype)
            + vecs * 4)


def run_grad_case(rows: list, entry: str, label: str, dtype, *, leaves,
                  function, plain, grads_out, fwd_kernel, fwd_plain,
                  bwd_kernel, bwd_plain, residual, names, cost_fwd,
                  cost_bwd, smem_fwd, smem_bwd, attrs=None) -> None:
    """One training kernel: the kernel path (the autograd Function on CUDA
    tensors: the forward and the backward kernels) against the plain
    forward and torch.autograd of it, on the same inputs; then the times of
    the forward kernel, the backward kernel, the plain forward and the
    explicit plain backward. Emits one kernels line per direction, with
    ``attrs(backward)`` (the body that ran, read after its launches) where
    given."""
    kern = [t.detach().clone().requires_grad_() if t is not None else None
            for t in leaves]
    ref_in = [t.detach().clone().requires_grad_() if t is not None else None
              for t in leaves]
    got_out = function(*kern)
    ref_out = plain(*ref_in)
    got_out = got_out if isinstance(got_out, tuple) else (got_out,)
    ref_out = ref_out if isinstance(ref_out, tuple) else (ref_out,)
    live = [i for i, t in enumerate(kern) if t is not None]
    got = torch.autograd.grad(got_out, [kern[i] for i in live], grads_out)
    ref = torch.autograd.grad(ref_out, [ref_in[i] for i in live], grads_out)
    torch.cuda.synchronize()
    fwd_errs = [kernel_error(g, r, residual if residual is not None
                             else torch.zeros_like(r))
                for g, r in zip(got_out, ref_out)]
    vec = max([r.abs().max().item() for n, r in zip(names, ref)
               if n.startswith("b")] or [0.0])
    bwd_errs = [grad_error(g, r, vec if n.startswith("b") and vec
                           else r.float().abs().max().item(), dtype)
                for n, g, r in zip(names, got, ref)]
    for direction, errs in (("forward", fwd_errs), ("backward", bwd_errs)):
        worst = max(e[1] for e in errs)
        if not worst <= 1.0:
            raise AssertionError(f"{entry} {label} {dtype} {direction}: "
                                 f"error/tolerance {worst} > 1")
    del got, ref, got_out, ref_out, kern, ref_in
    with torch.no_grad():
        timed = {"fwd": cuda_ms(fwd_kernel, 5), "bwd": cuda_ms(bwd_kernel, 3),
                 "plain_fwd": cuda_ms(fwd_plain, 3),
                 "plain_bwd": cuda_ms(bwd_plain, 2)}
    for suffix, errs, cost, smem, ms, plain_ms in (
            ("", fwd_errs, cost_fwd, smem_fwd, timed["fwd"],
             timed["plain_fwd"]),
            ("_bwd", bwd_errs, cost_bwd, smem_bwd, timed["bwd"],
             timed["plain_bwd"])):
        flops, nbytes = cost
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        row = dict(entry=entry + suffix, case=label,
                   dtype=str(dtype).replace("torch.", ""),
                   shape=list(leaves[0].shape),
                   max_abs_err=max(e[0] for e in errs),
                   err_over_tol=max(e[1] for e in errs), ms=ms,
                   plain_ms=plain_ms, library_ms=None,
                   bound_ms=max(t_ops, t_bytes), ops_ms=t_ops,
                   bytes_ms=t_bytes,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   gflop=flops / 1e9, mbytes=nbytes / 1e6, smem_bytes=smem,
                   **(attrs(suffix == "_bwd") if attrs is not None else {}))
        emit("kernels", **row)
        rows.append(row)


# The training step's calls at 256^2, batch 8 content + 8 style: the Swin
# pass of 16 images (stage 1: 64x64 tokens padded to 70x70, 100 windows,
# C=128, 4 heads; stage 2: 32x32 -> 35x35, 25 windows, C=256, 8 heads) and
# the style transformer on the 8 contents (32x32 -> 25 windows, C=256).
TRAIN_SIZE, TRAIN_BATCH = 256, 8
ATTN_SHAPES = (("swin_stage1", 16, 100, 128, 4),
               ("swin_stage2", 16, 25, 256, 8),
               ("style_transformer", 8, 25, 256, 8))
MLP_SHAPES = (("swin_stage1", 16 * 64 * 64, 128, True),
              ("swin_stage2", 16 * 32 * 32, 256, True),
              ("st_ln", 8 * 32 * 32, 256, True),
              ("st", 8 * 32 * 32, 256, False))


def mlp_attributes(plan, dtype, backward: bool) -> dict:
    """The body a K10 call ran (its plan's) and its registers, local memory
    (spills) and static and dynamic shared memory."""
    smem, dyn, regs, local = lm.kernel_attributes(plan, dtype, backward)
    body = (f"mlp_tc_x{plan.blocks_per_sm}_kp{plan.kp}_s{plan.stages}"
            if plan.body == "tc" else "ln_mlp_scalar")
    return dict(body=body, registers=regs, local_bytes=local,
                smem_static=smem, smem_dynamic=dyn)


def attn_attributes(nv: int, n: int, c: int, heads: int, dtype,
                    backward: bool) -> dict:
    """The body a K8 (nv 1) or K9 (nv 2) call ran -- its direction's plan's
    -- and its registers, local memory (spills) and static and dynamic
    shared memory."""
    plan = (wa.attn_bwd_plan if backward else wa.attn_fwd_plan)(
        n, c, heads, nv, dtype)
    smem, dyn, regs, local = wa.kernel_attributes(plan, dtype, nv, backward)
    if plan.body == "tc":
        body = (f"attn_{'bwd_' if backward else 'fwd_'}tc_x"
                f"{plan.blocks_per_sm}_g{plan.panel}_kp{plan.kp}"
                f"_s{plan.stages}")
    else:
        body = "attn_bwd_scalar" if backward else "attn_fwd_scalar"
    return dict(body=body, registers=regs, local_bytes=local,
                smem_static=smem, smem_dynamic=dyn)


def train_kernel_cases(gen, rows):
    """K8 at the Swin's two stages and the style transformer's shape, K9 in
    both forms (separate wv_scale/wv_shift; one wv twice), K10 at the three
    row shapes with and without LN, each forward and backward at bf16 and
    f32, against the plain forward and autograd of it; the backward of K5
    and K7 (plain PyTorch) at the decoder's training shapes."""
    dev = torch.device(DEVICE)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    for dtype in (torch.bfloat16, torch.float32):
        for label, b, nw, c, heads in ATTN_SHAPES:
            grid = int(round(nw ** 0.5)) * 7
            sh = sw = 4 if label == "style_transformer" else 3
            mask = torch.from_numpy(shift_attention_mask(
                grid, grid, 7, 7, sh, sw)).to(dev)
            projs = [(randn((c, c), c ** -0.5), randn(c, 0.02))
                     for _ in range(4)]
            xs = [randn((b, nw, 49, c)).to(dtype) for _ in range(4)]
            bias = randn((heads, 49, 49), 0.02)
            g = [randn((b, nw, 49, c)).to(dtype) for _ in range(2)]
            w = [t for p in projs for t in p]
            pr = [wa.Proj(*p) for p in projs]
            run_grad_case(
                rows, "window_attention", label, dtype,
                leaves=xs[:3] + w + [bias],
                function=lambda *a: wa._WindowAttention.apply(
                    *a, mask, heads),
                plain=lambda q, k, v, *r: wa.window_attention_plain(
                    q, k, v, *(wa.Proj(r[i], r[i + 1]) for i in (0, 2, 4, 6)),
                    r[8], mask, heads),
                grads_out=g[0],
                fwd_kernel=lambda: wa.window_attention_fwd_kernel(
                    *xs[:3], *pr, bias, mask, heads),
                fwd_plain=lambda: wa.window_attention_plain(
                    *xs[:3], *pr, bias, mask, heads),
                bwd_kernel=lambda: wa.window_attention_bwd_kernel(
                    g[0], *xs[:3], *pr, bias, mask, heads),
                bwd_plain=lambda: wa.window_attention_bwd_plain(
                    g[0], *xs[:3], *pr, bias, mask, heads),
                residual=None,
                names=["q", "k", "v", "wq", "bq", "wk", "bk", "wv", "bv",
                       "wp", "bp", "rel_bias"],
                cost_fwd=attention_cost(1, False, b, nw, 49, c, heads,
                                        dtype),
                cost_bwd=attention_cost(1, True, b, nw, 49, c, heads, dtype),
                smem_fwd=wa.smem_bytes(49, c, heads, dtype, 1, False),
                smem_bwd=wa.smem_bytes(49, c, heads, dtype, 1, True),
                attrs=lambda bwd, c=c, heads=heads, dtype=dtype:
                    attn_attributes(1, 49, c, heads, dtype, bwd))
            if label != "style_transformer":
                continue
            # K9 with its own value projections (the decoder's form), and
            # with one wv used for both streams (the encoder's Scale/Shift
            # pair: autograd sums the two uses).
            for form, vprojs, names in (
                    ("st_dual", pr[:2], ["wvs", "bvs", "wvh", "bvh"]),
                    ("st_shared_wv", pr[:1], ["wv", "bv"])):
                dp = (list(vprojs) * (2 if len(vprojs) == 1 else 1)
                      + [pr[3]])
                vw = [t for p in vprojs for t in p]
                nvw = len(vw)

                def dual_fn(q, k, vs, vh, *r, nvw=nvw):
                    vws = list(r[:nvw]) * (4 // nvw)
                    return wa._WindowAttentionDual.apply(
                        q, k, vs, vh, *vws, *r[nvw:], mask, heads)

                def dual_plain(q, k, vs, vh, *r, nvw=nvw):
                    vws = list(r[:nvw]) * (4 // nvw)
                    return wa.window_attention_dual_plain(
                        q, k, vs, vh, wa.Proj(vws[0], vws[1]),
                        wa.Proj(vws[2], vws[3]), wa.Proj(r[nvw], r[nvw + 1]),
                        r[nvw + 2], mask, heads)

                run_grad_case(
                    rows, "window_attention_dual", form, dtype,
                    leaves=xs + vw + list(pr[3]) + [bias],
                    function=dual_fn, plain=dual_plain, grads_out=tuple(g),
                    fwd_kernel=lambda dp=dp:
                        wa.window_attention_dual_fwd_kernel(
                            *xs, *dp, bias, mask, heads),
                    fwd_plain=lambda dp=dp: wa.window_attention_dual_plain(
                        *xs, *dp, bias, mask, heads),
                    bwd_kernel=lambda dp=dp:
                        wa.window_attention_dual_bwd_kernel(
                            *g, *xs, *dp, bias, mask, heads),
                    bwd_plain=lambda dp=dp:
                        wa.window_attention_dual_bwd_plain(
                            *g, *xs, *dp, bias, mask, heads),
                    residual=None,
                    names=["q", "k", "vs", "vh"] + names
                    + ["wp", "bp", "rel_bias"],
                    cost_fwd=attention_cost(2, False, b, nw, 49, c, heads,
                                            dtype),
                    cost_bwd=attention_cost(2, True, b, nw, 49, c, heads,
                                            dtype),
                    smem_fwd=wa.smem_bytes(49, c, heads, dtype, 2, False),
                    smem_bwd=wa.smem_bytes(49, c, heads, dtype, 2, True),
                    attrs=lambda bwd, c=c, heads=heads, dtype=dtype:
                        attn_attributes(2, 49, c, heads, dtype, bwd))
        for label, nrows, c, use_norm in MLP_SHAPES:
            hidden = 4 * c
            plans = {b: lm.mlp_plan(nrows, c, hidden, b, dtype)
                     for b in (False, True)}
            x = randn((nrows, c)).to(dtype)
            gy = randn((nrows, c)).to(dtype)
            w = [randn((c, hidden), c ** -0.5), randn(hidden, 0.02),
                 randn((hidden, c), hidden ** -0.5), randn(c, 0.02)]
            norm = ([1 + randn(c, 0.1), randn(c, 0.1)] if use_norm
                    else [None, None])
            run_grad_case(
                rows, "ln_mlp_residual", label + ("" if use_norm else
                                                  "_no_ln"), dtype,
                leaves=[x] + w + norm,
                function=lambda *a: lm._LnMlpResidual.apply(*a),
                plain=lm.ln_mlp_residual_plain, grads_out=gy,
                fwd_kernel=lambda: lm.ln_mlp_residual_fwd_kernel(
                    x, *w, *norm),
                fwd_plain=lambda: lm.ln_mlp_residual_plain(x, *w, *norm),
                bwd_kernel=lambda: lm.ln_mlp_residual_bwd_kernel(
                    gy, x, w[0], w[1], w[2], *norm),
                bwd_plain=lambda: lm.ln_mlp_residual_bwd_plain(
                    gy, x, w[0], w[1], w[2], *norm),
                residual=x,
                names=["x", "w1", "b1", "w2", "b2", "ns", "nb"][
                    :5 + 2 * use_norm],
                cost_fwd=mlp_cost(False, nrows, c, hidden, dtype, use_norm),
                cost_bwd=mlp_cost(True, nrows, c, hidden, dtype, use_norm),
                smem_fwd=lm.smem_bytes(plans[False], c, hidden, dtype,
                                       False),
                smem_bwd=lm.smem_bytes(plans[True], c, hidden, dtype, True),
                attrs=lambda b, plans=plans, dtype=dtype: mlp_attributes(
                    plans[b], dtype, b))
    decoder_backward_cases(gen, rows)


def decoder_backward_cases(gen, rows):
    """The backward passes of K5 (conv1-4, conv6) and K7 (conv5, conv7) at
    the training step's shapes (decoder input (8, 32, 32, 256)): the
    Function's gradients (the kernel forward, the plain backward) against
    autograd of the plain forward, bf16 and f32 (TF32 off), with the time of
    the backward alone."""
    dev = torch.device(DEVICE)
    b, g0 = TRAIN_BATCH, TRAIN_SIZE // 8
    convs = (("conv1", (b, g0, g0, 128), 128, 128, "up"),
             ("conv2", (b, g0, g0, 512), 128, 128, "l1"),
             ("conv3", (b, g0, g0, 512), 128, 128, "l1"),
             ("conv4", (b, g0, g0, 512), 128, 64, "l1"),
             ("conv6", (b, 2 * g0, 2 * g0, 256), 64, 32, "l1"))
    for dtype in (torch.bfloat16, torch.float32):
        ctx = _TF32_OFF if dtype == torch.float32 else contextlib.nullcontext()
        with ctx:
            for label, shape, cin, c_out, form in convs:
                w3 = tconv.init_conv(gen, cin, c_out)["kernel"]
                if form == "up":
                    pk, table = tconv._phase_kernel(w3), tconv._UPSAMPLE_TABLE
                else:
                    pk = tconv._phase_space_kernel(w3)
                    table = tconv._phase_space_table()
                x = torch.randn(shape, generator=gen)
                pp = tconv._edge_pad(x).to(dev, dtype).contiguous()
                pk = pk.to(dev, dtype).contiguous()
                bias = (torch.randn(4 * c_out, generator=gen) * 0.1).to(dev)
                gy = torch.randn((*shape[:3], 4 * c_out),
                                 generator=gen).to(dev, dtype)
                decoder_bwd_case(rows, "stencil_phase_conv", label, dtype,
                                 [pp, pk, bias],
                                 lambda a, b_, c: pc.stencil_phase_conv(
                                     a, b_, c, table),
                                 lambda a, b_, c: pc.stencil_phase_conv_plain(
                                     a, b_, c, table, relu=False), gy,
                                 relu=True)
            for label, hw, c_out in (("conv5", 2 * g0, 64),
                                     ("conv7", 4 * g0, 32)):
                big = torch.randn((b, hw + 1, hw + 1, 4 * c_out),
                                  generator=gen).to(dev, dtype)
                gy = torch.randn((b, hw, hw, 4 * c_out),
                                 generator=gen).to(dev, dtype)
                decoder_bwd_case(rows, "phase_align", label, dtype, [big],
                                 lambda a, c_out=c_out: pc.phase_align(
                                     a, c_out),
                                 lambda a, c_out=c_out: pc.phase_align_plain(
                                     a, c_out), gy)


def stencil_shape_cases(gen, rows):
    """K5 forward at the training step's five conv shapes (decoder input
    (8, 32, 32, 256): conv1-4 on a 32^2 coarse grid, conv6 on 64^2), bf16
    and f32, against the plain version, timed: the tensor-core body's tiles
    at the grids the training slice gives it. Inputs and weights random;
    the library yardstick as at the serving shapes."""
    dev = torch.device(DEVICE)
    b, g0 = TRAIN_BATCH, TRAIN_SIZE // 8
    convs = (("conv1", (b, g0, g0, 128), 128, 128, "up"),
             ("conv2", (b, g0, g0, 512), 128, 128, "l1"),
             ("conv3", (b, g0, g0, 512), 128, 128, "l1"),
             ("conv4", (b, g0, g0, 512), 128, 64, "l1"),
             ("conv6", (b, 2 * g0, 2 * g0, 256), 64, 32, "l1"))
    for label, shape, cin, c_out, form in convs:
        w3 = tconv.init_conv(gen, cin, c_out)["kernel"]
        bias = (torch.randn(c_out, generator=gen) * 0.1).repeat(4).to(dev)
        x32 = torch.randn(shape, generator=gen)
        if form == "up":
            pk32, table = tconv._phase_kernel(w3), tconv._UPSAMPLE_TABLE
        else:
            pk32 = tconv._phase_space_kernel(w3)
            table = tconv._phase_space_table()
        for dtype in (torch.bfloat16, torch.float32):
            pp = tconv._edge_pad(x32).to(dev, dtype).contiguous()
            pk = pk32.to(dev, dtype).contiguous()
            args = (pp, pk, bias, table)
            w_lib = pk.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            x_lib, b_lib = pp.permute(0, 3, 1, 2), bias.to(dtype)

            def library():
                with (_TF32_OFF if dtype == torch.float32
                      else contextlib.nullcontext()):
                    return F.conv2d(x_lib, w_lib, b_lib)

            attrs = stencil_attributes("stencil_phase_conv", dtype, pp,
                                       table, c_out,
                                       lambda: pc.stencil_phase_conv(*args))
            run_case(rows, "stencil_phase_conv", label, dtype,
                     lambda: [pc.stencil_phase_conv(*args)],
                     lambda: [pc.stencil_phase_conv_plain(*args)], [pp],
                     stencil_cost(pp, table, c_out,
                                  shape[0] * shape[1] * shape[2] * 4 * c_out,
                                  pk.numel()),
                     check=conv_error, library=library,
                     phase="stencil_shapes", **attrs)


def decoder_bwd_case(rows, entry, label, dtype, leaves, function, plain, gy,
                     relu=False):
    """The Function's gradients against autograd of the plain forward. With
    ``relu`` the plain forward is the conv without its ReLU, fed the
    cotangent masked by the kernel's own output (y > 0): where the two
    forwards round an output of nearly 0 to opposite signs the ReLU routes
    the gradient differently, which is no error of the backward (at f32 a
    few such outputs come in every 2 million)."""
    kern = [t.detach().clone().requires_grad_() for t in leaves]
    out = function(*kern)
    got = torch.autograd.grad(out, kern, gy, retain_graph=True)
    ref_in = [t.detach().clone().requires_grad_() for t in leaves]
    g_ref = gy * (out.detach() > 0).to(gy.dtype) if relu else gy
    ref = torch.autograd.grad(plain(*ref_in), ref_in, g_ref)
    torch.cuda.synchronize()
    errs = [grad_error(g, r, r.float().abs().max().item(), dtype)
            for g, r in zip(got, ref)]
    worst = max(e[1] for e in errs)
    if not worst <= 1.0:
        raise AssertionError(f"{entry} {label} {dtype} backward: "
                             f"error/tolerance {worst} > 1")

    def backward():
        torch.autograd.grad(out, kern, gy, retain_graph=True)

    def plain_backward():
        torch.autograd.grad(ref_out, ref_in, gy, retain_graph=True)

    ref_out = plain(*ref_in)
    row = dict(entry=entry + "_bwd", case=label,
               dtype=str(dtype).replace("torch.", ""),
               shape=list(leaves[0].shape),
               max_abs_err=max(e[0] for e in errs), err_over_tol=worst,
               ms=cuda_ms(backward, 3), plain_ms=cuda_ms(plain_backward, 3),
               route="plain PyTorch (the JAX package's backward is plain "
                     "XLA)")
    emit("kernels", **row)
    rows.append(row)


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


def band_block_cases(gen, rows):
    """K1-K4 at a band's geometry, as the band-owned spatial path launches
    them. K1: the last of 4 bands of the spatial phase's 1024^2 pass (2 x
    SPATIAL_BATCH images), whose window rows run past the reference grid
    (the band grid pads the window-row count to a multiple of 4: 37 -> 40
    at stage 1, 19 -> 20 at stage 2), shift (0, 3) with the H-roll done
    outside the kernel, and the band's slab of the shift mask, whose keys
    outside the reference grid carry -1e9 (spatial_shmap._build_aux); at
    stage-1 and stage-2 widths, bf16 and f32. K2 (the Key block without
    norms, the self block with them), K3 and K4: the last band of 2 and of
    4 of the style transformer's grid (128x128 tokens, 19 window rows
    padded to 20: (SPATIAL_BATCH, 190 or 95, 49, 256) windows), the band's
    slabs of the shift mask (-1e9 keys outside the reference grid) and of
    the validity mask, bf16 and f32 (st_kernel_cases)."""
    dev = torch.device(DEVICE)
    n, index = 4, 3
    cfg = ModelConfig()
    aux, meta = spatial_shmap._build_aux(SPATIAL_SIZE, SPATIAL_SIZE, cfg, n,
                                         index, dev)
    for stage, (c, heads) in enumerate(((128, 4), (256, 8))):
        g = meta[f"s{stage}"]
        mask, padmask = aux[f"s{stage}_mask"], aux[f"s{stage}_pm1"]
        if not (g["nwh_pad"] > -(-g["hs"] // 7)
                and mask.min().item() <= -1e9 and g["sh"] and g["sw"]):
            raise AssertionError(f"stage {stage + 1}: the band case lacks "
                                 "its padded rows or refgrid keys")
        acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                               shift_size=(3, 3))
        params = tree_map(lambda t: t.to(dev), init_style_swin_block(
            gen, acfg, use_norm=True, exclude_mlp=False, mlp_ratio=4.0))
        b = 2 * SPATIAL_BATCH
        x32 = torch.randn((b, g["rows_loc"], g["Wp"], c), generator=gen)
        nw = mask.shape[0]
        for dtype in (torch.bfloat16, torch.float32):
            w = wb.block_weights(params, (7, 7), dtype, use_norm=True)
            x = x32.to(dev, dtype).contiguous()
            kw = dict(heads=heads, window=(7, 7), shift=(0, g["sw"]),
                      mask=mask, padmask=padmask)
            plan = wb.block_plan("window_block_rows", 49, c, heads, 4 * c,
                                 dtype)
            run_case(rows, "window_block_rows", f"band_stage{stage + 1}",
                     dtype, lambda: [wb.window_block_rows(x, w, **kw)],
                     lambda: [wb.window_block_rows_plain(x, w, **kw)], [x],
                     block_cost(b, nw, 49, c, heads, 4 * c, dtype, True,
                                True),
                     wb.smem_bytes(plan, 49, c, heads, dtype),
                     shift=[0, g["sw"]], band=f"{index + 1} of {n}",
                     window_rows=[g["nwh_pad"], -(-g["hs"] // 7)])
    band_st_cases(gen, rows)


def band_st_cases(gen, rows):
    """K2-K4 on the last band of 2 and of 4 of the style transformer's
    grid at the spatial phase's 1024^2, with the band's mask slabs (see
    band_block_cases)."""
    dev = torch.device(DEVICE)
    cfg = ModelConfig()
    for n in (2, 4):
        index = n - 1
        aux, meta = spatial_shmap._build_aux(SPATIAL_SIZE, SPATIAL_SIZE, cfg,
                                             n, index, dev)
        g = meta["st"]
        mask, padmask = aux["st_mask"], aux["st_pm"]
        if not (g["nwh_pad"] > -(-g["hs"] // 7)
                and mask.min().item() <= -1e9 and g["sh"] and g["sw"]):
            raise AssertionError(f"style transformer, band {n} of {n}: the "
                                 "band case lacks its padded rows or "
                                 "refgrid keys")
        st_kernel_cases(gen, rows, b=SPATIAL_BATCH, mask=mask,
                        padmask=padmask,
                        labels=tuple(f"band{n}_{label}" for label in (
                            "st_encoder_key", "st_decoder_self",
                            "st_encoder", "st_decoder")),
                        band=f"{index + 1} of {n}",
                        window_rows=[g["nwh_pad"], -(-g["hs"] // 7)])


def pair_cases(gen, rows):
    """K11 at the Swin stages of one request batch's pass (2 x max_batch
    images; stage 1 on 133x133 padded tokens of which 128 are valid, C=128,
    4 heads; stage 2 on 70x70 of 64, C=256, 8 heads; shift 3), bf16 and
    f32, and a swin_S-width stage 2 (C=192, 6 heads) at bf16, against the
    plain version (K1's applied twice). Bytes: the image read once and
    written once, both blocks' weights and masks (block 0's output is no
    part of the function)."""
    dev = torch.device(DEVICE)
    bf16, f32 = torch.bfloat16, torch.float32
    b = 2 * MAX_BATCH
    for label, c, heads, valid, dtypes in (
            ("swin_stage1", 128, 4, SIZE // 4, (bf16, f32)),
            ("swin_stage2", 256, 8, SIZE // 8, (bf16, f32)),
            ("swin_S_stage2", 192, 6, SIZE // 8, (bf16,))):
        hp = padded(valid)
        nw = (hp // 7) ** 2
        sh, sw = effective_shift(hp, hp, (7, 7), (3, 3))
        blocks = [tree_map(lambda t: t.to(dev), init_style_swin_block(
            gen, AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                                 shift_size=shift),
            use_norm=True, exclude_mlp=False, mlp_ratio=4.0))
            for shift in ((0, 0), (sh, sw))]
        kw = dict(heads=heads, window=(7, 7), shift=(sh, sw),
                  mask1=torch.from_numpy(shift_attention_mask(
                      hp, hp, 7, 7, sh, sw)).to(dev),
                  padmask0=torch.from_numpy(valid_token_mask(
                      valid, valid, hp, hp, 7, 7, 0, 0)).to(dev),
                  padmask1=torch.from_numpy(valid_token_mask(
                      valid, valid, hp, hp, 7, 7, sh, sw)).to(dev))
        x32 = torch.randn((b, hp, hp, c), generator=gen).to(dev)
        for dtype in dtypes:
            w0, w1 = (wb.block_weights(p, (7, 7), dtype, use_norm=True)
                      for p in blocks)
            x = x32.to(dtype).contiguous()
            f0, b0 = block_cost(b, nw, 49, c, heads, 4 * c, dtype, False,
                                True)
            f1, b1 = block_cost(b, nw, 49, c, heads, 4 * c, dtype, True,
                                True)
            plan = bpr.pair_plan(49, c, heads, 4 * c, dtype)
            run_case(rows, "window_block_pair_rows", label, dtype,
                     lambda: [bpr.window_block_pair_rows(x, w0, w1, **kw)],
                     lambda: [bpr.window_block_pair_rows_plain(x, w0, w1,
                                                               **kw)],
                     [x], (f0 + f1, b0 + b1 - 2 * b * nw * 49 * c
                           * item_bytes(dtype)),
                     bpr.smem_bytes(plan, 49, c, heads, dtype),
                     shift=[sh, sw],
                     **body_attributes(
                         plan,
                         f"window_tc{c // heads}_x{plan.blocks_per_sm}",
                         "block_window",
                         lambda: bpr.window_block_pair_rows(x, w0, w1, **kw),
                         lambda: bpr.kernel_attributes(plan, dtype,
                                                       c // heads)))


def rgb_cases(gen, rows):
    """K12 at conv8 of one request batch: the L2 tail's padded input (8,
    130, 130, 16 x 32) and conv8's composed kernel (2, 2, 512, 16 x 3), with
    the L2 table the decoder passes; the rgb entry (the fine grid (8, 512,
    512, 3)) and the rgb128 entry (the kernel and bias in 8-lane slots,
    (8, 128, 128, 128)), bf16 and f32, against the plain versions; the
    library yardstick one cuDNN conv of the same composed kernel over the
    same input with bias (no align). Then both entries' backward passes
    (plain PyTorch, as the JAX package's are plain XLA) against autograd of
    the plain forward."""
    dev = torch.device(DEVICE)
    g0 = SIZE // 8
    x32 = torch.randn((MAX_BATCH, 2 * g0, 2 * g0, 16 * 32), generator=gen)
    w3 = tconv.init_conv(gen, 32, 3)["kernel"]
    bias = torch.randn(3, generator=gen) * 0.1
    k2, bases = tconv._phase2_kernel(w3, False)
    table = tconv._phase2_table(False)
    pp32 = tconv._phase2_pad(x32, 4, 32, False)
    for dtype in (torch.bfloat16, torch.float32):
        pp = pp32.to(dev, dtype).contiguous()
        for entry, kind in (("stencil_phase2_rgb", "rgb"),
                            ("stencil_phase2_rgb128", "rgb128")):
            if kind == "rgb":
                pk = k2.to(dev, dtype).contiguous()
                bias_n = bias.repeat(16).to(dev).contiguous()
                cg, out_numel = 3, MAX_BATCH * SIZE * SIZE * 3
            else:
                pk = tconv._slots128(k2.to(dtype), 3).to(dev).contiguous()
                bias_n = tconv._slots128(bias.repeat(16), 3).to(
                    dtype).float().to(dev)
                cg, out_numel = 8, MAX_BATCH * (2 * g0) ** 2 * 128
            args = (pp, pk, bias_n, bases)
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

            attrs = stencil_attributes(entry, dtype, pp, table, cg,
                                       lambda: kern_fn(*args, table=table))
            run_case(rows, entry, "conv8", dtype,
                     lambda: [kern_fn(*args, table=table)],
                     lambda: [plain_fn(*args)], [pp],
                     stencil_cost(pp, table, cg, out_numel, pk.numel()),
                     check=conv_error, library=library, **attrs)
            gy = torch.randn(((MAX_BATCH, SIZE, SIZE, 3) if kind == "rgb"
                              else (MAX_BATCH, 2 * g0, 2 * g0, 128)),
                             generator=gen).to(dev, dtype)
            with (_TF32_OFF if dtype == torch.float32
                  else contextlib.nullcontext()):
                decoder_bwd_case(
                    rows, entry, "conv8", dtype, [pp, pk, bias_n],
                    lambda a, b_, c, kern_fn=kern_fn: kern_fn(
                        a, b_, c, bases, table=table),
                    lambda a, b_, c, plain_fn=plain_fn: plain_fn(
                        a, b_, c, bases), gy)


def patch_embed_cases(gen, rows):
    """K13 at the Swin's patch embedding of one request batch's pass: (16,
    512, 512, 3) images into (16, 128, 128, 128) with the LayerNorm, bf16
    and f32, against the plain version; at bf16 two units in the last place
    plus 2^-6 of the largest |output|. No path calls the kernel (nor does
    the JAX package's)."""
    dev = torch.device(DEVICE)
    b, e = 2 * MAX_BATCH, 128
    img32 = torch.rand((b, SIZE, SIZE, 3), generator=gen)
    k = (torch.randn((4, 4, 3, e), generator=gen) * 48 ** -0.5).to(dev)
    vecs = [(torch.randn(e, generator=gen) * 0.02).to(dev),
            (1 + 0.1 * torch.randn(e, generator=gen)).to(dev),
            (0.1 * torch.randn(e, generator=gen)).to(dev)]
    hc = SIZE // 4
    for dtype in (torch.bfloat16, torch.float32):
        img = img32.to(dev, dtype).contiguous()
        args = (img, k, *vecs)
        flops = 2 * b * hc * hc * 48 * e + 8 * b * hc * hc * e
        nbytes = ((img.numel() + b * hc * hc * e + 48 * e)
                  * item_bytes(dtype) + 3 * e * 4)
        run_case(rows, "patch_embed", "swin_patch_embed", dtype,
                 lambda: [tpe.patch_embed(*args)],
                 lambda: [tpe.patch_embed_plain(*args)], [img],
                 (flops, nbytes), tpe.smem_bytes(4, 3, e),
                 check=lambda g, r: kernel_error(g, r, torch.zeros_like(r)))


def refusal_checks() -> None:
    """K11 and K13 are evaluation kernels with no backward (neither has a
    VJP in JAX): on the card, an input that requires grad under grad mode
    makes the wrapper raise and launch nothing; under no_grad it launches
    (the check the other evaluation kernels pass, F4)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(2)
    block = tree_map(lambda t: t.to(dev), init_style_swin_block(
        gen, AttentionConfig(dim=128, num_heads=4, window_size=(7, 7),
                             shift_size=(3, 3)),
        use_norm=True, exclude_mlp=False, mlp_ratio=4.0))
    w = wb.block_weights(block, (7, 7), torch.float32, use_norm=True)
    x = torch.randn((1, 14, 14, 128), generator=gen).to(dev)
    img = torch.rand((1, 16, 16, 3), generator=gen).to(dev)
    k = torch.randn((4, 4, 3, 128), generator=gen).to(dev)
    calls = {
        "window_block_pair_rows": (bpr.LAUNCHES, x, lambda t: (
            bpr.window_block_pair_rows(t, w, w, heads=4, window=(7, 7),
                                       shift=(3, 3)))),
        "patch_embed": (tpe.LAUNCHES, k, lambda t: tpe.patch_embed(
            img, t, torch.zeros(128, device=dev)))}
    for entry, (counts, leaf, call) in calls.items():
        before = counts[entry]
        try:
            call(leaf.clone().requires_grad_())
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{entry} ran under autograd")
        if counts[entry] != before:
            raise AssertionError(f"{entry} launched under autograd")
        with torch.no_grad():
            call(leaf)
        torch.cuda.synchronize()
        if counts[entry] != before + 1:
            raise AssertionError(f"{entry} did not launch under no_grad")
    emit("refusals", entries=list(calls), raised_under_autograd=True,
         launched_under_no_grad=True)


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


def edge_columns(img: np.ndarray) -> np.ndarray:
    """The outermost EDGE_COLS columns on each side of (N, H, W, 3) images:
    the output columns that K6's pad columns feed (conv8's 3x3 window past
    the image's edge reads the pad slot next to it)."""
    return np.concatenate([img[:, :, :EDGE_COLS], img[:, :, -EDGE_COLS:]], 2)


def bf16_noise_verdict(got: np.ndarray, plain: np.ndarray,
                       ref32: np.ndarray) -> dict:
    """The bf16 slice check's numbers: the per-pixel MAE of the kernel path
    (got) and of the plain bf16 route (plain) against the float32
    reference, and their ratio, which may be at most TOL_BF16_NOISE; the
    same over the edge columns alone (``edge_columns``), where a wrong pad
    slot of K6 shows and the whole image averages it away, at most
    TOL_BF16_EDGE_NOISE. ``ok`` holds both."""
    mae = float(np.abs(got - ref32).mean())
    plain_mae = float(np.abs(plain - ref32).mean())
    ge, pe, re = (edge_columns(a) for a in (got, plain, ref32))
    edge_mae = float(np.abs(ge - re).mean())
    edge_plain_mae = float(np.abs(pe - re).mean())
    out = dict(mae_vs_f32=mae, plain_mae_vs_f32=plain_mae,
               noise_ratio=mae / plain_mae, noise_ratio_tol=TOL_BF16_NOISE,
               edge_cols=EDGE_COLS, edge_mae_vs_f32=edge_mae,
               edge_plain_mae_vs_f32=edge_plain_mae,
               edge_noise_ratio=edge_mae / edge_plain_mae,
               edge_noise_ratio_tol=TOL_BF16_EDGE_NOISE,
               mae_vs_plain=float(np.abs(got - plain).mean()),
               mean_abs_output=float(np.abs(ref32).mean()))
    out["ok"] = bool(out["noise_ratio"] <= TOL_BF16_NOISE
                     and out["edge_noise_ratio"] <= TOL_BF16_EDGE_NOISE)
    return out


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


def check_launches(dtype: str, launches: dict, table=None) -> int:
    """Every entry launched its expected count per request batch on this
    path (``table``, PER_BATCH by default, keyed by path); returns the
    number of batches."""
    per = (PER_BATCH if table is None else table)[dtype]
    batches = launches["encoder_scale_shift"] // K
    want = {e: n * batches for e, n in per.items()}
    if batches <= 0 or launches != want:
        raise AssertionError(f"{dtype} path launched {launches}, expected "
                             f"{per} per batch")
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
    if not bf16["ok"]:
        raise AssertionError(
            f"bfloat16 slice: MAE {bf16['mae_vs_f32']} against float32 is "
            f"{bf16['noise_ratio']} times the plain bf16 route's "
            f"{bf16['plain_mae_vs_f32']} (at most {TOL_BF16_NOISE}); on the "
            f"edge columns {bf16['edge_noise_ratio']} times (at most "
            f"{TOL_BF16_EDGE_NOISE})")
    if not mae32 <= TOL_SLICE_MAE * mean32:
        raise AssertionError(f"float32 slice MAE {mae32} > "
                             f"{TOL_SLICE_MAE * mean32}")
    return results["bfloat16"]["launches"], summary, refs


CONCURRENT_K = (1, 3)


def run_concurrent(params, pairs) -> dict:
    """Two bf16 kernel services, k=1 and k=3, each on the slice's requests
    from CLIENTS client threads of its own: first each alone, then both at
    once, so that kernels launch from two host threads (each service's
    worker) at shapes whose shared memory differs. No request may fail, and
    each output must equal, bit for bit, what the same service gave alone
    (every kernel sums in a fixed order, and a batch's images do not mix)."""
    svcs = {k: StylizeService(params, slice_config("bfloat16", True),
                              size=SIZE, k=k, max_batch=MAX_BATCH,
                              device=DEVICE) for k in CONCURRENT_K}
    try:
        for svc in svcs.values():
            svc.warmup()
        alone = {k: np.stack(serve_requests(svc, pairs, CLIENTS)[0])
                 for k, svc in svcs.items()}
        together, walls, errors = {}, {}, []

        def serve(k):
            try:
                outs, _, walls[k] = serve_requests(svcs[k], pairs, CLIENTS)
                together[k] = np.stack(outs)
            except Exception as e:  # re-raised below, in the main thread
                errors.append(e)

        threads = [threading.Thread(target=serve, args=(k,)) for k in svcs]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
    finally:
        for svc in svcs.values():
            svc.close()
    if errors:
        raise AssertionError(f"concurrent serving: a request failed: "
                             f"{errors[0]!r}")
    if set(together) != set(svcs):
        raise AssertionError("concurrent serving did not complete")
    diffs = {str(k): float(np.abs(together[k] - alone[k]).max())
             for k in svcs}
    emit("concurrent", dtype="bfloat16", ks=list(CONCURRENT_K),
         requests_each=len(pairs), clients_each=CLIENTS, wall_s=wall,
         walls_s={str(k): v for k, v in walls.items()},
         max_abs_diff_vs_alone=diffs)
    if any(d != 0.0 for d in diffs.values()):
        raise AssertionError(f"concurrent serving changed outputs: {diffs}")
    return diffs


@contextlib.contextmanager
def block_pair_env():
    """MMST_BLOCK_PAIR=1 in the environment for the duration, which the
    Swin reads at each call; its earlier value (or its absence) after."""
    old = os.environ.get("MMST_BLOCK_PAIR")
    os.environ["MMST_BLOCK_PAIR"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MMST_BLOCK_PAIR", None)
        else:
            os.environ["MMST_BLOCK_PAIR"] = old


@contextlib.contextmanager
def rgb_kernel_on():
    """ops/conv.py's _RGB_KERNEL_ON set for the duration (the JAX package's
    switch for K12's rgb entry, off there)."""
    old = tconv._RGB_KERNEL_ON
    tconv._RGB_KERNEL_ON = True
    try:
        yield
    finally:
        tconv._RGB_KERNEL_ON = old


def pair_config(dtype: str) -> ModelConfig:
    """The round-5 configuration: every kernel on and the l2k128 RGB tail
    (the Swin pair comes from MMST_BLOCK_PAIR=1, block_pair_env)."""
    cfg = slice_config(dtype, True)
    return cfg.replace(decoder=cfg.decoder.replace(rgb_tail="l2k128"))


def run_pair_slice(params, pairs, refs) -> dict:
    """The pair slice: the round-5 configuration's bf16 service on every
    pair, its f32 service on the first F32_REQUESTS, and a bf16 service with
    _RGB_KERNEL_ON too (K12's rgb entry), each path's launches counted from
    zero after its warm-up and checked against PAIR_PER_BATCH, each output
    against the slice's reference services (``refs``, from run_slice) by
    the slice's criteria."""
    summary = {}
    with block_pair_env():
        for route, dtype, reqs in (("bfloat16", "bfloat16", pairs),
                                   ("float32", "float32",
                                    pairs[:F32_REQUESTS]),
                                   ("rgb", "bfloat16", pairs)):
            svc = StylizeService(params, pair_config(dtype), size=SIZE, k=K,
                                 max_batch=MAX_BATCH, device=DEVICE)
            with (rgb_kernel_on() if route == "rgb"
                  else contextlib.nullcontext()):
                svc.warmup()
                torch.cuda.synchronize()
                reset_launches()
                outs, lat, wall = serve_requests(svc, reqs, CLIENTS)
                launches = all_launches()
            svc.close()
            outs = np.stack(outs)
            if outs.shape[1:] != (SIZE, SIZE, 3) or not np.isfinite(
                    outs).all():
                raise AssertionError(f"pair slice {route}: output of shape "
                                     f"{outs.shape}, or not finite")
            batches = check_launches(route, launches, PAIR_PER_BATCH)
            if dtype == "float32":
                ref32 = refs["float32"][:len(outs)]
                mean32 = float(np.abs(ref32).mean())
                mae = float(np.abs(outs - ref32).mean())
                check = dict(mae_vs_f32=mae, mae_tol=TOL_SLICE_MAE * mean32,
                             mean_abs_output=mean32,
                             max_abs_vs_f32=float(np.abs(outs - ref32).max()))
                ok = mae <= TOL_SLICE_MAE * mean32
            else:
                check = bf16_noise_verdict(outs, refs["bfloat16"],
                                           refs["float32"])
                ok = check["ok"]
            summary[route] = dict(
                dtype=dtype, requests=len(outs), clients=CLIENTS,
                batches=batches, imgs_per_s=len(outs) / wall,
                p50_ms=float(np.median(lat)) * 1e3,
                max_ms=float(np.max(lat)) * 1e3, launches=launches,
                launches_per_batch=PAIR_PER_BATCH[route], **check)
            emit("slice_pair", route=route, size=SIZE, k=K,
                 max_batch=MAX_BATCH, block_pair=True, rgb_tail="l2k128",
                 rgb_kernel_on=route == "rgb", **summary[route])
            if not ok:
                raise AssertionError(f"pair slice {route}: {check}")
    return summary


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
    off, as the reference service runs (kernels off, nine-conv decoder),
    and in the pair slice's configuration (K11, K12 rgb128): host-to-device
    copies, the Swin pass of content and style together, the style
    transformer, the decoder, the device-to-host copy."""
    out = {}
    names = ("h2d", "swin", "style_transformer", "decoder", "d2h")
    dtype = torch.bfloat16
    for label, cfg, pair in (
            ("kernels_on", slice_config("bfloat16", True), False),
            ("kernels_off", slice_config("bfloat16", False), False),
            ("reference", reference_config("bfloat16"), False),
            ("pair_l2k128", pair_config("bfloat16"), True)):

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

        with torch.inference_mode(), (block_pair_env() if pair
                                      else contextlib.nullcontext()):
            once()
            runs = [once() for _ in range(3)]
        ms = {n: float(np.mean([r[i] for r in runs]))
              for i, n in enumerate(names)}
        ms["total"] = sum(ms.values())
        out[label] = ms
    return out


# ---------------------------------------------------------------------------
# 5. the training step: 256^2, batch 8, bf16, random k
# ---------------------------------------------------------------------------

TOL_TRAIN_F32 = 1e-3
TRAIN_FIXED_K, TRAIN_FIXED_STEPS, TRAIN_RANDOM_STEPS = (1, 4), 3, 5
TRAIN_SEED = 1
TRAIN_SPREAD_EPS, TRAIN_SPREAD_FACTOR = (2.0 ** -23, 2.0 ** -20), 4


def train_config(dtype: str, kernels: bool) -> ExperimentConfig:
    """The JAX train bench's configuration: swin_B, the ModelConfig
    defaults, 256^2 crops, batch 8, VGG19 loss at lambda 10, Adam 1e-4 with
    the reference's schedule, Swin frozen, k in [1, 4]."""
    return ExperimentConfig(
        model=ModelConfig(compute_dtype=dtype).with_kernels(kernels),
        data=DataConfig(crop_to=TRAIN_SIZE))


def train_per_step(k: int) -> dict:
    """Launches of one training step at depth k, per entry (the Swin's four
    blocks run forward only: it is frozen, so nothing of it is
    differentiated). Per style-transformer iteration the encoder runs K8 once
    (Key block), K9 once (Scale/Shift) and K10 three times (the three MLP
    residuals); the decoder K8 once (self block), K9 once (dual attention)
    and K10 twice (the self block's MLP, the last MLP). The decoder runs K5
    at conv1-4 and conv6 and K7 at conv5 and conv7, each forward once."""
    return {"window_attention": 4 + 2 * k, "window_attention_bwd": 2 * k,
            "window_attention_dual": 2 * k,
            "window_attention_dual_bwd": 2 * k,
            "ln_mlp_residual": 4 + 5 * k, "ln_mlp_residual_bwd": 5 * k,
            "stencil_phase_conv": 5, "stencil_phase2_conv": 0,
            "stencil_phase2_conv_padcols": 0, "phase_align": 2,
            "window_block_rows": 0, "window_block_windows": 0,
            "encoder_scale_shift": 0, "decoder_tail": 0,
            "window_block_pair_rows": 0, "stencil_phase2_rgb": 0,
            "stencil_phase2_rgb128": 0, "patch_embed": 0}


def param_group(key: str) -> str:
    """A parameter's group for the gradient checks: the style transformer's
    blocks and MLPs (three path levels), the decoder's convs (two)."""
    parts = key.split("/")
    return "/".join(parts[:3] if parts[0] == "style_transformer"
                    else parts[:2])


def first_step_grads(cfg: ExperimentConfig, params0: dict, vgg: dict,
                     content, style, seed: int):
    """The first step's gradients (by flat key) from a copy of the weights,
    with the step generator of ``seed`` (the same k and masks for every
    configuration); returns (k, grads)."""
    params = tree_map(lambda t: t.detach().clone(), params0)
    state = create_train_state(params, cfg.train)
    gen = torch.Generator().manual_seed(seed)
    k = _sample_k(gen, cfg.train.max_layers)
    loss, _, grads = make_loss_and_grad(cfg, vgg)(state.params, content,
                                                   style, k, gen)
    if not torch.isfinite(loss):
        raise AssertionError(f"first-step loss {loss} is not finite")
    return k, {key: g.detach() for key, g in grads.items()}


def grad_checks(params0, vgg, content, style) -> dict:
    """The first step's gradients per parameter group against the float32
    route with every kernel off. float32 with the kernels on: relative
    max-abs within TOL_TRAIN_F32, or within TRAIN_SPREAD_FACTOR times the
    reference's own spread, whichever is larger. The spread is how far the
    reference's gradient moves when the content images are scaled by
    (1 + eps), eps in TRAIN_SPREAD_EPS (one and eight units in the last
    place): the loss is piecewise smooth (ReLUs and max pools, the absolute
    values of its distances), and a group whose gradient is small against
    its terms (the encoder's key MLP above all) moves by more than 1e-3
    under such a change (1.6e-3 on the CPU at 128^2), so no f32 route can
    be held closer than that. bfloat16: the kernel path's relative L1
    error at most TOL_BF16_NOISE times the plain bf16 route's."""
    k, ref = first_step_grads(train_config("float32", False), params0, vgg,
                              content, style, seed=100)
    got = {(dtype, kernels): first_step_grads(
        train_config(dtype, kernels), params0, vgg, content, style,
        seed=100)[1]
        for dtype, kernels in (("float32", True), ("bfloat16", True),
                               ("bfloat16", False))}
    moved = [first_step_grads(train_config("float32", False), params0, vgg,
                              content * (1 + eps), style, seed=100)[1]
             for eps in TRAIN_SPREAD_EPS]
    groups = sorted({param_group(key) for key in ref})

    def per_group(grads, measure):
        return group_measure(grads, ref, measure)

    f32 = per_group(got["float32", True], rel_max)
    spread = {grp: max(per_group(m, rel_max)[grp] for m in moved)
              for grp in groups}
    f32_tol = {grp: max(TOL_TRAIN_F32, TRAIN_SPREAD_FACTOR * spread[grp])
               for grp in groups}
    f32_over = {grp: f32[grp] / f32_tol[grp] for grp in groups}
    bf16_k = per_group(got["bfloat16", True], rel_l1)
    bf16_p = per_group(got["bfloat16", False], rel_l1)
    ratio = {grp: bf16_k[grp] / bf16_p[grp] for grp in groups}
    out = dict(k=k, groups=len(groups),
               f32_rel_max=max(f32.values()),
               f32_worst_group=max(f32, key=f32.get),
               f32_over_tol=max(f32_over.values()),
               f32_tol=TOL_TRAIN_F32, spread_max=max(spread.values()),
               f32_within_1e3=sum(v <= TOL_TRAIN_F32 for v in f32.values()),
               bf16_noise_ratio=max(ratio.values()),
               bf16_worst_group=max(ratio, key=ratio.get),
               bf16_noise_tol=TOL_BF16_NOISE,
               bf16_kernel_rel_l1=max(bf16_k.values()),
               bf16_plain_rel_l1=max(bf16_p.values()),
               per_group={grp: dict(f32_rel_max=f32[grp],
                                    spread=spread[grp],
                                    bf16_kernel_rel_l1=bf16_k[grp],
                                    bf16_plain_rel_l1=bf16_p[grp])
                          for grp in groups})
    emit("train_grads", **out)
    if not out["f32_over_tol"] <= 1.0:
        worst = max(f32_over, key=f32_over.get)
        raise AssertionError(
            f"float32 kernel gradients of {worst} are {f32[worst]} "
            f"(relative max-abs) from the kernels-off route, over "
            f"{f32_tol[worst]}")
    if not out["bf16_noise_ratio"] <= TOL_BF16_NOISE:
        raise AssertionError(
            f"bfloat16 kernel gradients of {out['bf16_worst_group']}: error "
            f"{out['bf16_noise_ratio']} times the plain bf16 route's, over "
            f"{TOL_BF16_NOISE}")
    return out


def train_run(params0, vgg, batches, kernels: bool) -> dict:
    """The bf16 step through make_train_step: TRAIN_FIXED_STEPS steps at each
    fixed k, then TRAIN_RANDOM_STEPS at random k; per step its k, loss,
    wall time (ending in a synchronize), imgs/s and peak memory, and, with
    the kernels on, its launches against ``train_per_step``."""
    cfg = train_config("bfloat16", kernels)
    params = tree_map(lambda t: t.detach().clone(), params0)
    state = create_train_state(params, cfg.train)
    step = make_train_step(cfg, vgg, device=DEVICE)
    plan = [k for k in TRAIN_FIXED_K for _ in range(TRAIN_FIXED_STEPS)]
    plan += [None] * TRAIN_RANDOM_STEPS
    # one untimed step first: allocator and library warm-up
    step(state, *batches[0], torch.Generator().manual_seed(0), k=1)
    torch.cuda.synchronize()
    steps = []
    launches = {}
    reset_launches()
    for i, k in enumerate(plan):
        content, style = batches[i % len(batches)]
        before = all_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, content, style,
                        torch.Generator().manual_seed(1000 + i), k=k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        now = all_launches()
        per = {e: now[e] - before[e] for e in now}
        if not np.isfinite(m["total"]):
            raise AssertionError(f"step {i}: loss {m['total']} not finite")
        if kernels and per != train_per_step(m["k"]):
            raise AssertionError(f"step {i} (k={m['k']}) launched {per}, "
                                 f"expected {train_per_step(m['k'])}")
        if not kernels and any(per.values()):
            raise AssertionError(f"the kernels-off step launched {per}")
        row = dict(step=i, k=m["k"], loss=m["total"], content=m["content"],
                   style=m["style"], lr=m["lr"], ms=dt * 1e3,
                   imgs_per_s=TRAIN_BATCH / dt,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        emit("train_step", kernels=kernels, **row)
        steps.append(row)
    launches = all_launches()
    by_k = {}
    for r in steps:
        by_k.setdefault(r["k"], []).append(r["imgs_per_s"])
    return dict(steps=steps, launches=launches,
                imgs_per_s_by_k={k: float(np.mean(v)) for k, v in
                                 sorted(by_k.items())},
                imgs_per_s_mean=float(np.mean([r["imgs_per_s"]
                                               for r in steps])),
                peak_mem_gib=max(r["peak_mem_gib"] for r in steps))


def train_stage_times(params0, vgg, content, style) -> dict:
    """CUDA-event ms of one bf16 step at k=1, kernels on and off: the
    forward (model and loss), the backward, the optimizer update; mean of 3
    after one warm-up."""
    out = {}
    for label, kernels in (("kernels_on", True), ("kernels_off", False)):
        cfg = train_config("bfloat16", kernels)
        params = tree_map(lambda t: t.detach().clone(), params0)
        state = create_train_state(params, cfg.train)
        leaves = list(state.trainable().values())
        c = torch.as_tensor(content, device=DEVICE)
        s = torch.as_tensor(style, device=DEVICE)

        def once():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            mc, ms = prepare_batch_for_model(c, s, cfg.data)
            y = master_apply(state.params, mc, ms, cfg.model, k=1,
                             deterministic=False,
                             generator=torch.Generator().manual_seed(0))
            lc, ls, lo = _loss_views(c, s, y, cfg.data)
            loss = perceptual_loss(vgg, lc, ls, lo, cfg.loss,
                                   lambda_value=cfg.train.lambda_style)
            ev[1].record()
            grads = torch.autograd.grad(loss["total"], leaves,
                                        allow_unused=True)
            ev[2].record()
            state.opt.step([g if g is not None else torch.zeros_like(p)
                            for g, p in zip(grads, leaves)])
            ev[3].record()
            torch.cuda.synchronize()
            return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

        once()
        runs = [once() for _ in range(3)]
        ms = {n: float(np.mean([r[i] for r in runs]))
              for i, n in enumerate(("forward", "backward", "optimizer"))}
        ms["total"] = sum(ms.values())
        out[label] = ms
    return out


def train_inputs(seed: int = TRAIN_SEED):
    """The training phase's weights (model and VGG19) and batches (uniform
    noise, as the JAX train bench feeds), drawn from their own seed."""
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    params0 = init_master_model(train_config("bfloat16", True).model, gen,
                                device=DEVICE)
    vgg = init_vgg19_features(gen, device=DEVICE)

    def batch():
        return tuple(torch.from_numpy(rng.random(
            (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
            dtype=np.float32)).to(DEVICE) for _ in range(2))

    return params0, vgg, [batch() for _ in range(3)]


def run_train() -> dict:
    """The training phase: the gradient checks, the bf16 run with the
    kernels on and off, and the step's stage times."""
    params0, vgg, batches = train_inputs()
    checks = grad_checks(params0, vgg, *batches[0])
    runs = {kernels: train_run(params0, vgg, batches, kernels)
            for kernels in (True, False)}
    stages = train_stage_times(params0, vgg, *batches[0])
    summary = dict(size=TRAIN_SIZE, batch=TRAIN_BATCH, dtype="bfloat16",
                   imgs_per_s_kernels_on=runs[True]["imgs_per_s_mean"],
                   imgs_per_s_kernels_off=runs[False]["imgs_per_s_mean"],
                   imgs_per_s_by_k_on=runs[True]["imgs_per_s_by_k"],
                   imgs_per_s_by_k_off=runs[False]["imgs_per_s_by_k"],
                   peak_mem_gib_on=runs[True]["peak_mem_gib"],
                   peak_mem_gib_off=runs[False]["peak_mem_gib"],
                   launches=runs[True]["launches"],
                   per_step_k1=train_per_step(1),
                   f32_rel_max=checks["f32_rel_max"],
                   bf16_noise_ratio=checks["bf16_noise_ratio"])
    emit("train", **summary)
    emit("stages", what="train_step", dtype="bfloat16", batch=TRAIN_BATCH,
         size=TRAIN_SIZE, k=1, **stages)
    return summary


# ---------------------------------------------------------------------------
# 6. style-locked serving and the lambda sweep at 512^2
# ---------------------------------------------------------------------------

LOCKED_SEED = TRAIN_SEED + 4
LOCKED_STYLES, LOCKED_KS = 2, (1, 3)
# bf16 content requests per (style, k); f32 requests in all, at k=1.
LOCKED_REQUESTS = {1: 16, 3: 8}
LOCKED_F32_REQUESTS = 4


def locked_per_batch(dtype: str, k: int) -> dict:
    """Launches of one style-locked batch at depth k: the contents' Swin (4
    blocks: K1 at bf16, K2 at f32, as PER_BATCH), then per iteration the
    decoder half's self block (K2) and tail (K4), no K3 (the stream holds
    the encoder's triples), and the decoder."""
    bf16 = dtype == "bfloat16"
    return {**PER_BATCH[dtype], "window_block_rows": 4 if bf16 else 0,
            "window_block_windows": (0 if bf16 else 4) + k,
            "encoder_scale_shift": 0, "decoder_tail": k}


def locked_per_stream(dtype: str, k: int) -> dict:
    """Launches of one stream build at depth k: the style's Swin at batch 1
    (4 blocks), then per iteration the encoder's Key block (K2) and its
    Scale/Shift (K3); no decoder."""
    bf16 = dtype == "bfloat16"
    return {**{e: 0 for e in PER_BATCH[dtype]},
            "window_block_rows": 4 if bf16 else 0,
            "window_block_windows": (0 if bf16 else 4) + k,
            "encoder_scale_shift": k}


def expect_launches(label: str, launches: dict, per: dict, n: int) -> None:
    want = {e: c * n for e, c in per.items()}
    if n <= 0 or launches != want:
        raise AssertionError(f"{label}: launched {launches}, expected {n} x "
                             f"{per}")


def serve_locked(svc: LockedStyleService, reqs, k: int, clients: int):
    """serve_requests over (content, style name) requests at depth k."""
    return serve_requests(
        types.SimpleNamespace(stylize=functools.partial(svc.stylize, k=k)),
        reqs, clients)


def reference_outputs(params, pairs, k: int) -> dict:
    """The slice's reference services (every kernel off, the nine plain
    convs) at depth k on the pairs, f32 and bf16; they launch nothing."""
    before = all_launches()
    refs = {}
    for dtype in ("float32", "bfloat16"):
        svc = StylizeService(params, reference_config(dtype), size=SIZE, k=k,
                             max_batch=MAX_BATCH, device=DEVICE)
        refs[dtype] = np.stack(serve_requests(svc, pairs, CLIENTS)[0])
        svc.close()
    if all_launches() != before:
        raise AssertionError("a reference service launched a kernel")
    return refs


def f32_check(got: np.ndarray, ref32: np.ndarray) -> dict:
    mean32 = float(np.abs(ref32).mean())
    mae = float(np.abs(got - ref32).mean())
    return dict(mae_vs_f32=mae, mae_tol=TOL_SLICE_MAE * mean32,
                mean_abs_output=mean32,
                max_abs_vs_f32=float(np.abs(got - ref32).max()),
                ok=mae <= TOL_SLICE_MAE * mean32)


def finite_images(label: str, out: np.ndarray, n: int) -> None:
    if out.shape != (n, SIZE, SIZE, 3) or not np.isfinite(out).all():
        raise AssertionError(f"{label}: output of shape {out.shape}, or not "
                             "finite")


def run_locked(params, styles: dict, contents: list) -> dict:
    """The style-locked path at bf16 (both styles, k=1 and k=3) and f32
    (k=1): each service's stream builds, then each k's requests, with the
    launches of each counted from zero and checked exactly; every output
    against the reference services on the same contents paired with the
    locked style image; the f32 route against the f32 kernel pair service
    too. Returns the bf16 service's streams and each run's readings."""
    names = list(styles)
    out = {}
    streams = {}
    for dtype, ks in (("bfloat16", LOCKED_KS), ("float32", (1,))):
        cfg = slice_config(dtype, True)
        torch.cuda.synchronize()
        reset_launches()
        svc = LockedStyleService(params, cfg, styles, size=SIZE, ks=ks,
                                 max_batch=MAX_BATCH, device=DEVICE)
        build = all_launches()
        try:
            per_stream = {e: sum(locked_per_stream(dtype, k)[e] for k in ks)
                          for e in build}
            expect_launches(f"{dtype} locked stream builds", build,
                            per_stream, len(names))
            svc.warmup()
            for k in ks:
                n = (LOCKED_REQUESTS[k] if dtype == "bfloat16"
                     else LOCKED_F32_REQUESTS // len(names))
                reqs = [(c, name) for name in names for c in contents[:n]]
                torch.cuda.synchronize()
                reset_launches()
                outs, lat, wall = serve_locked(svc, reqs, k, CLIENTS)
                launches = all_launches()
                batches = launches["decoder_tail"] // k
                expect_launches(f"{dtype} locked k={k}", launches,
                                locked_per_batch(dtype, k), batches)
                outs = np.stack(outs)
                finite_images(f"{dtype} locked k={k}", outs, len(reqs))
                out[dtype, k] = dict(
                    reqs=reqs, outs=outs, requests=len(reqs),
                    clients=CLIENTS, batches=batches,
                    imgs_per_s=len(reqs) / wall,
                    p50_ms=float(np.median(lat)) * 1e3,
                    max_ms=float(np.max(lat)) * 1e3, launches=launches,
                    launches_per_batch=locked_per_batch(dtype, k),
                    stream_launches=build,
                    launches_per_stream=locked_per_stream(dtype, k),
                    stream_build_ms={f"{nm},k={kk}": s * 1e3 for (nm, kk), s
                                     in svc.build_s.items() if kk == k})
        finally:
            svc.close()
        if dtype == "bfloat16":
            streams = svc.streams
    for (dtype, k), r in out.items():
        pairs = [(c, styles[name]) for c, name in r.pop("reqs")]
        refs = reference_outputs(params, pairs, k)
        if dtype == "bfloat16":
            check = bf16_noise_verdict(r["outs"], refs["bfloat16"],
                                       refs["float32"])
        else:
            check = f32_check(r["outs"], refs["float32"])
            svc = StylizeService(params, slice_config("float32", True),
                                 size=SIZE, k=k, max_batch=MAX_BATCH,
                                 device=DEVICE)
            pair_out = np.stack(serve_requests(svc, pairs, CLIENTS)[0])
            svc.close()
            vs_pair = f32_check(r["outs"], pair_out)
            check["vs_pair_service"] = dict(
                mae=vs_pair["mae_vs_f32"], mae_tol=vs_pair["mae_tol"],
                max_abs=vs_pair["max_abs_vs_f32"],
                bits_equal=bool(np.array_equal(r["outs"], pair_out)),
                ok=vs_pair["ok"])
            check["ok"] = check["ok"] and vs_pair["ok"]
        del r["outs"]
        r.update(check)
        emit("locked", dtype=dtype, size=SIZE, k=k, max_batch=MAX_BATCH,
             styles=names, **r)
        if not check["ok"]:
            raise AssertionError(f"locked {dtype} k={k}: {check}")
    return dict(out=out, streams=streams)


def run_locked_blend(params, streams: dict, names: list,
                     contents: list) -> float:
    """blend_style_streams([a, b], [1, 0]) decodes to stream a's output bit
    for bit (a batch of MAX_BATCH contents, bf16, k=1)."""
    cfg = slice_config("bfloat16", True)
    a, b = (streams[(n, 1)] for n in names[:2])
    x = torch.as_tensor(np.stack(contents[:MAX_BATCH]), device=DEVICE)
    with torch.inference_mode():
        blended = blend_style_streams([a, b], [1, 0])
        got, want = (stylize_with_style_stream(params, x, s, cfg)
                     for s in (blended, a))
    diff = float((got - want).abs().max())
    emit("locked_blend", dtype="bfloat16", k=1, weights=[1, 0],
         max_abs_diff_vs_stream_a=diff)
    if not torch.equal(got, want):
        raise AssertionError(f"blend [1, 0] differs from stream a: {diff}")
    return diff


def locked_stage_times(params, contents: np.ndarray, stream) -> dict:
    """CUDA-event times (ms) of one bf16 batch of MAX_BATCH contents at k=1
    through the locked route, stage by stage, through the functions
    stylize_with_style_stream runs: host-to-device, the contents' Swin, the
    style transformer's decoder half against the stream, the decoder,
    device-to-host; mean of 3 after one run."""
    cfg = slice_config("bfloat16", True)
    names = ("h2d", "swin", "style_transformer", "decoder", "d2h")

    def once():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        c = torch.as_tensor(contents, device=DEVICE)
        ev[1].record()
        fc = encode_features(params, c, cfg)
        ev[2].record()
        fcs = style_transformer_apply_from_stream(
            params["style_transformer"], fc, stream, cfg.transformer)
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
    ms = {n: float(np.mean([r[i] for r in runs])) for i, n in enumerate(names)}
    ms["total"] = sum(ms.values())
    return ms


def run_sweep(params, params2, content: np.ndarray, style: np.ndarray):
    """A SweepService over two bf16 parameter sets at k=1: one call's
    launches exactly two pair batches', and each set's output equal, bit
    for bit, to make_stylize_fn of that set alone at the same batch of 1."""
    cfg = slice_config("bfloat16", True)
    svc = SweepService({"set0": params, "set1": params2}, cfg, size=SIZE,
                       ks=(1,), device=DEVICE)
    svc.warmup()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = svc.sweep(content, style, k=1)
    wall = time.perf_counter() - t0
    launches = all_launches()
    diffs = {}
    for name, p in (("set0", params), ("set1", params2)):
        one = make_stylize_fn(cfg, k=1, device=DEVICE)(
            p, content[None], style[None])[0].cpu().numpy()
        finite_images(f"sweep {name}", outs[name][None], 1)
        diffs[name] = float(np.abs(outs[name] - one).max())
    sets_differ = float(np.abs(outs["set0"] - outs["set1"]).mean())
    emit("sweep", dtype="bfloat16", size=SIZE, k=1, sets=svc.names,
         ms=wall * 1e3, launches=launches,
         launches_per_set=PER_BATCH["bfloat16"],
         max_abs_diff_vs_single=diffs, mean_abs_diff_between_sets=sets_differ)
    expect_launches("sweep", launches, PER_BATCH["bfloat16"], 2)
    if any(d != 0.0 for d in diffs.values()) or sets_differ == 0.0:
        raise AssertionError(f"sweep outputs differ from single runs: {diffs}"
                             f", or the sets agree ({sets_differ})")
    return diffs


def run_locked_phases(params) -> dict:
    """Style-locked serving, its stage times and the lambda sweep, with the
    slice's weights and draws of their own (the styles, the contents and
    the sweep's second set)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(LOCKED_SEED)
    styles = {f"style{i}": rng.random((SIZE, SIZE, 3), dtype=np.float32)
              for i in range(LOCKED_STYLES)}
    contents = [rng.random((SIZE, SIZE, 3), dtype=np.float32)
                for _ in range(max(LOCKED_REQUESTS.values()))]
    locked = run_locked(params, styles, contents)
    names = list(styles)
    run_locked_blend(params, locked["streams"], names, contents)
    stages = locked_stage_times(params, np.stack(contents[:MAX_BATCH]),
                                locked["streams"][names[0], 1])
    emit("locked_stages", dtype="bfloat16", batch=MAX_BATCH, size=SIZE, k=1,
         **stages)
    params2 = init_master_model(
        slice_config("bfloat16", True),
        torch.Generator().manual_seed(LOCKED_SEED + 1), device=DEVICE)
    run_sweep(params, params2, contents[0], styles[names[0]])
    wall = time.perf_counter() - t0
    emit("locked_phases", wall_s=wall)
    return {**{f"{dtype} k={k}": r["launches"]
               for (dtype, k), r in locked["out"].items()},
            "bfloat16 stream builds": locked["out"][
                "bfloat16", 1]["stream_launches"]}


# ---------------------------------------------------------------------------
# 7. meta training, fast adaptation, remat and gradient accumulation
# ---------------------------------------------------------------------------

MODES_SEED = TRAIN_SEED + 5
META_INNER, META_OUTER_LR, META_STEPS = 4, 1e-4, 3
META_CHECK_KS = (1, 2, 1, 2)
ADAPT_STEPS, ADAPT_BATCH, ADAPT_CONTENTS, ADAPT_LR = 20, 4, 8, 1e-4
MODE_KS, MODE_STEPS, ACCUM = (1, 2), 3, 2
# The kernel entries every training step launches.
TRAINING_ENTRIES = ("window_attention", "window_attention_bwd",
                    "window_attention_dual", "window_attention_dual_bwd",
                    "ln_mlp_residual", "ln_mlp_residual_bwd",
                    "stencil_phase_conv", "phase_align")


def meta_config(dtype: str, kernels: bool,
                depth_drop: bool = True) -> ExperimentConfig:
    """The JAX meta bench's configuration (bench.py:351-375): the train
    configuration, mode "meta", 4 inner updates, outer_lr 1e-4; without
    ``depth_drop`` every stochastic-depth probability is 0."""
    cfg = train_config(dtype, kernels)
    if not depth_drop:
        cfg = no_depth_drop(cfg)
    return cfg.replace(train=cfg.train.replace(
        mode="meta", num_inner_updates=META_INNER, outer_lr=META_OUTER_LR))


def no_depth_drop(cfg: ExperimentConfig) -> ExperimentConfig:
    m = cfg.model
    return cfg.replace(model=m.replace(
        swin=m.swin.replace(stochastic_depth_probs=tuple(
            0.0 for _ in m.swin.stochastic_depth_probs)),
        transformer=m.transformer.replace(encoder_stochastic_depth_prob=0.0,
                                          decoder_stochastic_depth_prob=0.0)))


def with_train(cfg: ExperimentConfig, **fields) -> ExperimentConfig:
    return cfg.replace(train=cfg.train.replace(**fields))


def table_sum(tables) -> dict:
    tables = list(tables)
    return {e: sum(t[e] for t in tables) for e in tables[0]}


def remat_per_step(k: int) -> dict:
    """Launches of one remat step at depth k: the non-reentrant recompute
    runs the whole checkpointed forward again, so every forward entry
    launches twice, every backward entry once."""
    return {e: n * (1 if e.endswith("_bwd") else 2)
            for e, n in train_per_step(k).items()}


def adapt_per_step(k: int) -> dict:
    """Launches of one fast-adaptation step at depth k: ``train_per_step``
    but for the backward of the first iteration's decoder self block (its
    K8 and its K10): it reads the frozen Swin's content features with
    frozen weights, so nothing before it needs a gradient and autograd
    does not run it; at iterations 2..k its input comes from the encoder
    and its backward runs, as every other backward does, since the
    encoder's gradient passes back through the frozen style decoder and
    CNN decoder."""
    t = dict(train_per_step(k))
    t["window_attention_bwd"] -= 1
    t["ln_mlp_residual_bwd"] -= 1
    return t


def accum_per_step(k: int) -> dict:
    """Launches of one step of ACCUM micro-batches at depth k."""
    return {e: ACCUM * n for e, n in train_per_step(k).items()}


def clone_params(params0: dict) -> dict:
    return tree_map(lambda t: t.detach().clone(), params0)


def moments(state) -> tuple:
    """Adam's (mu, nu) by the flat keys of the trainable leaves."""
    keys = list(state.trainable())
    return dict(zip(keys, state.opt.mu)), dict(zip(keys, state.opt.nu))


def meta_tasks(n: int, seed: int = MODES_SEED):
    """n tasks of uniform noise, as the JAX meta bench feeds: contents
    (META_INNER, B, 256, 256, 3) and one style repeated to B."""
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.random(
        (META_INNER, TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
        dtype=np.float32)).to(DEVICE),
        repeat_style_to_batch(rng.random(
            (TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.float32),
            TRAIN_BATCH).to(DEVICE)) for _ in range(n)]


def meta_run(params0, vgg, tasks, kernels: bool) -> dict:
    """META_STEPS bf16 meta steps through make_meta_train_step (after one
    untimed step); per step its ks, loss, wall time (ending in a
    synchronize), imgs/s counting META_INNER x B images, peak memory, and
    its launches, counted from zero, against the sum of ``train_per_step``
    over its ks (none with the kernels off); the Swin's leaves stay those
    of theta before the step, bit for bit."""
    cfg = meta_config("bfloat16", kernels)
    state = create_train_state(clone_params(params0), cfg.train)
    step = make_meta_train_step(cfg, vgg, device=DEVICE)
    swin = flatten_params(state.params["swin"])
    swin0 = {key: t.clone() for key, t in swin.items()}
    step(state, *tasks[0], torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    rows = []
    for i in range(META_STEPS):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, *tasks[i % len(tasks)],
                        torch.Generator().manual_seed(2000 + i))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per = all_launches()
        if not np.isfinite(m["total"]):
            raise AssertionError(f"meta step {i}: loss {m['total']}")
        want = (table_sum(train_per_step(k) for k in m["ks"]) if kernels
                else {e: 0 for e in per})
        if per != want:
            raise AssertionError(f"meta step {i} (ks={m['ks']}) launched "
                                 f"{per}, expected {want}")
        moved = [key for key, t in swin.items() if not torch.equal(
            t, swin0[key])]
        if moved:
            raise AssertionError(f"meta step {i} changed the frozen Swin: "
                                 f"{moved[:3]}")
        row = dict(step=i, ks=m["ks"], loss=m["total"], content=m["content"],
                   style=m["style"], ms=dt * 1e3,
                   imgs_per_s=META_INNER * TRAIN_BATCH / dt,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches=per)
        emit("meta", kernels=kernels, inner=META_INNER, batch=TRAIN_BATCH,
             size=TRAIN_SIZE, dtype="bfloat16", **row)
        rows.append(row)
    return dict(rows=rows, imgs_per_s_mean=float(np.mean(
        [r["imgs_per_s"] for r in rows])), ms_mean=float(np.mean(
            [r["ms"] for r in rows])),
        peak_mem_gib=max(r["peak_mem_gib"] for r in rows),
        launches=table_sum(r["launches"] for r in rows))


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode
    (warnings only), restored after; yields the warnings caught, which
    name the ops that have no deterministic implementation."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        cudnn.deterministic, cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def meta_by_hand(cfg: ExperimentConfig, vgg, state, contents, style,
                 generator, ks):
    """The meta step's composition: omega a copy of theta's trainable
    leaves (the frozen ones shared), one plain step per inner batch on
    omega through theta's Adam state, the interpolation."""
    omega = tree_map(lambda t: (t.detach().clone().requires_grad_()
                                if t.requires_grad else t), state.params)
    inner = TrainState(step=0, params=omega, opt=state.opt)
    plain = make_train_step(cfg, vgg, device=DEVICE)
    for j, k in enumerate(ks):
        inner, _ = plain(inner, contents[j], style, generator, k=k)
    _interp(state.params, omega, trainable_labels(state.params, cfg.train),
            cfg.train.outer_lr)
    state.step += 1
    return state


def state_diff(a, b) -> list:
    """The parameter groups in which two states' leaves or Adam moments
    differ in any bit."""
    out = set()
    for key, t in flatten_params(a.params).items():
        if not torch.equal(t, flatten_params(b.params)[key]):
            out.add(param_group(key))
    for ma, mb in zip(moments(a), moments(b)):
        out |= {param_group(key) for key in ma
                if not torch.equal(ma[key], mb[key])}
    return sorted(out)


def group_measure(grads, ref, measure) -> dict:
    """measure(list of tensors, list of reference tensors) per parameter
    group (``param_group``) of the reference's keys."""
    out = {}
    for grp in sorted({param_group(key) for key in ref}):
        keys = [key for key in ref if param_group(key) == grp]
        out[grp] = measure([grads[key].float() for key in keys],
                           [ref[key].float() for key in keys])
    return out


def rel_max(a, b) -> float:
    return (max((x - y).abs().max().item() for x, y in zip(a, b))
            / max(y.abs().max().item() for y in b))


def rel_l1(a, b) -> float:
    return (sum((x - y).abs().sum().item() for x, y in zip(a, b))
            / sum(y.abs().sum().item() for y in b))


def f32_verdict(got, ref, moved) -> dict:
    """grad_checks' float32 criterion per group: relative max-abs within
    max(TOL_TRAIN_F32, TRAIN_SPREAD_FACTOR x the reference's spread)."""
    err = group_measure(got, ref, rel_max)
    spread = {grp: max(group_measure(m, ref, rel_max)[grp] for m in moved)
              for grp in err}
    over = {grp: err[grp] / max(TOL_TRAIN_F32, TRAIN_SPREAD_FACTOR
                                * spread[grp]) for grp in err}
    worst = max(over, key=over.get)
    return dict(f32_rel_max=max(err.values()), f32_over_tol=over[worst],
                f32_worst_group=worst, spread_max=max(spread.values()))


def bf16_verdict(got, plain, ref) -> dict:
    """grad_checks' bfloat16 criterion per group: the kernel path's
    relative L1 error against the f32 reference at most TOL_BF16_NOISE
    times the plain bf16 route's."""
    k = group_measure(got, ref, rel_l1)
    p = group_measure(plain, ref, rel_l1)
    ratio = {grp: k[grp] / p[grp] for grp in k}
    worst = max(ratio, key=ratio.get)
    return dict(bf16_noise_ratio=ratio[worst], bf16_worst_group=worst,
                bf16_kernel_rel_l1=max(k.values()),
                bf16_plain_rel_l1=max(p.values()))


def require(label: str, out: dict) -> None:
    if "f32_over_tol" in out and not out["f32_over_tol"] <= 1.0:
        raise AssertionError(f"{label}: float32 {out['f32_worst_group']} "
                             f"{out['f32_over_tol']} times its bound")
    if "bf16_noise_ratio" in out and \
            not out["bf16_noise_ratio"] <= TOL_BF16_NOISE:
        raise AssertionError(f"{label}: bfloat16 {out['bf16_worst_group']} "
                             f"noise ratio {out['bf16_noise_ratio']}")


def meta_checks(params0, vgg, task) -> dict:
    """One meta step (ks META_CHECK_KS, stochastic depth off) per route
    from the same theta and task. Adam's first moments (mu, a linear mix of
    the gradients) of the kernel path against the float32 kernels-off
    route: float32 by grad_checks' bound (the spread from the contents
    scaled by 1 + eps), bfloat16 by its noise ratio against the plain bf16
    route. theta' of the kernel path against the kernels-off route of its
    type within 2.5 x outer_lr x n x lr per element, plus the f32 spacing
    at theta' (outer_lr x n x lr is 4e-8 here, under the spacing of a
    weight near 1, so the two sides may round to neighbours), a sanity
    check only: each side moves an element by about outer_lr x n x lr, so
    no gradient can break it, and mu is the check of the gradients; the
    share of elements beyond 1e-3 of that bound. The bf16 kernel path's meta step,
    run twice under PyTorch's defaults (the groups that differ are named),
    then twice again and its composition (``meta_by_hand``) with
    deterministic algorithms (cuDNN's, and PyTorch's deterministic mode,
    whose warnings name the ops without one): the composition bit for bit
    if those two runs are, else held to the mu criterion."""
    contents, style = task

    def run(dtype, kernels, scale=1.0, by_hand=False):
        cfg = meta_config(dtype, kernels, depth_drop=False)
        state = create_train_state(clone_params(params0), cfg.train)
        gen = torch.Generator().manual_seed(3000)
        if by_hand:
            return meta_by_hand(cfg, vgg, state, contents * scale, style,
                                gen, META_CHECK_KS)
        return make_meta_train_step(cfg, vgg, device=DEVICE)(
            state, contents * scale, style, gen, ks=META_CHECK_KS)[0]

    t0 = time.perf_counter()
    ref = run("float32", False)
    moved = [moments(run("float32", False, 1 + eps))[0]
             for eps in TRAIN_SPREAD_EPS]
    states = {("float32", True): run("float32", True),
              ("bfloat16", True): run("bfloat16", True),
              ("bfloat16", False): run("bfloat16", False)}
    mu_ref = moments(ref)[0]
    out = dict(ks=list(META_CHECK_KS), inner=META_INNER,
               **f32_verdict(moments(states["float32", True])[0], mu_ref,
                             moved),
               **bf16_verdict(moments(states["bfloat16", True])[0],
                              moments(states["bfloat16", False])[0],
                              mu_ref))
    lr = train_config("float32", True).train.inner_lr
    bound = 2.5 * META_OUTER_LR * META_INNER * lr
    for dtype, base in (("float32", ref), ("bfloat16",
                                          states["bfloat16", False])):
        got = flatten_params(states[dtype, True].params)
        worst, bare, beyond, total = 0.0, 0.0, 0, 0
        for key, t in flatten_params(base.params).items():
            t, g = t.detach(), got[key].detach()
            if key.startswith("swin/"):
                if not torch.equal(g, t):
                    raise AssertionError(f"{dtype}: the Swin moved ({key})")
                continue
            spacing = torch.nextafter(t.abs(), torch.full_like(t, np.inf)) \
                - t.abs()
            d = (g - t).abs()
            worst = max(worst, float((d / (bound + spacing)).max()))
            bare = max(bare, float(d.max()) / bound)
            beyond += int((d > 1e-3 * bound).sum())
            total += d.numel()
        out[f"theta_{dtype}_over_bound"] = worst
        out[f"theta_{dtype}_over_bound_without_spacing"] = bare
        out[f"theta_{dtype}_share_beyond_1e-3_bound"] = beyond / total
        if not worst <= 1.0:
            raise AssertionError(f"{dtype}: theta' {worst} times the bound")
    out["theta_bound"] = bound
    out["run_to_run_groups"] = state_diff(states["bfloat16", True],
                                          run("bfloat16", True))
    # The composition's runs with deterministic algorithms, whose warnings
    # name the ops that have none: under PyTorch's defaults two runs of
    # the step differ (cuDNN's algorithms).
    with deterministic_algorithms() as caught:
        first = run("bfloat16", True)
        again = run("bfloat16", True)
        by_hand = run("bfloat16", True, by_hand=True)
    out["run_to_run_groups_deterministic"] = state_diff(first, again)
    out["nondeterministic_ops"] = sorted({str(w.message)[:200]
                                          for w in caught})
    if not out["run_to_run_groups_deterministic"]:
        diff = state_diff(first, by_hand)
        out["composition_bit_equal"] = not diff
        if diff:
            raise AssertionError(f"the meta step and its composition differ "
                                 f"in {diff}")
    else:
        comp = bf16_verdict(moments(by_hand)[0],
                            moments(states["bfloat16", False])[0], mu_ref)
        out["composition_bit_equal"] = False
        out["composition_noise_ratio"] = comp["bf16_noise_ratio"]
        require("the composition", comp)
    out["wall_s"] = time.perf_counter() - t0
    emit("meta_checks", **out)
    require("meta_checks", out)
    return out


def run_adapt(params0, vgg) -> dict:
    """``adapt_to_style`` with the JAX command line's defaults (20 steps,
    batch 4, lr 1e-4) at 256^2, bf16, kernels on: one style and 8 contents
    of noise from a seed. Each step's launches against ``adapt_per_step``;
    only the style transformer's encoder leaves change."""
    rng = np.random.default_rng(MODES_SEED + 1)
    style = rng.random((TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.float32)
    contents = rng.random((ADAPT_CONTENTS, TRAIN_SIZE, TRAIN_SIZE, 3),
                          dtype=np.float32)
    rows, logged, seen = [], [], {}

    def on_step(i, m):
        now = all_launches()
        per = {e: now[e] - seen.get(e, 0) for e in now}
        seen.update(now)
        if per != adapt_per_step(m["k"]):
            raise AssertionError(f"adapt step {i} (k={m['k']}) launched "
                                 f"{per}, expected {adapt_per_step(m['k'])}")
        if not np.isfinite(m["total"]):
            raise AssertionError(f"adapt step {i}: loss {m['total']}")
        rows.append(dict(step=i, k=m["k"], total=m["total"],
                         style=m["style"], content=m["content"]))

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adapted = adapt_to_style(params0, vgg, train_config("bfloat16", True),
                             style, contents, steps=ADAPT_STEPS, lr=ADAPT_LR,
                             batch=ADAPT_BATCH, seed=0, log=logged.append,
                             device=DEVICE, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    before, after = flatten_params(params0), flatten_params(adapted)
    changed = [key for key in after if not torch.equal(after[key],
                                                       before[key])]
    others = [key for key in changed
              if not key.startswith("style_transformer/encoder/")]
    encoder = [key for key in after
               if key.startswith("style_transformer/encoder/")]
    out = dict(steps=ADAPT_STEPS, batch=ADAPT_BATCH, lr=ADAPT_LR,
               size=TRAIN_SIZE, dtype="bfloat16", wall_s=wall,
               imgs_per_s=ADAPT_STEPS * ADAPT_BATCH / wall,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               ks=[r["k"] for r in rows], first=rows[0], last=rows[-1],
               encoder_leaves=len(encoder),
               encoder_leaves_changed=len(changed) - len(others),
               other_leaves_changed=others, leaves=len(after),
               launches=launches, log=logged)
    emit("adapt", **out)
    if others or not changed:
        raise AssertionError(f"adaptation changed {others} (and "
                             f"{len(changed)} leaves in all)")
    return out


def train_batches(seed: int):
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(rng.random(
        (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
        dtype=np.float32)).to(DEVICE) for _ in range(2)) for _ in range(3)]


def mode_run(params0, vgg, batches, mode: str, on: bool) -> dict:
    """MODE_STEPS bf16 steps at each k of MODE_KS (stochastic depth on),
    with ``mode`` ("remat" or "accum") on or off, from one generator of a
    fixed seed; per step its launches, counted from zero, against the
    mode's table, loss, ms, imgs/s and peak memory."""
    cfg = train_config("bfloat16", True)
    if on:
        cfg = with_train(cfg, **({"remat": True} if mode == "remat"
                                 else {"grad_accum_steps": ACCUM}))
    table = ({"remat": remat_per_step, "accum": accum_per_step}[mode]
             if on else train_per_step)
    step = make_train_step(cfg, vgg, device=DEVICE)
    # an untimed step on a copy of its own: the timed run starts from
    # params0, so that its first loss compares across the modes
    step(create_train_state(clone_params(params0), cfg.train), *batches[0],
         torch.Generator().manual_seed(0), k=1)
    torch.cuda.synchronize()
    state = create_train_state(clone_params(params0), cfg.train)
    gen = torch.Generator().manual_seed(4000)
    rows, counted = [], []
    for i, k in enumerate(k for k in MODE_KS for _ in range(MODE_STEPS)):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, *batches[i % len(batches)], gen, k=k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per = all_launches()
        if per != table(k):
            raise AssertionError(f"{mode}={on} step {i} (k={k}) launched "
                                 f"{per}, expected {table(k)}")
        counted.append(per)
        if not np.isfinite(m["total"]):
            raise AssertionError(f"{mode}={on} step {i}: loss {m['total']}")
        rows.append(dict(step=i, k=k, loss=m["total"], ms=dt * 1e3,
                         imgs_per_s=TRAIN_BATCH / dt,
                         peak_mem_gib=torch.cuda.max_memory_allocated()
                         / 2 ** 30))
        emit(f"{mode}_step", on=on, **rows[-1])
    return dict(rows=rows, generator=gen.get_state(),
                imgs_per_s=float(np.mean([r["imgs_per_s"] for r in rows])),
                ms=float(np.mean([r["ms"] for r in rows])),
                peak_mem_gib=max(r["peak_mem_gib"] for r in rows),
                launches=table_sum(counted))


def run_modes(params0, vgg) -> dict:
    """remat and accum: their runs against the plain step's, and the first
    step's gradients of each mode at f32 and bf16 (stochastic depth off,
    since micro-batches draw other masks than the whole batch) by
    grad_checks' criteria against the f32 kernels-off plain step."""
    batches = train_batches(MODES_SEED + 2)
    content, style = batches[0]
    f32_off = no_depth_drop(train_config("float32", False))
    _, ref = first_step_grads(f32_off, params0, vgg, content, style, 100)
    moved = [first_step_grads(f32_off, params0, vgg, content * (1 + eps),
                              style, 100)[1] for eps in TRAIN_SPREAD_EPS]
    _, plain = first_step_grads(no_depth_drop(train_config("bfloat16",
                                                           False)),
                                params0, vgg, content, style, 100)
    plain_run = mode_run(params0, vgg, batches, "plain", False)
    out = {}
    for mode, fields in (("remat", {"remat": True}),
                         ("accum", {"grad_accum_steps": ACCUM})):
        grads = {dtype: first_step_grads(
            with_train(no_depth_drop(train_config(dtype, True)), **fields),
            params0, vgg, content, style, 100)[1]
            for dtype in ("float32", "bfloat16")}
        run = mode_run(params0, vgg, batches, mode, True)
        res = dict(f32=f32_verdict(grads["float32"], ref, moved),
                   bf16=bf16_verdict(grads["bfloat16"], plain, ref),
                   imgs_per_s=run["imgs_per_s"], ms=run["ms"],
                   peak_mem_gib=run["peak_mem_gib"],
                   plain_imgs_per_s=plain_run["imgs_per_s"],
                   plain_ms=plain_run["ms"],
                   plain_peak_mem_gib=plain_run["peak_mem_gib"],
                   generator_as_plain=bool(torch.equal(
                       run["generator"], plain_run["generator"])),
                   # equal on the first step; after it the weights
                   # carry cuDNN's run-to-run rounding (meta_checks)
                   losses_as_plain=[r["loss"] == p["loss"] for r, p in zip(
                       run["rows"], plain_run["rows"])],
                   launches=run["launches"], ks=list(MODE_KS),
                   steps_per_k=MODE_STEPS)
        emit(mode, **res)
        require(mode, {**res["f32"], **res["bf16"]})
        if mode == "remat" and not res["generator_as_plain"]:
            raise AssertionError("remat left the generator elsewhere")
        out[mode] = res
    return out


def run_new_training_modes() -> dict:
    """The phases of the meta step, fast adaptation, remat and
    accumulation, on the training phase's weights (``train_inputs``)."""
    t0 = time.perf_counter()
    params0, vgg, _ = train_inputs()
    tasks = meta_tasks(2)
    meta = {kernels: meta_run(params0, vgg, tasks, kernels)
            for kernels in (True, False)}
    emit("meta_summary", dtype="bfloat16", inner=META_INNER,
         batch=TRAIN_BATCH, size=TRAIN_SIZE,
         imgs_per_s_kernels_on=meta[True]["imgs_per_s_mean"],
         imgs_per_s_kernels_off=meta[False]["imgs_per_s_mean"],
         ms_kernels_on=meta[True]["ms_mean"],
         ms_kernels_off=meta[False]["ms_mean"],
         peak_mem_gib_on=meta[True]["peak_mem_gib"],
         peak_mem_gib_off=meta[False]["peak_mem_gib"])
    checks = meta_checks(params0, vgg, tasks[0])
    adapt = run_adapt(params0, vgg)
    modes = run_modes(params0, vgg)
    emit("training_modes", wall_s=time.perf_counter() - t0)
    return dict(meta=meta[True]["launches"], adapt=adapt["launches"],
                remat=modes["remat"]["launches"],
                accum=modes["accum"]["launches"], checks=checks)


# ---------------------------------------------------------------------------
# 8. the training entry point: image folders -> trainer.main
# ---------------------------------------------------------------------------

TRAINER_SEED = TRAIN_SEED + 6
# COCO's usual content size and a WikiArt-like style size, as JPEG files
# (the port's encoder, baseline 4:2:0 at TRAINER_QUALITY). At resize_to 512
# the contents decode at full size and the styles at 6/8 (the JAX loader's
# prescale), their chroma through 12 x 12 IDCTs.
TRAINER_CONTENTS, TRAINER_CONTENT_HW = 16, (480, 640)
# Beside them, one content file of each kind the JAX package reads through
# Pillow and the port now reads too, at COCO's size: a CMYK JPEG and an
# arithmetic-coded one (tests/data/jpeg_kinds/trainer_*.jpg), an Adam7 PNG
# and an 8-bit palette BMP (written here), a lossy WebP with alpha and a
# lossless one (tests/data/webp/trainer_*.webp: nothing here writes WebP).
# The batch loader takes the JAX loader's fallback for the first and the
# WebP files and its prescale for the second. And two JPEGs cut short, as
# a scraped folder holds them (tests/data/jpeg_damaged/trainer_cut_*.jpg:
# one with restart markers, one progressive): Pillow refuses both, the JAX
# loader's libjpeg reads them, the blocks past the cut grey or as the
# earlier scans left them, and so does the port's loader; their staged
# images are held to the JAX loader's digests.
TRAINER_KINDS = ("kind_cmyk.jpg", "kind_arith.jpg", "kind_adam7.png",
                 "kind_palette.bmp", "kind_webp_lossy_alpha.webp",
                 "kind_webp_lossless.webp", "kind_cut_restart.jpg",
                 "kind_cut_progressive.jpg")
TRAINER_STYLES, TRAINER_STYLE_HW = 4, (768, 1024)
TRAINER_RESIZE, TRAINER_EVERY, TRAINER_QUALITY = 512, 3, 95
# The evaluation kernels of one dump, master_apply on one 256^2 pair at
# bf16, k=1, kernels on (the serving batch's routes; a CPU test counts
# them with the wrappers made to see a card).
DUMP_PER_CALL = {**{e: 0 for e in all_launches()},
                 "window_block_rows": 4, "window_block_windows": 2,
                 "encoder_scale_shift": 1, "decoder_tail": 1,
                 "stencil_phase_conv": 5, "stencil_phase2_conv_padcols": 1,
                 "phase_align": 1}


def bmp_bytes(rgb: np.ndarray) -> bytes:
    """uint8 (H, W, 3) as an uncompressed 24-bit BMP, rows bottom-up."""
    h, w, _ = rgb.shape
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)
    header = (b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54)
              + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size,
                            2835, 2835, 0, 0))
    return header + rows.tobytes()


def write_bmp(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(bmp_bytes(rgb))


def read_image(path: str) -> np.ndarray:
    """An image file through the port's own readers (no Pillow there)."""
    with open(path, "rb") as f:
        return decode_image(f.read())


def smooth_images(rng, n: int, hw) -> list:
    """n smooth uint8 images (low-resolution noise, bilinear upsampled)."""
    base = torch.from_numpy(rng.random((n, 3, hw[0] // 32, hw[1] // 32),
                                       dtype=np.float32))
    up = F.interpolate(base, size=hw, mode="bilinear", align_corners=False)
    return list((up * 255).round().to(torch.uint8).permute(0, 2, 3, 1)
                .numpy())


class StepRecorder:
    """The trainer's step makers wrapped: at each step call, the kernel
    counts, the state's step and Adam's count, and the time; each step's
    metrics as it returns; ``check(state)`` on the first call."""

    def __init__(self, check=None):
        self.calls, self.metrics, self.check = [], [], check

    @contextlib.contextmanager
    def patched(self):
        made = (trainer.make_train_step, trainer.make_meta_train_step)

        def wrap(make):
            def maker(*args, **kwargs):
                step = make(*args, **kwargs)

                def run(state, *step_args):
                    if not self.calls and self.check is not None:
                        self.check(state)
                    self.calls.append(dict(launches=all_launches(),
                                           step=state.step,
                                           count=state.opt.count,
                                           t=time.perf_counter()))
                    state, m = step(state, *step_args)
                    self.metrics.append(dict(m, t=time.perf_counter()))
                    return state, m
                return run
            return maker

        trainer.make_train_step, trainer.make_meta_train_step = (
            wrap(m) for m in made)
        try:
            yield self
        finally:
            trainer.make_train_step, trainer.make_meta_train_step = made

    def per_iteration(self, end: dict) -> list:
        """Each iteration's launches: from its step call to the next one's
        (the last to ``end``), the dump between them included."""
        marks = [c["launches"] for c in self.calls] + [end]
        return [{e: b[e] - a[e] for e in a} for a, b in zip(marks, marks[1:])]


def trainer_run(tag: str, argv: list, expect, check=None) -> dict:
    """trainer.main(argv), its stdout kept; each iteration's launches held
    to ``expect(it, metrics)``; returns the recorder's rows."""
    rec = StepRecorder(check)
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with rec.patched(), contextlib.redirect_stdout(out):
        trainer.main(argv)
    wall = time.perf_counter() - t0
    per = rec.per_iteration(all_launches())
    first = rec.calls[0]["step"]
    for i, (counted, m) in enumerate(zip(per, rec.metrics)):
        want = expect(first + i + 1, m)
        if counted != want:
            raise AssertionError(f"trainer {tag} iteration {first + i + 1} "
                                 f"launched {counted}, expected {want}")
    return dict(calls=rec.calls, metrics=rec.metrics, wall_s=wall,
                launches=table_sum(per),
                stdout_lines=len(out.getvalue().splitlines()))


def read_jsonl(path: str) -> list:
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        bad = [k for k, v in r.items() if k != "ks" and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{path} step {r['step']}: {bad} not finite")
    return rows


def state_mismatches(state, leaves: dict) -> list:
    """The keys of ``state``'s checkpoint tree (``to_pytree``) whose
    leaf is not ``leaves``' bit for bit (dtype, shape and values), or is
    missing there or extra."""
    want = dict(to_pytree(state))
    bad = sorted(map(str, set(want) ^ set(leaves)))
    for k, v in want.items():
        got = leaves.get(k)
        if k not in leaves or (v is None) != (got is None):
            bad.append(str(k))
        elif v is not None and not (
                got.dtype == v.dtype and got.shape == v.shape
                and torch.equal(got.cpu(), v.detach().cpu())):
            bad.append(str(k))
    return bad


def check_restored(ckpt: str, step: int):
    """A check of the state the resumed trainer restored: every leaf,
    Adam's moments, the step and both of optax's counts equal checkpoint
    ``step``'s files (the JAX package's Orbax layout, read by
    ``utils/orbax.read_pytree``) bit for bit."""
    def check(state):
        bad = state_mismatches(state, read_pytree(os.path.join(
            ckpt, str(step))))
        if bad:
            raise AssertionError(f"restored state differs from checkpoint "
                                 f"{step}: {len(bad)} leaves, {bad[:4]}")
    return check


def check_dumps(exp: str, steps) -> list:
    """The dumps at ``steps``: 256x256x3 PNGs, not constant."""
    names = sorted(f for f in os.listdir(exp) if f.startswith("stylized_"))
    want = [f"stylized_{s}.png" for s in steps]
    if sorted(names) != sorted(want):
        raise AssertionError(f"{exp}: dumps {names}, expected {want}")
    stds = []
    for name in want:
        img = read_image(os.path.join(exp, name))
        if img.shape != (TRAIN_SIZE, TRAIN_SIZE, 3) or img.std() == 0:
            raise AssertionError(f"{name}: shape {img.shape}, std "
                                 f"{img.std()}")
        stds.append(float(img.std()))
    return stds


def kind_bodies(rng) -> dict:
    """The TRAINER_KINDS files' bytes: the two JPEGs of
    tests/data/jpeg_kinds/, an Adam7 RGB PNG and a 64-colour palette BMP
    of smooth images from ``rng`` at TRAINER_CONTENT_HW, the two WebP
    files of tests/data/webp/ and the two cut JPEGs of
    tests/data/jpeg_damaged/."""
    with open(os.path.join(KIND_DIRS["jpeg_kinds"],
                           "trainer_cmyk_adobe.jpg"), "rb") as f:
        cmyk = f.read()
    with open(os.path.join(KIND_DIRS["jpeg_kinds"],
                           "trainer_arith_420.jpg"), "rb") as f:
        arith = f.read()
    png_img, bmp_img = smooth_images(rng, 2, TRAINER_CONTENT_HW)
    palette = np.concatenate([rng.integers(0, 256, (64, 3), np.uint8),
                              np.zeros((64, 1), np.uint8)], 1)
    h, w = TRAINER_CONTENT_HW
    webp = []
    for name in ("trainer_lossy_alpha", "trainer_lossless"):
        with open(os.path.join(KIND_DIRS["webp"], f"{name}.webp"),
                  "rb") as f:
            webp.append(f.read())
    cut = []
    for name in ("trainer_cut_restart", "trainer_cut_progressive"):
        with open(os.path.join(DAMAGED_DIR, f"{name}.jpg"), "rb") as f:
            cut.append(f.read())
    return dict(zip(TRAINER_KINDS, (
        cmyk, arith, png_file(png_img, 8, 2, interlace=True),
        bmp_file(bmp_rows(bmp_img[:, :, 1] // 4, 8), w, h, 8,
                 palette=palette.tobytes(), colors=64), *webp, *cut)))


def trainer_folders(root: str):
    """The trainer phase's image folders under ``root``: TRAINER_CONTENTS
    content JPEGs and TRAINER_STYLES style JPEGs (the port's encoder at
    TRAINER_QUALITY), smooth images from TRAINER_SEED, and the
    TRAINER_KINDS files among the contents; returns (content dir, style
    dir)."""
    rng = np.random.default_rng(TRAINER_SEED)
    cdir, sdir = os.path.join(root, "coco"), os.path.join(root, "wikiart")
    for d, n, hw in ((cdir, TRAINER_CONTENTS, TRAINER_CONTENT_HW),
                     (sdir, TRAINER_STYLES, TRAINER_STYLE_HW)):
        os.makedirs(d)
        for i, img in enumerate(smooth_images(rng, n, hw)):
            with open(os.path.join(d, f"{i:03d}.jpg"), "wb") as f:
                f.write(encode_jpeg(img, TRAINER_QUALITY))
    for name, body in kind_bodies(rng).items():
        with open(os.path.join(cdir, name), "wb") as f:
            f.write(body)
    return cdir, sdir


def trainer_argv(cdir: str, sdir: str, exp: str, *extra) -> list:
    """The trainer phase's command line (the train phase's configuration,
    bf16, kernels on, checkpoints and dumps every TRAINER_EVERY)."""
    return ["--content_dir", cdir, "--style_dir", sdir, "--exp_dir", exp,
            "--batch_size", str(TRAIN_BATCH), "--crop_to", str(TRAIN_SIZE),
            "--resize_to", str(TRAINER_RESIZE), "--compute_dtype",
            "bfloat16", "--use_pallas", "--save_every", str(TRAINER_EVERY),
            "--save_every_for_model", str(TRAINER_EVERY), "--log_every",
            "1", "--seed", str(TRAINER_SEED), *extra]


def run_trainer(train: dict) -> dict:
    """The training entry point, ``trainer.main``, on image folders written
    here (TRAINER_CONTENTS content JPEGs and the TRAINER_KINDS files,
    TRAINER_STYLES style JPEGs, smooth images from a seed), at the train
    phase's configuration (swin_B,
    256^2 crops from 512^2 staging, batch 8, bf16, kernels on): plain for 6
    iterations, then resumed to 9; meta (4 inner updates) for 2; fast
    adaptation (batch 4) for 3; checkpoints and dumps every 3. Checks:
    one finite JSONL line per iteration; checkpoints 3, 6 and 9; the
    resumed run starts at step 6 with Adam's count 6, the restored state
    equal to checkpoint 6's files, its first lr the schedule's at count 6;
    each iteration's launches the step's table for its k (meta: the sum
    over its ks; fast adaptation: ``adapt_per_step``), plus
    ``DUMP_PER_CALL`` at a dump; the dumps 256x256x3 and not constant.
    Reports whether the native loader built, the loader's ms per batch of
    8 contents, of the 4 styles and of the 8 new kinds (two cut JPEGs
    among them, their staged images held to the JAX loader's), and the
    trainer's imgs/s over iterations 2-6 beside the train phase's step
    alone."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cdir, sdir = trainer_folders(tmp)
        t_native = time.perf_counter()
        native = native_available()
        native_s = time.perf_counter() - t_native
        ds = ImageFolderDataset(cdir, TRAINER_RESIZE, recursive=False)
        ds.get_batch(range(TRAIN_BATCH))
        t1 = time.perf_counter()
        for i in range(3):
            batch = ds.get_batch(range(i, i + TRAIN_BATCH))
        loader_ms = (time.perf_counter() - t1) / 3 * 1e3
        if batch.shape != (TRAIN_BATCH, TRAINER_RESIZE, TRAINER_RESIZE, 3):
            raise AssertionError(f"loader batch {batch.shape}")
        styles = ImageFolderDataset(sdir, TRAINER_RESIZE)
        style_loader_ms = host_ms(
            lambda: styles.get_batch(range(TRAINER_STYLES)), 3)
        # the new kinds, sorted after the numbered JPEGs: one batch of them
        kinds = list(range(TRAINER_CONTENTS, len(ds)))
        if [os.path.basename(ds.files[i]) for i in kinds] != sorted(
                TRAINER_KINDS):
            raise AssertionError(f"content files {ds.files}")
        kinds_loader_ms = host_ms(lambda: ds.get_batch(kinds), 3)
        digests = damaged_digests()
        for i in kinds:
            base = os.path.basename(ds.files[i])
            if not base.startswith("kind_cut_"):
                continue
            want = digests[f"trainer_cut_{base[9:-4]}"]["loader"][
                str(TRAINER_RESIZE)]
            got = digest_of(lambda: ds.get_batch([i])[0])
            if got is None or got != want:
                raise AssertionError(f"the loader on {base}: {got}, the "
                                     f"JAX loader's {want}")

        def argv(exp, *extra):
            return trainer_argv(cdir, sdir, os.path.join(tmp, exp), *extra)

        def expect(table):
            def want(it, m):
                t = table(m)
                if it % TRAINER_EVERY == 0:
                    t = table_sum([t, DUMP_PER_CALL])
                return t
            return want

        plain = expect(lambda m: train_per_step(m["k"]))
        runs = {"plain": trainer_run("plain", argv(
            "plain", "--max_iterations", "6"), plain)}
        ckpt = os.path.join(tmp, "plain", "checkpoints")
        runs["resume"] = trainer_run("resume", argv(
            "plain", "--max_iterations", "9", "--resume"), plain,
            check=check_restored(ckpt, 6))
        runs["meta"] = trainer_run("meta", argv(
            "meta", "--mode", "meta", "--num_inner_updates", "4",
            "--max_iterations", "2"),
            expect(lambda m: table_sum(train_per_step(k) for k in m["ks"])))
        fast = argv("fast", "--mode", "fast_adaptation", "--max_iterations",
                    "3")
        fast[fast.index("--batch_size") + 1] = "4"
        runs["fast_adaptation"] = trainer_run(
            "fast_adaptation", fast,
            expect(lambda m: adapt_per_step(m["k"])))

        logs = {name: read_jsonl(os.path.join(tmp, name, "metrics.jsonl"))
                for name in ("plain", "meta", "fast")}
        steps = {"plain": list(range(1, 10)), "meta": [1, 2],
                 "fast": [1, 2, 3]}
        for name, rows in logs.items():
            if [r["step"] for r in rows] != steps[name]:
                raise AssertionError(f"{name}: logged steps "
                                     f"{[r['step'] for r in rows]}")
        ckpts = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())
        if ckpts != [3, 6, 9]:
            raise AssertionError(f"checkpoints {ckpts}, expected 3, 6, 9")
        first = runs["resume"]["calls"][0]
        schedule = make_lr_schedule(trainer.config_from_args(
            trainer.build_argparser().parse_args(argv("plain"))).train)
        lr7 = logs["plain"][6]["lr"]
        if (first["step"], first["count"]) != (6, 6) or lr7 != schedule(6):
            raise AssertionError(f"resumed at step {first['step']}, count "
                                 f"{first['count']}, lr {lr7} (the "
                                 f"schedule's at 6: {schedule(6)})")
        stds = check_dumps(os.path.join(tmp, "plain"), (3, 6, 9))
        stds += check_dumps(os.path.join(tmp, "fast"), (3,))

    # imgs/s over iterations 2-6 of the first plain run, from its log:
    # the trainer logs B * i / (seconds since its loop began) at i.
    rows = logs["plain"]
    elapsed = [TRAIN_BATCH * r["step"] / r["imgs_per_sec"] for r in rows[:6]]
    calls, ms = runs["plain"]["calls"], runs["plain"]["metrics"]
    step_ms = [(m["t"] - c["t"]) * 1e3 for c, m in zip(calls[1:6], ms[1:6])]
    gap_ms = [(c["t"] - m["t"]) * 1e3 for m, c in zip(ms[1:5], calls[2:6])]
    out = dict(
        native_loader_built=native, native_build_s=native_s,
        loader_ms_per_batch=loader_ms, loader_batch=TRAIN_BATCH,
        loader_images=f"{TRAINER_CONTENT_HW[1]}x{TRAINER_CONTENT_HW[0]} "
                      f"4:2:0 JPEG q{TRAINER_QUALITY} -> "
                      f"{TRAINER_RESIZE}^2 (decoded at 8/8)",
        style_loader_ms_per_batch=style_loader_ms,
        style_loader_batch=TRAINER_STYLES,
        kinds_loader_ms_per_batch=kinds_loader_ms,
        kinds_loader_files=sorted(TRAINER_KINDS),
        contents=len(ds),
        style_loader_images=f"{TRAINER_STYLE_HW[1]}x{TRAINER_STYLE_HW[0]} "
                            f"4:2:0 JPEG q{TRAINER_QUALITY} -> "
                            f"{TRAINER_RESIZE}^2 (decoded at 6/8)",
        trainer_imgs_per_s_it2_6=TRAIN_BATCH * 5 / (elapsed[5] - elapsed[0]),
        step_alone_imgs_per_s=train["imgs_per_s_kernels_on"],
        step_alone_imgs_per_s_by_k=train["imgs_per_s_by_k_on"],
        trainer_ks=[int(r["k"]) for r in rows],
        step_ms_it2_6=float(np.mean(step_ms)),
        between_steps_ms_it2_5=float(np.mean(gap_ms)),
        meta_ks=[r["ks"] for r in logs["meta"]],
        fast_ks=[int(r["k"]) for r in logs["fast"]],
        resumed_at=(first["step"], first["count"]), resumed_lr=lr7,
        checkpoints=ckpts, dump_std=stds,
        run_wall_s={k: v["wall_s"] for k, v in runs.items()},
        launches=table_sum(r["launches"] for r in runs.values()),
        dump_per_call=DUMP_PER_CALL,
        wall_s=time.perf_counter() - t0)
    emit("trainer", **out)
    return out

# ---------------------------------------------------------------------------
# 8b. the JAX trainer's Orbax train-state checkpoints: the JAX-written
#     fixtures read and trained from on the card, the full-width save and
#     restore
# ---------------------------------------------------------------------------

ORBAX_SEED = TRAIN_SEED + 15
ORBAX_STEP, ORBAX_REPEATS = 9, 3


def fixture_per_step(cfg: ExperimentConfig, k: int) -> dict:
    """Launches of one training step of a JAX-written fixture's model
    (scripts/make_orbax_fixtures.py: one Swin block a stage at 32 and 64
    channels, the style transformer at 64, MLP ratio 1) at depth k with
    the Swin's and the style transformer's kernels on: K10 alone, at each
    Swin block forward and as ``train_per_step`` counts it in the style
    transformer (``adapt_per_step`` in fast adaptation). K8 and K9 keep to
    the JAX package's gate of 128-aligned widths
    (ops/attention.py:_pallas_dim_ok), and the decoder's kernels stay off:
    its stencil kernels want 32 channels after its third halving."""
    per = (adapt_per_step(k) if cfg.train.mode == "fast_adaptation"
           else train_per_step(k))
    out = {e: 0 for e in per}
    out["ln_mlp_residual"] = sum(cfg.model.swin.depths) + 5 * k
    out["ln_mlp_residual_bwd"] = per["ln_mlp_residual_bwd"]
    return out


def fixture_config(exp: str) -> ExperimentConfig:
    """A fixture's configuration (its config.json, the JAX package's), with
    the kernels on where its widths take them (``fixture_per_step``)."""
    with open(os.path.join(exp, "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    model = cfg.model.with_kernels()
    return cfg.replace(model=model.replace(
        decoder=model.decoder.replace(use_pallas=False)))


def leaf_sha(t: torch.Tensor) -> str:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def fixture_run(name: str, info: dict, tmp: str) -> dict:
    """One fixture: every array leaf read (``read_pytree``) against its
    digest; restored into a train state on the card at its config, equal
    to what was read; one step of its mode at k = 1, its launches exactly
    ``fixture_per_step``, its loss finite; the state written back with
    ``save_checkpoint`` and restored into a fresh state bit for bit."""
    exp = os.path.join(ORBAX_FIXTURES, name)
    step_dir = os.path.join(exp, str(info["step"]))
    t0 = time.perf_counter()
    leaves = read_pytree(step_dir)
    read_ms = (time.perf_counter() - t0) * 1e3
    want = {tuple(r["key"]): r for r in info["leaves"]}
    arrays = {k: v for k, v in leaves.items() if v is not None}
    if set(arrays) != set(want):
        raise AssertionError(f"{name}: leaves {len(arrays)}, digests "
                             f"{len(want)}")
    differ = [k for k, r in want.items() if (
        "bfloat16" if arrays[k].dtype == torch.bfloat16
        else str(arrays[k].numpy().dtype), list(arrays[k].shape),
        leaf_sha(arrays[k])) != (r["dtype"], r["shape"], r["sha256"])]
    if differ:
        raise AssertionError(f"{name}: {len(differ)} leaves differ from "
                             f"their digests: {differ[:4]}")
    cfg = fixture_config(exp)
    gen = torch.Generator().manual_seed(ORBAX_SEED)

    def fresh():
        return create_train_state(init_master_model(cfg.model, gen,
                                                    device=DEVICE),
                                  cfg.train)

    state = ckpt_lib.restore_checkpoint(exp, fresh())
    bad = state_mismatches(state, leaves)
    if bad or state.step != info["step"]:
        raise AssertionError(f"{name}: restored on the card: step "
                             f"{state.step}, {len(bad)} leaves differ "
                             f"{bad[:4]}")
    vgg = init_vgg19_features(gen, device=DEVICE)
    rng = np.random.default_rng(ORBAX_SEED)
    b, size = info["batch"], info["size"]
    content, style = (rng.random((b, size, size, 3), dtype=np.float32)
                      for _ in range(2))
    step_fn = make_train_step(cfg, vgg, device=DEVICE)
    reset_launches()
    state, metrics = step_fn(state, content, style, gen, k=1)
    torch.cuda.synchronize()
    launches = all_launches()
    table = fixture_per_step(cfg, 1)
    if launches != table:
        raise AssertionError(f"{name}: the step launched {launches}, "
                             f"expected {table}")
    if not all(np.isfinite(metrics[m]) for m in ("total", "content",
                                                 "style")):
        raise AssertionError(f"{name}: step metrics {metrics}")
    out_dir = os.path.join(tmp, name)
    ckpt_lib.save_checkpoint(out_dir, state, state.step)
    back = ckpt_lib.restore_checkpoint(out_dir, fresh())
    bad = state_mismatches(back, dict(to_pytree(state)))
    if bad or (back.step, back.opt.count) != (state.step, state.opt.count):
        raise AssertionError(f"{name}: written back and read: "
                             f"{len(bad)} leaves differ {bad[:4]}")
    dtypes = sorted({str(v.dtype) for v in arrays.values()})
    return dict(mode=info["mode"], layout=info["layout"],
                step=info["step"], leaves=len(arrays), differing=0,
                dtypes=dtypes, read_ms=read_ms,
                launches={e: n for e, n in launches.items() if n},
                loss=float(metrics["total"]), lr=float(metrics["lr"]),
                stepped_to=state.step, rewritten_exact=True)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def full_width_round_trip(tmp: str) -> dict:
    """The train phase's state (swin_B, the ModelConfig defaults; plain
    mode, the Swin frozen) with Adam's moments drawn from a seed, written
    by ``save_checkpoint`` and restored into a fresh state on the card
    ORBAX_REPEATS times each: the host ms of each (the device-to-host and
    host-to-device copies included; the files read warm from the page
    cache), the checkpoint's MB, and the restored state bit for bit."""
    cfg = train_config("bfloat16", True)
    gen = torch.Generator().manual_seed(ORBAX_SEED + 1)
    state = create_train_state(init_master_model(cfg.model, gen,
                                                 device=DEVICE), cfg.train)
    with torch.no_grad():
        for m, v in zip(state.opt.mu, state.opt.nu):
            m.copy_(torch.randn(m.shape, generator=gen) * 1e-3)
            v.copy_(torch.rand(v.shape, generator=gen) * 1e-6)
    state.step = state.opt.count = ORBAX_STEP
    ckpt = os.path.join(tmp, "full_width")
    save_ms, restore_ms = [], []
    for _ in range(ORBAX_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt_lib.save_checkpoint(ckpt, state, ORBAX_STEP)
        save_ms.append((time.perf_counter() - t0) * 1e3)
    fresh = create_train_state(init_master_model(cfg.model, gen,
                                                 device=DEVICE), cfg.train)
    for _ in range(ORBAX_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt_lib.restore_checkpoint(ckpt, fresh)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
    bad = state_mismatches(fresh, dict(to_pytree(state)))
    if bad or (fresh.step, fresh.opt.count) != (ORBAX_STEP, ORBAX_STEP):
        raise AssertionError(f"full-width round trip: {len(bad)} leaves "
                             f"differ {bad[:4]}")
    step_dir = os.path.join(ckpt, str(ORBAX_STEP))
    leaves = [k for k, v in to_pytree(state) if v is not None]
    return dict(params=sum(v.numel() for v in flatten_params(
        state.params).values()), array_leaves=len(leaves),
        files=sum(len(f) for _, _, f in os.walk(step_dir)),
        mb=dir_bytes(step_dir) / 1e6, save_ms=save_ms,
        restore_ms=restore_ms, save_ms_median=float(np.median(save_ms)),
        restore_ms_median=float(np.median(restore_ms)))


def run_orbax(smi: str) -> dict:
    """The JAX trainer's Orbax train-state checkpoints on the card, with
    no JAX, Orbax or tensorstore: each committed JAX-written fixture
    (tests/data/orbax/, one per layout: OCDBT, and a zarr directory per
    leaf with bfloat16 leaves among them) through ``fixture_run``, and the
    full-width checkpoint's save and restore (``full_width_round_trip``).
    The trainer phase writes and resumes its checkpoints in the same
    layout."""
    t0 = time.perf_counter()
    with open(os.path.join(ORBAX_FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    if sorted(digests) != ["fast_adaptation_leaves", "plain_ocdbt"]:
        raise AssertionError(f"fixtures {sorted(digests)}")
    with tempfile.TemporaryDirectory() as tmp:
        fixtures = {name: fixture_run(name, info, tmp)
                    for name, info in sorted(digests.items())}
        full = full_width_round_trip(tmp)
    out = dict(fixtures=fixtures, full_width=full, card=smi,
               wall_s=time.perf_counter() - t0)
    emit("orbax", **out)
    return out


# ---------------------------------------------------------------------------
# 9. the evaluation and weight entry points: the content x style grid, the
#    adaptation command line, weight conversion, loss calibration
# ---------------------------------------------------------------------------

EVAL_SEED = TRAIN_SEED + 7
# The JAX package's grid (goals.txt:34: the reference's 11 contents x 20
# styles) at its command line's defaults, 256^2 and a style batch of 8, on
# BMP files of COCO's and WikiArt's usual sizes.
EVAL_CONTENTS, EVAL_STYLES, EVAL_SIZE, EVAL_STYLE_BATCH = 11, 20, 256, 8
# (dtype, kernels, k) of each grid run; the kernels-off runs are the
# references.
EVAL_RUNS = (("float32", False, 1), ("float32", True, 1),
             ("float32", False, 3), ("float32", True, 3),
             ("bfloat16", False, 1), ("bfloat16", True, 1))
TOL_EVAL_LOSS = 1e-4
EVAL_LOSSES = ("total", "content", "style")
ADAPT_CLI_STEPS, ADAPT_CLI_BATCH = 20, 4
CONVERT_SEED = TRAIN_SEED + 8
CONVERT_KINDS = ("swin", "vgg19", "style_transformer", "decoder",
                 "seed_from_swin", "whole_model")


def eval_per_grid(dtype: str, k: int, contents: int, styles: int) -> dict:
    """Launches of one grid with the kernels on: a stream build per style
    chunk (``locked_per_stream``: the chunk's Swin, then K2 and K3 k times)
    and, per (content, chunk), the tiled content's Swin, the decoder half
    and the decoder (``locked_per_batch``)."""
    chunks = -(-styles // EVAL_STYLE_BATCH)
    return table_sum([
        {e: chunks * n for e, n in locked_per_stream(dtype, k).items()},
        {e: chunks * contents * n
         for e, n in locked_per_batch(dtype, k).items()}])


def run_label(dtype: str, kernels: bool, k: int) -> str:
    return f"{dtype}_{'on' if kernels else 'off'}_k{k}"


@contextlib.contextmanager
def recorded_grid(images: dict, stream_s: list):
    """The harness with each pair's stylized image kept in ``images`` by
    its file's stem instead of written, and each stream build's time, from
    a synchronize before it to one after it, appended to ``stream_s``."""
    save, encode = eval_harness._save_image, eval_harness.encode_style_stream

    def keep(img01, path):
        images[os.path.splitext(os.path.basename(path))[0]] = img01

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = encode(*args, **kwargs)
        torch.cuda.synchronize()
        stream_s.append(time.perf_counter() - t)
        return out

    eval_harness._save_image, eval_harness.encode_style_stream = keep, timed
    try:
        yield
    finally:
        eval_harness._save_image, eval_harness.encode_style_stream = (
            save, encode)


def eval_folders(root: str) -> dict:
    """EVAL_CONTENTS content BMPs at 640x480 and EVAL_STYLES style BMPs at
    1024x768 (smooth images from EVAL_SEED) under root."""
    rng = np.random.default_rng(EVAL_SEED)
    dirs = {}
    for name, n, hw in (("content", EVAL_CONTENTS, TRAINER_CONTENT_HW),
                        ("style", EVAL_STYLES, TRAINER_STYLE_HW)):
        dirs[name] = os.path.join(root, name)
        os.makedirs(dirs[name])
        for i, img in enumerate(smooth_images(rng, n, hw)):
            write_bmp(os.path.join(dirs[name], f"{name}{i:02d}.bmp"), img)
    return dirs


def grid_run(params, vgg, cfg: ExperimentConfig, k: int, grid: dict,
             scratch: str) -> dict:
    """``evaluate_grid`` on the grid's images at depth k: the report, each
    pair's image, the launches counted from zero, the wall time (the
    harness copies each call's output to the host, so the wall ends with
    the card's work), the stream builds' time."""
    images, stream_s = {}, []
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_grid(images, stream_s):
        report = evaluate_grid(
            params, vgg, cfg, content_images=grid["content"],
            style_images=grid["style"], content_names=grid["cnames"],
            style_names=grid["snames"], k=k, style_batch=EVAL_STYLE_BATCH,
            save_images_to=scratch, device=DEVICE)
    wall = time.perf_counter() - t0
    calls = len(grid["cnames"]) * -(-len(grid["snames"]) // EVAL_STYLE_BATCH)
    pairs = [(c, s) for c in grid["cnames"] for s in grid["snames"]]
    if report.pairs != pairs:
        raise AssertionError("the grid's pairs are not every content x "
                             "style in order")
    losses = np.array([getattr(report, n) for n in EVAL_LOSSES])
    if not np.isfinite(losses).all():
        raise AssertionError("a grid loss is not finite")
    return dict(report=report, losses=losses, launches=all_launches(),
                images=np.stack([images[f"{eval_harness._stem(c)}__"
                                        f"{eval_harness._stem(s)}"]
                                 for c, s in pairs]),
                wall_s=wall, stream_builds_ms=[t * 1e3 for t in stream_s],
                pairs_per_s=len(pairs) / wall,
                ms_per_call=(wall - sum(stream_s)) / calls * 1e3,
                calls=calls)


def grid_equal(a: dict, b: dict) -> bool:
    return bool(np.array_equal(a["losses"], b["losses"])
                and np.array_equal(a["images"], b["images"]))


def run_eval(root: str, smi: str) -> dict:
    """The grid (``evaluate_grid``) at the JAX command line's shape: f32
    with the kernels on and off at k = 1 and 3, bf16 on and off at k = 1
    (each after an untimed grid of one content and one style chunk), each
    run's launches exact against ``eval_per_grid`` (none with the
    kernels off); f32 kernels on against off, each pair's losses within
    TOL_EVAL_LOSS relative and the outputs by the slice's f32 criterion;
    bf16 by the services' noise ratio against the f32 kernels-off outputs;
    then ``eval.cli.main --use_pallas`` on the same folders, its launches
    and its 220 JPEG dumps (quality 95, read back by the port's decoder)."""
    t0 = time.perf_counter()
    dirs = eval_folders(os.path.join(root, "eval"))
    content, cnames = load_eval_images(dirs["content"], EVAL_SIZE)
    styles, snames = load_eval_images(dirs["style"], EVAL_SIZE)
    grid = dict(content=content, style=styles, cnames=cnames, snames=snames)
    gen = torch.Generator().manual_seed(EVAL_SEED)
    params = init_master_model(ModelConfig(), gen, device=DEVICE)
    vgg = init_vgg19_features(gen, device=DEVICE)
    scratch = os.path.join(root, "eval_scratch")
    # one content against one style chunk, untimed, ahead of each run:
    # cuDNN's plans and the first launches
    warm = dict(content=content[:1], style=styles[:EVAL_STYLE_BATCH],
                cnames=cnames[:1], snames=snames[:EVAL_STYLE_BATCH])
    runs, rows = {}, {}
    for dtype, kernels, k in EVAL_RUNS:
        label = run_label(dtype, kernels, k)
        cfg = ExperimentConfig(model=slice_config(dtype, kernels))
        grid_run(params, vgg, cfg, k, warm, scratch)
        run = runs[label] = grid_run(params, vgg, cfg, k, grid, scratch)
        want = (eval_per_grid(dtype, k, EVAL_CONTENTS, EVAL_STYLES)
                if kernels else {e: 0 for e in run["launches"]})
        if run["launches"] != want:
            raise AssertionError(f"eval {label} launched {run['launches']}, "
                                 f"expected {want}")
        row = dict(dtype=dtype, kernels=kernels, k=k,
                   pairs=len(run["report"].pairs), wall_s=run["wall_s"],
                   pairs_per_s=run["pairs_per_s"], calls=run["calls"],
                   ms_per_call=run["ms_per_call"],
                   stream_builds_ms=run["stream_builds_ms"],
                   summary=run["report"].summary(), launches=run["launches"],
                   nvidia_smi=smi)
        if kernels:
            ref = runs[run_label("float32", False, k)]
            if dtype == "float32":
                rel = np.abs(run["losses"] - ref["losses"]) / np.abs(
                    ref["losses"])
                check = dict(loss_rel_max=float(rel.max()),
                             loss_rel_tol=TOL_EVAL_LOSS,
                             **f32_check(run["images"], ref["images"]))
                check["ok"] = bool(check["ok"] and rel.max() <= TOL_EVAL_LOSS)
            else:
                plain = runs[run_label(dtype, False, k)]
                check = bf16_noise_verdict(run["images"], plain["images"],
                                           ref["images"])
            row["check"] = check
        emit("eval", **row)
        if kernels:
            require(f"eval {label}", row["check"])
        rows[label] = row
    del runs
    out_dir = os.path.join(root, "eval_cli")
    argv = ["--content_dir", dirs["content"], "--style_dir", dirs["style"],
            "--image_size", str(EVAL_SIZE), "--use_pallas",
            "--save_images_to", out_dir, "--device", DEVICE]
    reset_launches()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = eval_cli.main(argv)
    cli_wall = time.perf_counter() - t1
    cli_launches = all_launches()
    want = eval_per_grid("float32", 1, EVAL_CONTENTS, EVAL_STYLES)
    if cli_launches != want or summary["num_pairs"] != (EVAL_CONTENTS
                                                         * EVAL_STYLES):
        raise AssertionError(f"eval.cli launched {cli_launches} for "
                             f"{summary['num_pairs']} pairs, expected {want}")
    jpegs = sorted(f for f in os.listdir(out_dir) if f.endswith(".jpg"))
    if len(jpegs) != EVAL_CONTENTS * EVAL_STYLES:
        raise AssertionError(f"eval.cli wrote {len(jpegs)} JPEGs")
    for name in jpegs:
        shape = read_image(os.path.join(out_dir, name)).shape
        if shape != (EVAL_SIZE, EVAL_SIZE, 3):
            raise AssertionError(f"{name}: shape {shape}")
    cli = dict(wall_s=cli_wall, pairs_per_s=summary["num_pairs"] / cli_wall,
               jpegs=len(jpegs), summary=summary, launches=cli_launches)
    emit("eval_cli", **cli, nvidia_smi=smi)
    launches = {label: row["launches"] for label, row in rows.items()
                if row["kernels"]}
    launches["cli"] = cli_launches
    return dict(dirs=dirs, launches=launches, rows=rows, cli=cli,
                wall_s=time.perf_counter() - t0)


class AdaptRecorder:
    """``adapt.make_train_step`` wrapped: the kernel counts before and
    after each step, and each step's k."""

    def __init__(self):
        self.before, self.after, self.ks = [], [], []

    @contextlib.contextmanager
    def patched(self):
        make = adapt_cli.make_train_step

        def maker(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(*step_args):
                self.before.append(all_launches())
                state, m = step(*step_args)
                self.after.append(all_launches())
                self.ks.append(m["k"])
                return state, m
            return run

        adapt_cli.make_train_step = maker
        try:
            yield self
        finally:
            adapt_cli.make_train_step = make


def run_adapt_cli(root: str, dirs: dict, smi: str) -> dict:
    """``adapt.main --use_pallas`` with the JAX command line's defaults (20
    steps of batch 4 at 256^2, k = 1 for the stylized outputs) on the eval
    phase's first style and its contents, under deterministic algorithms:
    each step's launches ``adapt_per_step`` of its k, then one f32
    ``master_apply`` per content (``PER_BATCH``); ``adapted.npz`` equal bit
    for bit to ``adapt_to_style`` called directly on the same decoded
    images and weights; one 256x256x3 JPEG per content."""
    style = os.path.join(dirs["style"], sorted(os.listdir(dirs["style"]))[0])
    out_dir = os.path.join(root, "adapted")
    argv = ["--style", style, "--content_dir", dirs["content"],
            "--out_dir", out_dir, "--steps", str(ADAPT_CLI_STEPS),
            "--batch", str(ADAPT_CLI_BATCH), "--image_size", str(EVAL_SIZE),
            "--use_pallas", "--device", DEVICE]
    rec = AdaptRecorder()
    with deterministic_algorithms() as caught, rec.patched(), \
            contextlib.redirect_stdout(io.StringIO()):
        reset_launches()
        t0 = time.perf_counter()
        adapt_cli.main(argv)
        wall = time.perf_counter() - t0
        end = all_launches()
    for i, (a, b, k) in enumerate(zip(rec.before, rec.after, rec.ks)):
        per = {e: b[e] - a[e] for e in a}
        if per != adapt_per_step(k):
            raise AssertionError(f"adapt.main step {i} (k={k}) launched "
                                 f"{per}, expected {adapt_per_step(k)}")
    stylize = {e: end[e] - rec.after[-1][e] for e in end}
    n = len(os.listdir(dirs["content"]))
    expect_launches("adapt.main's stylize calls", stylize,
                    PER_BATCH["float32"], n)
    if len(rec.ks) != ADAPT_CLI_STEPS:
        raise AssertionError(f"adapt.main ran {len(rec.ks)} steps")

    cfg = ExperimentConfig()
    cfg = cfg.replace(model=cfg.model.with_kernels())
    params = init_master_model(
        cfg.model, torch.Generator().manual_seed(adapt_cli.WEIGHTS_SEED),
        device=DEVICE)
    vgg = trainer.load_vgg_params(None, DEVICE)
    files = list_images(dirs["content"])
    contents = np.stack([_decode_resize(f, EVAL_SIZE).astype(np.float32)
                         / 255.0 for f in files])
    style_img = _decode_resize(style, EVAL_SIZE).astype(np.float32) / 255.0
    with deterministic_algorithms():
        direct = flatten_params(adapt_to_style(
            params, vgg, cfg, style_img, contents, steps=ADAPT_CLI_STEPS,
            lr=1e-4, batch=ADAPT_CLI_BATCH, seed=0, log=lambda s: None,
            device=DEVICE))
    with np.load(os.path.join(out_dir, "adapted.npz")) as data:
        diff = [key for key, t in direct.items()
                if not np.array_equal(data[key], t.cpu().numpy())]
        if diff or set(data.files) != set(direct):
            raise AssertionError(f"adapted.npz differs from adapt_to_style "
                                 f"in {diff[:4]}")
    jpegs = sorted(f for f in os.listdir(out_dir) if f.endswith(".jpg"))
    if len(jpegs) != n or any(read_image(os.path.join(out_dir, p)).shape
                              != (EVAL_SIZE, EVAL_SIZE, 3) for p in jpegs):
        raise AssertionError(f"adapt.main wrote {jpegs}")
    out = dict(steps=ADAPT_CLI_STEPS, batch=ADAPT_CLI_BATCH, size=EVAL_SIZE,
               dtype="float32", contents=n, ks=rec.ks, wall_s=wall,
               step_launches=table_sum(
                   {e: b[e] - a[e] for e in a}
                   for a, b in zip(rec.before, rec.after)),
               stylize_launches=stylize, launches=end,
               adapted_equal_direct=True, jpegs=len(jpegs),
               nondeterministic_ops=sorted({str(w.message)[:80]
                                            for w in caught}),
               nvidia_smi=smi)
    emit("adapt_cli", **out)
    return out


def randn(gen, *shape, std=0.02) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def linear_sd(gen, prefix: str, n_out: int, n_in: int) -> dict:
    return {f"{prefix}.weight": randn(gen, n_out, n_in),
            f"{prefix}.bias": randn(gen, n_out)}


def norm_sd(gen, prefix: str, n: int) -> dict:
    return {f"{prefix}.weight": 1 + randn(gen, n),
            f"{prefix}.bias": randn(gen, n)}


def mlp_sd(gen, prefix: str, d: int) -> dict:
    return {**linear_sd(gen, f"{prefix}.0", 4 * d, d),
            **linear_sd(gen, f"{prefix}.3", d, 4 * d)}


def conv_sd(gen, prefix: str, c_out: int, c_in: int, k: int = 3) -> dict:
    return {f"{prefix}.weight": randn(gen, c_out, c_in, k, k,
                                      std=(2.0 / (c_in * k * k)) ** 0.5),
            f"{prefix}.bias": randn(gen, c_out)}


def swin_state_dict(gen, cfg) -> dict:
    """torchvision's swin features[:4] at ``cfg``'s widths: "0.0" the patch
    conv, "0.2" its norm, "1.{b}" and "3.{b}" the blocks (fused qkv), "2"
    PatchMerging."""
    e = cfg.embed_dim
    wh, ww = cfg.window_size
    sd = {**conv_sd(gen, "0.0", e, 3, 4), **norm_sd(gen, "0.2", e),
          **norm_sd(gen, "2.norm", 4 * e),
          "2.reduction.weight": randn(gen, 2 * e, 4 * e)}
    for seq, stage in (("1", 0), ("3", 1)):
        d, heads = e * 2 ** stage, cfg.num_heads[stage]
        for b in range(cfg.depths[stage]):
            p = f"{seq}.{b}"
            sd.update({**norm_sd(gen, f"{p}.norm1", d),
                       **linear_sd(gen, f"{p}.attn.qkv", 3 * d, d),
                       **linear_sd(gen, f"{p}.attn.proj", d, d),
                       f"{p}.attn.relative_position_bias_table": randn(
                           gen, (2 * wh - 1) * (2 * ww - 1), heads),
                       f"{p}.attn.relative_position_index": torch.zeros(
                           wh * ww * wh * ww, dtype=torch.int64),
                       **norm_sd(gen, f"{p}.norm2", d),
                       **mlp_sd(gen, f"{p}.mlp", d)})
    return sd


def style_transformer_state_dict(gen, d: int = ST_C,
                                 heads: int = ST_HEADS) -> dict:
    """The reference's StyleTransformer state dict, default form (dual-MHA
    tail, decoder self block with both norms and its MLP)."""
    sd = {}

    def attn(prefix, names=("Wq", "Wk", "Wv")):
        for name in names + ("proj",):
            sd.update(linear_sd(gen, f"{prefix}.{name}", d, d))
        sd[f"{prefix}.relative_position_bias_table"] = randn(gen, 169, heads)

    attn("encoder.shared_MHA_without_MLP.attn")
    for name in ("Key", "Scale", "Shift"):
        sd.update(mlp_sd(gen, f"encoder.encoder_MLP_{name}", d))
    attn("decoder.MHA_self_attn.attn")
    sd.update({**norm_sd(gen, "decoder.MHA_self_attn.norm1", d),
               **norm_sd(gen, "decoder.MHA_self_attn.norm2", d),
               **mlp_sd(gen, "decoder.MHA_self_attn.mlp", d)})
    attn("decoder.decoder_MHA_for_sigma_and_mu", ("Wk", "Wv_scale",
                                                  "Wv_shift"))
    sd.update(mlp_sd(gen, "decoder.last_MLP", d))
    return sd


DECODER_CONV_IDX = (0, 3, 5, 7, 9, 12, 14, 17, 19)
VGG19_CONVS = ((3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
               (256, 256), (256, 256), (256, 256), (256, 512), (512, 512),
               (512, 512), (512, 512), (512, 512))


def decoder_state_dict(gen, c: int = ST_C) -> dict:
    """The reference's Decoder state dict: nine convs in a Sequential."""
    sd = {}
    for i, (ci, co, _) in zip(DECODER_CONV_IDX, _channel_plan(c)):
        sd.update(conv_sd(gen, f"decoder.{i}", co, ci))
    return sd


def vgg19_state_dict(gen, bn: bool) -> dict:
    """vgg19(_bn).features as torchvision initializes it (kaiming-normal
    convs, zero biases; batch norm weight 1, bias 0, mean 0, var 1)."""
    idxs = (tconvert._VGG19_BN_CONV_IDX if bn else tconvert._VGG19_CONV_IDX)
    sd = {}
    for i, (ci, co) in zip(idxs, VGG19_CONVS):
        sd[f"features.{i}.weight"] = randn(gen, co, ci, 3, 3,
                                           std=(2.0 / (co * 9)) ** 0.5)
        sd[f"features.{i}.bias"] = torch.zeros(co)
        if bn:
            sd.update({f"features.{i + 1}.weight": torch.ones(co),
                       f"features.{i + 1}.bias": torch.zeros(co),
                       f"features.{i + 1}.running_mean": torch.zeros(co),
                       f"features.{i + 1}.running_var": torch.ones(co),
                       f"features.{i + 1}.num_batches_tracked":
                           torch.tensor(0)})
    return sd


def reference_state_dicts(gen) -> dict:
    """The state dicts of each conversion at full width (swin_B, the style
    transformer 256 wide with 8 heads, the decoder at 256 channels), by
    command-line kind; ``whole_model`` is the three under
    codes/full_model.py's attribute names."""
    swin = swin_state_dict(gen, ModelConfig().swin)
    st, dec = style_transformer_state_dict(gen), decoder_state_dict(gen)
    return {"swin": swin, "vgg19": vgg19_state_dict(gen, False),
            "style_transformer": st, "decoder": dec, "seed_from_swin": swin,
            "whole_model": {
                **{f"swin_encoder.{k}": v for k, v in swin.items()},
                **{f"style_transformer.{k}": v for k, v in st.items()},
                **{f"decoder.{k}": v for k, v in dec.items()}}}


def expected_leaves(kind: str, sd: dict) -> dict:
    """The flat .npz a conversion must write, from the state dict (numpy)
    by the layout rules: a Linear weight transposed, a conv weight to HWIO,
    a fused qkv split into thirds, norms' weight to scale, and, for
    seed_from_swin, the stage-2 block "3.1" copied into every attention
    and MLP of the style transformer (its dual attention's values both
    from v)."""
    def lin(prefix, out_key):
        out = {f"{out_key}/kernel": sd[f"{prefix}.weight"].T}
        if f"{prefix}.bias" in sd:
            out[f"{out_key}/bias"] = sd[f"{prefix}.bias"]
        return out

    def norm(prefix, out_key):
        return {f"{out_key}/scale": sd[f"{prefix}.weight"],
                f"{out_key}/bias": sd[f"{prefix}.bias"]}

    def conv(prefix, out_key):
        return {f"{out_key}/kernel": sd[f"{prefix}.weight"].transpose(
            2, 3, 1, 0), f"{out_key}/bias": sd[f"{prefix}.bias"]}

    def qkv(prefix, out_key, names=("wq", "wk", "wv")):
        w, b = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
        c = w.shape[0] // 3
        out = {}
        for name in names:
            i = {"wq": 0, "wk": 1, "wv": 2, "wv_scale": 2, "wv_shift": 2}[name]
            out[f"{out_key}/{name}/kernel"] = w[i * c:(i + 1) * c].T
            out[f"{out_key}/{name}/bias"] = b[i * c:(i + 1) * c]
        return out

    def mlp(prefix, out_key, fc=(".0", ".3")):
        return {**lin(prefix + fc[0], f"{out_key}/fc1"),
                **lin(prefix + fc[1], f"{out_key}/fc2")}

    def swin(pre=""):
        out = {**conv(f"{pre}0.0", "patch_embed/conv"),
               **norm(f"{pre}0.2", "patch_embed/norm"),
               **norm(f"{pre}2.norm", "patch_merge/norm"),
               "patch_merge/reduction/kernel":
                   sd[f"{pre}2.reduction.weight"].T}
        for seq, stage in (("1", 0), ("3", 1)):
            for b in range(2):
                p, o = f"{pre}{seq}.{b}", f"stage{stage}_block{b}"
                out.update({**qkv(f"{p}.attn.qkv", f"{o}/attn"),
                            **lin(f"{p}.attn.proj", f"{o}/attn/proj"),
                            f"{o}/attn/rel_bias_table": sd[
                                f"{p}.attn.relative_position_bias_table"],
                            **norm(f"{p}.norm1", f"{o}/norm1"),
                            **norm(f"{p}.norm2", f"{o}/norm2"),
                            **mlp(f"{p}.mlp", f"{o}/mlp")})
        return out

    def attn(prefix, out_key, names=("wq", "wk", "wv")):
        out = {**lin(f"{prefix}.proj", f"{out_key}/proj"),
               f"{out_key}/rel_bias_table": sd[
                   f"{prefix}.relative_position_bias_table"]}
        for name in names:
            torch_name = {"wq": "Wq", "wk": "Wk", "wv": "Wv",
                          "wv_scale": "Wv_scale",
                          "wv_shift": "Wv_shift"}[name]
            out.update(lin(f"{prefix}.{torch_name}", f"{out_key}/{name}"))
        return out

    def style_transformer(pre=""):
        e, d = f"{pre}encoder.", f"{pre}decoder."
        out = {**attn(f"{e}shared_MHA_without_MLP.attn",
                      "encoder/shared_mha/attn"),
               **attn(f"{d}MHA_self_attn.attn", "decoder/self_mha/attn"),
               **norm(f"{d}MHA_self_attn.norm1", "decoder/self_mha/norm1"),
               **norm(f"{d}MHA_self_attn.norm2", "decoder/self_mha/norm2"),
               **mlp(f"{d}MHA_self_attn.mlp", "decoder/self_mha/mlp"),
               **attn(f"{d}decoder_MHA_for_sigma_and_mu", "decoder/dual_mha",
                      ("wk", "wv_scale", "wv_shift")),
               **mlp(f"{d}last_MLP", "decoder/last_mlp")}
        for name in ("key", "scale", "shift"):
            out.update(mlp(f"{e}encoder_MLP_{name.title()}",
                           f"encoder/mlp_{name}"))
        return out

    def decoder(pre=""):
        return {k: v for n, i in enumerate(DECODER_CONV_IDX)
                for k, v in conv(f"{pre}decoder.{i}", f"conv{n}").items()}

    if kind == "swin":
        return swin()
    if kind == "vgg19":
        return {k: v for n, i in enumerate(tconvert._VGG19_CONV_IDX)
                for k, v in conv(f"features.{i}", f"conv{n}").items()}
    if kind == "style_transformer":
        return style_transformer()
    if kind == "decoder":
        return decoder()
    if kind == "whole_model":
        return {**{f"swin/{k}": v for k, v in swin("swin_encoder.").items()},
                **{f"style_transformer/{k}": v for k, v in
                   style_transformer("style_transformer.").items()},
                **{f"decoder/{k}": v for k, v in decoder("decoder.").items()}}
    # seed_from_swin: the stage-2 block 3.1 everywhere
    blk = "3.1"
    out = {}
    for o in ("encoder/shared_mha/attn", "decoder/self_mha/attn"):
        out.update({**qkv(f"{blk}.attn.qkv", o),
                    **lin(f"{blk}.attn.proj", f"{o}/proj"),
                    f"{o}/rel_bias_table": sd[
                        f"{blk}.attn.relative_position_bias_table"]})
    out.update({**qkv(f"{blk}.attn.qkv", "decoder/dual_mha",
                      ("wk", "wv_scale", "wv_shift")),
                **lin(f"{blk}.attn.proj", "decoder/dual_mha/proj"),
                "decoder/dual_mha/rel_bias_table": sd[
                    f"{blk}.attn.relative_position_bias_table"],
                **norm(f"{blk}.norm1", "decoder/self_mha/norm1"),
                **norm(f"{blk}.norm2", "decoder/self_mha/norm2")})
    for o in ("encoder/mlp_key", "encoder/mlp_scale", "encoder/mlp_shift",
              "decoder/self_mha/mlp", "decoder/last_mlp"):
        out.update(mlp(f"{blk}.mlp", o))
    return out


def run_convert(root: str, grid_dirs: dict, smi: str) -> dict:
    """Each ``convert_cli`` kind on full-width state dicts written with
    ``torch.save``: its .npz holds exactly ``expected_leaves``, bit for
    bit; then the grid (f32, kernels on, k=1, deterministic algorithms)
    from the converted whole model read back from its .npz equals, bit for
    bit, the grid from the same conversion passed in memory."""
    t0 = time.perf_counter()
    sds = reference_state_dicts(torch.Generator().manual_seed(CONVERT_SEED))
    files = {}
    for kind in CONVERT_KINDS:
        pt = os.path.join(root, f"{kind}.pt")
        npz = files[kind] = os.path.join(root, f"{kind}.npz")
        torch.save(sds[kind], pt)
        with contextlib.redirect_stdout(io.StringIO()):
            convert_cli.main([kind, "--input", pt, "--output", npz])
        want = expected_leaves(kind, {k: v.numpy() for k, v in
                                      sds[kind].items()})
        with np.load(npz) as data:
            bad = [k for k in want if k not in data.files
                   or data[k].dtype != np.float32
                   or not np.array_equal(data[k], want[k])]
            if bad or set(data.files) != set(want):
                raise AssertionError(
                    f"convert_cli {kind}: leaves {bad[:4]} differ, or keys "
                    f"{sorted(set(data.files) ^ set(want))[:4]}")
    cfg = ExperimentConfig(model=slice_config("float32", True))
    template = init_master_model(
        cfg.model, torch.Generator().manual_seed(convert_cli.TEMPLATE_SEED),
        device=DEVICE)
    from_file = load_params_npz(files["whole_model"], template)
    in_memory = tconvert.convert_whole_model(
        {k: v.numpy() for k, v in sds["whole_model"].items()}, template,
        cfg.model, device=DEVICE)
    content, cnames = load_eval_images(grid_dirs["content"], EVAL_SIZE)
    styles, snames = load_eval_images(grid_dirs["style"], EVAL_SIZE)
    grid = dict(content=content, style=styles, cnames=cnames, snames=snames)
    vgg = trainer.load_vgg_params(files["vgg19"], DEVICE)
    scratch = os.path.join(root, "convert_scratch")
    with deterministic_algorithms():
        runs = [grid_run(p, vgg, cfg, 1, grid, scratch)
                for p in (from_file, in_memory)]
    for run in runs:
        want = eval_per_grid("float32", 1, EVAL_CONTENTS, EVAL_STYLES)
        if run["launches"] != want:
            raise AssertionError(f"convert grid launched {run['launches']}")
    if not grid_equal(*runs):
        raise AssertionError("the grid from the converted .npz differs from "
                             "the grid from the conversion in memory")
    out = dict(kinds=list(CONVERT_KINDS),
               leaves={kind: len(expected_leaves(kind, {
                   k: v.numpy() for k, v in sds[kind].items()}))
                   for kind in CONVERT_KINDS},
               grid_bit_equal=True, grid_summary=runs[0]["report"].summary(),
               grid_pairs_per_s=runs[0]["pairs_per_s"],
               launches=table_sum(r["launches"] for r in runs),
               wall_s=time.perf_counter() - t0, nvidia_smi=smi)
    emit("convert", **out)
    return out


def run_calibrate(root: str, smi: str) -> dict:
    """``calibrate.main`` on one BMP triplet (smooth images from a seed)
    with plain and BN VGG19 .pt files as torchvision initializes them: the
    card's rows within TOL_EVAL_LOSS relative of the same command on the
    CPU, key for key and in order (TF32 in the card's float32 convs would
    show here)."""
    rng = np.random.default_rng(CONVERT_SEED + 1)
    paths = []
    for i, img in enumerate(smooth_images(rng, 3, TRAINER_CONTENT_HW)):
        paths.append(os.path.join(root, f"triplet{i}.bmp"))
        write_bmp(paths[-1], img)
    gen = torch.Generator().manual_seed(CONVERT_SEED + 2)
    vggs = []
    for bn in (False, True):
        vggs.append(os.path.join(root, f"vgg19{'_bn' if bn else ''}.pt"))
        torch.save(vgg19_state_dict(gen, bn), vggs[-1])
    argv = ["--content", paths[0], "--style", paths[1], "--output",
            paths[2], "--vgg_weights", vggs[0], "--vgg_bn_weights", vggs[1],
            "--compute_similarity"]
    rows, wall = {}, {}
    for device in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rows[device] = calibrate.main(argv + ["--device", device])
        wall[device] = time.perf_counter() - t0
    worst = 0.0
    for g, w in zip(rows[DEVICE], rows["cpu"]):
        if list(g) != list(w) or any(g[k] != w[k] for k in (
                "vgg", "distance", "imagenet_norm", "triplet")):
            raise AssertionError(f"calibrate rows differ: {g} / {w}")
        for key in ("content", "style", "total", "similarity"):
            worst = max(worst, abs(g[key] - w[key]) / abs(w[key]))
    out = dict(rows=len(rows[DEVICE]), rel_max_vs_cpu=worst,
               tol=TOL_EVAL_LOSS, wall_s=wall[DEVICE], cpu_wall_s=wall["cpu"],
               tf32_cudnn_default=torch.backends.cudnn.allow_tf32,
               nvidia_smi=smi)
    emit("calibrate", **out)
    if len(rows[DEVICE]) != len(rows["cpu"]) or len(rows[DEVICE]) != 8 \
            or worst > TOL_EVAL_LOSS:
        raise AssertionError(f"calibrate on the card against the CPU: {out}")
    return out


def run_entry_points(smi: str) -> dict:
    """The evaluation and weight entry points, after every phase, with
    draws of their own."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        ev = run_eval(root, smi)
        adapt = run_adapt_cli(root, ev["dirs"], smi)
        convert = run_convert(root, ev["dirs"], smi)
        cal = run_calibrate(root, smi)
    emit("entry_points", wall_s=time.perf_counter() - t0,
         eval_wall_s=ev["wall_s"], adapt_cli_wall_s=adapt["wall_s"],
         convert_wall_s=convert["wall_s"], calibrate_wall_s=cal["wall_s"])
    return dict(eval=ev["launches"], adapt_cli=adapt["launches"],
                convert=convert["launches"])


# ---------------------------------------------------------------------------
# 10. the codecs, the style transformer's split and exclude-MLP routes, and
#     the HTTP server
# ---------------------------------------------------------------------------

CODECS_SEED = TRAIN_SEED + 9
SPLIT_SEED = TRAIN_SEED + 10
EXCLUDE_SEED = TRAIN_SEED + 11
HTTP_SEED = TRAIN_SEED + 12
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "jpeg")
# The decoder against Pillow's stored pixels, and the batch loader against
# the JAX package's loader's stored batches of two sources at one target
# per scale n/8 (scripts/make_jpeg_fixtures.py): 0 values may differ.
N_FIXTURES, N_PROGRESSIVE_FIXTURES, N_PRESCALE_BATCHES = 11, 4, 16
CODEC_SIZE, CODEC_ITERS = 512, 10
# The loader's host time on large sources: 8 seeded 4:2:0 JPEGs of
# 3000x2000 (the port's encoder, quality 95) to 512^2, which the JAX
# loader's loop decodes at 3/8.
LOADER_FILES, LOADER_HW, LOADER_TARGET, LOADER_ITERS = 8, (2000, 3000), 512, 3
SPLIT_KS = (1, 3)
# (shape label, token grid side, batch, dtypes): serving's 512^2 requests
# and the eval grid's 256^2 pairs (Swin features at 1/8 of the image).
SPLIT_SHAPES = (("serving", SIZE // 8, MAX_BATCH, ("bfloat16", "float32")),
                ("eval", EVAL_SIZE // 8, EVAL_STYLE_BATCH, ("float32",)))
SPLIT_ITERS = 3
# A style-transformer output at bf16 against another bf16 route of the
# same function: a few units in the last place of the largest element.
TOL_BF16_ROUTE = 2.0 ** -6
HTTP_KS = (1, 3)
HTTP_PAIR_REQUESTS = 8           # per k: 16 /stylize requests in all
HTTP_CONTENT_HW, HTTP_STYLE_HW = (480, 640), (512, 512)
# Each HTTP reply, decoded, against the service's own output quantised:
# its mean error in levels of 255 is the JPEG noise at quality 95. On this
# phase's weights and inputs at 512^2 (f32, the CPU) that noise is 1.54 to
# 2.26 levels a reply (97-99% of the random model's output values clip, so
# the few edges left take large errors: a max of 123-169 levels);
# tests/test_torch_http.py measures it and holds it under this bound, twice
# the largest mean measured. With so much clipped, another request's output
# could lie within this bound too: the check that tells requests apart is
# that each reply is the encoder's very bytes on its own output.
TOL_JPEG95_MEAN = 4.5


# The other kinds Pillow reads (tests/data/{jpeg_kinds,png,bmp,webp},
# scripts/make_jpeg_fixtures.py, make_image_fixtures.py and
# make_webp_fixtures.py): each fixture against Pillow's stored pixels, and
# five loader sources against the JAX loader's stored batches at one
# target per n/8 (prescaled, or through its fallback): 0 values may differ.
KIND_DIRS = {d: os.path.join(os.path.dirname(FIXTURES), d)
             for d in ("jpeg_kinds", "png", "bmp", "webp", "pnm", "gif",
                       "tiff", "ico", "dib", "tiff_ccitt", "tga", "pcx",
                       "dcx", "qoi")}
KIND_SUFFIX = {"jpeg_kinds": "jpg", "png": "png", "bmp": "bmp",
               "webp": "webp", "pnm": "pnm", "gif": "gif", "tiff": "tif",
               "ico": "ico", "dib": "dib", "tiff_ccitt": "tif",
               "tga": "tga", "pcx": "pcx", "dcx": "dcx", "qoi": "qoi"}
N_KIND_FIXTURES = {"jpeg_kinds": 10, "png": 13, "bmp": 10, "webp": 33,
                   "pnm": 30, "gif": 25, "tiff": 154, "ico": 10, "dib": 13,
                   "tiff_ccitt": 24, "tga": 32, "pcx": 20, "dcx": 5,
                   "qoi": 8}
# The 640x480 timing inputs of the Netpbm, GIF, TIFF (ThunderScan,
# old-style JPEG and CIELab among them), ICO, DIB, TGA, PCX, DCX and QOI
# readers (scripts/make_image_format_fixtures.py): Pillow's pixels of each
# kept as a digest (digests.json); the PPM is written here.
FORMAT_TIMING = {"gif": "gif/coco.gif", "tiff lzw predictor 2":
                 "tiff/coco_lzw_pred2.tif", "tiff deflate":
                 "tiff/coco_deflate.tif", "tiff jpeg": "tiff/coco_jpeg.tif",
                 "tiff g4": "tiff/coco_g4.tif", "tiff lzma":
                 "tiff/coco_lzma.tif", "tiff zstd": "tiff/coco_zstd.tif",
                 "tga rle": "tga/coco_rle.tga",
                 "tiff thunderscan": "tiff/coco_thunderscan.tif",
                 "tiff ojpeg": "tiff/coco_ojpeg.tif",
                 "tiff cielab": "tiff/coco_cielab.tif",
                 "pcx rle": "pcx/coco.pcx", "dcx": "dcx/coco.dcx",
                 "qoi": "qoi/coco.qoi"}
N_KIND_BATCHES = 40
# JPEGs cut short and damaged (tests/data/jpeg_damaged/, written by
# scripts/make_image_format_fixtures.py): decode_image against Pillow's
# verdict and pixels, the batch loader against the JAX loader's (libjpeg
# with jpeg_stdio_src's fake EOI, its fallback to Pillow) at one target per
# n/8, both stored as digests: 0 values may differ. The two trainer_cut_*
# files (640x480, a cut one with restart markers and a cut progressive
# one) are also among the trainer phase's contents.
DAMAGED_DIR = os.path.join(os.path.dirname(FIXTURES), "jpeg_damaged")
# The JAX package's train-state checkpoints (tests/data/orbax/, written by
# scripts/make_orbax_fixtures.py with digests of every leaf as the JAX
# package restores them): the orbax phase's inputs.
ORBAX_FIXTURES = os.path.join(os.path.dirname(FIXTURES), "orbax")
N_DAMAGED, N_DAMAGED_BATCHES = 25, 186


def fixture_pixels() -> dict:
    """The JPEG fixtures (tests/data/jpeg/, scripts/make_jpeg_fixtures.py)
    and Pillow's decoded pixels of each, stored beside them."""
    with np.load(os.path.join(FIXTURES, "pixels.npz")) as stored:
        out = {}
        for name in sorted(stored.files):
            with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
                out[name] = (f.read(), stored[name])
    return out


def prescale_batches() -> dict:
    """The prescale fixtures: {key: (source path, target, the JAX loader's
    batch of the source at the target)}, key ``<source>_<target>``."""
    with np.load(os.path.join(FIXTURES, "prescale.npz")) as stored:
        out = {}
        for key in sorted(stored.files):
            name, target = key.rsplit("_", 1)
            out[key] = (os.path.join(FIXTURES, f"{name}.jpg"), int(target),
                        stored[key])
    return out


def kind_fixtures() -> dict:
    """{"<dir>/<name>": (file bytes, Pillow's pixels)} of the other kinds'
    fixtures; a timing input's pixels as (shape, sha256)."""
    out = {}
    for d, path in KIND_DIRS.items():
        digests = {}
        if os.path.exists(os.path.join(path, "digests.json")):
            with open(os.path.join(path, "digests.json")) as f:
                digests = {name: (tuple(v["shape"]), v["sha256"])
                           for name, v in json.load(f).items()}
        with np.load(os.path.join(path, "pixels.npz")) as stored:
            wants = {**{n: stored[n] for n in stored.files}, **digests}
        for name in sorted(wants):
            with open(os.path.join(path, f"{name}.{KIND_SUFFIX[d]}"),
                      "rb") as f:
                out[f"{d}/{name}"] = (f.read(), wants[name])
    return out


def pixels_differing(got: np.ndarray, want) -> int:
    """Values of got that differ from Pillow's pixels (None for another
    shape); against a (shape, sha256) digest, 0 or all of them."""
    if isinstance(want, tuple):
        shape, sha = want
        if got.shape != shape:
            return None
        same = hashlib.sha256(got.tobytes()).hexdigest() == sha
        return 0 if same else int(got.size)
    return (int(np.count_nonzero(got != want)) if got.shape == want.shape
            else None)


def format_timing() -> dict:
    """The host's ms (mean of CODEC_ITERS) of decode_image at 640x480: the
    timing inputs of FORMAT_TIMING (their digests checked in check_kinds), a
    raw PPM and a plain (P3, decimal) PPM of a smooth image written here,
    each decoded back to it."""
    out = {}
    for name, rel in FORMAT_TIMING.items():
        with open(os.path.join(os.path.dirname(FIXTURES), rel), "rb") as f:
            body = f.read()
        out[name] = dict(bytes=len(body), decode_ms=host_ms(
            lambda: decode_image(body), CODEC_ITERS))
    img = smooth_images(np.random.default_rng(CODECS_SEED + 3), 1,
                        HTTP_CONTENT_HW)[0]
    ppm = b"P6\n640 480\n255\n" + img.tobytes()
    if not np.array_equal(decode_image(ppm), img):
        raise AssertionError("the 640x480 PPM decodes to another image")
    out["ppm"] = dict(bytes=len(ppm), decode_ms=host_ms(
        lambda: decode_image(ppm), CODEC_ITERS))
    plain = b"P3\n640 480\n255\n" + b"\n".join(
        b" ".join(b"%d" % v for v in row) for row in img.reshape(480, -1))
    if not np.array_equal(decode_image(plain), img):
        raise AssertionError("the 640x480 plain PPM decodes to another image")
    out["ppm plain"] = dict(bytes=len(plain), decode_ms=host_ms(
        lambda: decode_image(plain), CODEC_ITERS))
    return out


def kind_batches() -> dict:
    """The other kinds' loader sources: {key: (path, target, the JAX
    loader's batch)}, key ``<source>_<target>``."""
    with np.load(os.path.join(KIND_DIRS["jpeg_kinds"],
                              "prescale.npz")) as stored:
        out = {}
        for key in sorted(stored.files):
            name, target = key.rsplit("_", 1)
            out[key] = (os.path.join(KIND_DIRS["jpeg_kinds"],
                                     f"{name}.jpg"), int(target),
                        stored[key])
    return out


def check_kinds() -> dict:
    """``decode_image`` on every fixture of the other kinds against
    Pillow's pixels and the batch loader on their sources against the JAX
    loader's batches, 0 values differing (any other count raises); the
    host's ms of each fixture's decode (mean of CODEC_ITERS) and of each
    TRAINER_KINDS file's at 640x480."""
    fixtures, counts = {}, {d: 0 for d in KIND_DIRS}
    for key, (data, want) in kind_fixtures().items():
        got = decode_image(data)
        differing = pixels_differing(got, want)
        if differing != 0:
            raise AssertionError(f"fixture {key}: {differing} values differ "
                                 f"({list(got.shape)})")
        counts[key.split("/")[0]] += 1
        fixtures[key] = dict(shape=list(got.shape), differing=differing,
                             decode_ms=host_ms(lambda: decode_image(data),
                                               CODEC_ITERS))
    if counts != N_KIND_FIXTURES:
        raise AssertionError(f"kind fixtures {counts}")
    batches = {}
    for key, (path, target, want) in kind_batches().items():
        got = decode_resize_batch([path], target)[0]
        batches[key] = (int(np.count_nonzero(got != want))
                        if got.shape == want.shape else None)
        if batches[key] != 0:
            raise AssertionError(f"kind batch {key}: {batches[key]} values "
                                 f"differ ({list(got.shape)})")
    if len(batches) != N_KIND_BATCHES:
        raise AssertionError(f"kind batches: {sorted(batches)}")
    large = {name: dict(bytes=len(body), decode_ms=host_ms(
                 lambda: decode_image(body), CODEC_ITERS))
             for name, body in kind_bodies(
                 np.random.default_rng(CODECS_SEED + 2)).items()
             if not name.startswith("kind_cut_")}   # (check_damaged's)
    return dict(kind_fixtures=fixtures, kind_batches_differing=batches,
                kinds_640x480=large, formats_640x480=format_timing())


def damaged_digests() -> dict:
    with open(os.path.join(DAMAGED_DIR, "digests.json")) as f:
        return json.load(f)


def digest_of(fn):
    """sha256 of fn()'s array, or None where it raises ValueError."""
    try:
        return hashlib.sha256(np.ascontiguousarray(fn()).tobytes()).hexdigest()
    except ValueError:
        return None


def check_damaged() -> dict:
    """The damaged JPEGs: ``decode_image`` against Pillow's stored verdict and
    pixels, the batch loader at each stored target against the JAX
    loader's (a digest each, None where the reference refuses the file);
    any difference raises. The host's ms of the loader on the two
    640x480 cut files at TRAINER_RESIZE, and of ``decode_image`` refusing
    them (Pillow refuses a cut file, the loader reads it)."""
    fixtures, batches, times = {}, 0, {}
    for name, want in sorted(damaged_digests().items()):
        path = os.path.join(DAMAGED_DIR, f"{name}.jpg")
        with open(path, "rb") as f:
            body = f.read()
        pil = want["pil"] and want["pil"]["sha256"]
        got = digest_of(lambda: decode_image(body))
        if got != pil:
            raise AssertionError(f"damaged {name}: decode_image "
                                 f"{'refuses' if got is None else got}, "
                                 f"Pillow {'refuses' if pil is None else pil}")
        loader = {}
        for target, sha in want["loader"].items():
            loader[target] = digest_of(
                lambda: decode_resize_batch([path], int(target))[0])
            if loader[target] != sha:
                raise AssertionError(f"damaged {name} at {target}: the "
                                     f"loader {loader[target]}, JAX {sha}")
            batches += 1
        fixtures[name] = dict(pil_reads=pil is not None,
                              loader_reads=sum(v is not None
                                               for v in loader.values()),
                              targets=len(loader))
        if name.startswith("trainer_"):
            times[name] = dict(
                bytes=len(body), loader_ms=host_ms(
                    lambda: decode_resize_batch([path], TRAINER_RESIZE),
                    CODEC_ITERS),
                decode_image_refusal_ms=host_ms(
                    lambda: digest_of(lambda: decode_image(body)),
                    CODEC_ITERS))
    if (len(fixtures), batches) != (N_DAMAGED, N_DAMAGED_BATCHES):
        raise AssertionError(f"damaged fixtures {len(fixtures)}, loader "
                             f"batches {batches}")
    return dict(damaged_fixtures=fixtures, damaged_batches_differing=0,
                damaged_batches=batches, damaged_640x480=times)


def loader_ms(tmp: str) -> dict:
    """The host's ms to stage LOADER_FILES large JPEGs at LOADER_TARGET^2:
    ``decode_resize_batch`` (the prescaled decode on 4 threads and on 1)
    against ``_decode_resize`` file by file (the full-size decode and
    Pillow's BILINEAR in numpy), mean of LOADER_ITERS and of 1."""
    rng = np.random.default_rng(CODECS_SEED + 1)
    paths = []
    for i in range(LOADER_FILES):
        paths.append(os.path.join(tmp, f"large_{i}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(encode_jpeg(smooth_images(rng, 1, LOADER_HW)[0], 95))
    return dict(
        loader_files=LOADER_FILES,
        loader_source=f"{LOADER_HW[1]}x{LOADER_HW[0]} 4:2:0 JPEG q95 -> "
                      f"{LOADER_TARGET}^2",
        loader_bytes=sum(os.path.getsize(p) for p in paths),
        decode_resize_batch_ms=host_ms(
            lambda: decode_resize_batch(paths, LOADER_TARGET), LOADER_ITERS),
        decode_resize_batch_1_thread_ms=host_ms(
            lambda: decode_resize_batch(paths, LOADER_TARGET, n_threads=1),
            LOADER_ITERS),
        full_decode_resize_ms=host_ms(
            lambda: [_decode_resize(p, LOADER_TARGET) for p in paths], 1))


def host_ms(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(255.0 ** 2 / mse)


def png_unfilter_ms(body: bytes) -> dict:
    """read_png on one PNG body, and its two ways of undoing the row
    filters on that body's rows (every row None, Sub or Up, so both apply):
    the host's ms each, mean of 3, the two checked equal."""
    w, h = struct.unpack(">II", body[16:24])
    idat = next(b for kind, b in port_png._chunks(body) if kind == b"IDAT")
    raw = np.frombuffer(port_png._image_data(body, idat, h * (1 + 3 * w)),
                        np.uint8).reshape(h, -1)
    kinds = raw[:, 0].astype(np.int32)
    filt = raw[:, 1:].reshape(h, w, -1).astype(np.int32)
    if not np.array_equal(port_png._unfilter_rows(filt, kinds),
                          port_png._unfilter_sweep(filt, kinds)):
        raise AssertionError("the PNG reader's two unfilter paths differ")
    return dict(
        png_hw=[h, w], png_read_ms=host_ms(
            lambda: port_png.read_png(body), 3),
        png_unfilter_rows_ms=host_ms(
            lambda: port_png._unfilter_rows(filt, kinds), 3),
        png_unfilter_sweep_ms=host_ms(
            lambda: port_png._unfilter_sweep(filt, kinds), 3))


def run_codecs() -> dict:
    """The port's JPEG decoder on the fixtures against Pillow's pixels and
    its batch loader on the prescale sources against the JAX loader's
    batches (0 values may differ); the host's ms of a progressive decode
    and of the loader on large sources (``loader_ms``); then a seeded
    512^2 image encoded at quality 95 and decoded: ms each way (the host's,
    mean of CODEC_ITERS) and the PSNR against the source; the PNG reader's
    unfilter paths on the http phase's PNG body."""
    t0 = time.perf_counter()
    fixtures = {}
    for name, (data, want) in fixture_pixels().items():
        got = decode_jpeg(data)
        fixtures[name] = dict(shape=list(got.shape), differing=int(
            np.count_nonzero(got != want)) if got.shape == want.shape
            else None)
        if fixtures[name]["differing"] != 0:
            raise AssertionError(f"fixture {name}: {fixtures[name]}, "
                                 f"Pillow {list(want.shape)}")
    progressive = [n for n in fixtures if n.startswith("progressive_")]
    if (len(fixtures), len(progressive)) != (N_FIXTURES,
                                             N_PROGRESSIVE_FIXTURES):
        raise AssertionError(f"fixtures: {sorted(fixtures)}")
    prescale = {}
    for key, (path, target, want) in prescale_batches().items():
        got = decode_resize_batch([path], target)[0]
        prescale[key] = (int(np.count_nonzero(got != want))
                         if got.shape == want.shape else None)
        if prescale[key] != 0:
            raise AssertionError(f"prescale {key}: {prescale[key]} values "
                                 f"differ ({list(got.shape)})")
    if len(prescale) != N_PRESCALE_BATCHES:
        raise AssertionError(f"prescale batches: {sorted(prescale)}")
    kinds = check_kinds()
    damaged = check_damaged()
    sources = {}
    for name in ("src_420", "src_422_progressive"):
        with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
            body = f.read()
        sources[name] = dict(shape=list(decode_jpeg(body).shape),
                             decode_ms=host_ms(lambda: decode_jpeg(body),
                                               CODEC_ITERS))
    src = smooth_images(np.random.default_rng(CODECS_SEED), 1,
                        (CODEC_SIZE, CODEC_SIZE))[0]
    data = encode_jpeg(src, 95)
    back = decode_jpeg(data)
    if back.shape != src.shape:
        raise AssertionError(f"round trip gave {back.shape}")
    with tempfile.TemporaryDirectory() as tmp:
        loader = loader_ms(tmp)
    out = dict(fixtures=fixtures, prescale_differing=prescale, **kinds,
               **damaged, source_decode=sources, **loader, size=CODEC_SIZE,
               quality=95, bytes=len(data), psnr_db=psnr_db(back, src),
               encode_ms=host_ms(lambda: encode_jpeg(src, 95), CODEC_ITERS),
               decode_ms=host_ms(lambda: decode_jpeg(data), CODEC_ITERS),
               decode_to_ms=host_ms(lambda: serve._decode_to(SIZE, data),
                                    CODEC_ITERS),
               **png_unfilter_ms(http_inputs()["contents"][1]))
    out["wall_s"] = time.perf_counter() - t0
    emit("codecs", **out)
    # This image's round trip gives 48.16 dB wherever it runs (integer
    # arithmetic; Pillow's encoder writes the same bytes,
    # tests/test_torch_codecs.py); a broken codec falls far below 38.
    if out["psnr_db"] < 38.0:
        raise AssertionError(f"round trip PSNR {out['psnr_db']} dB")
    return out


def split_per_call(route: str, k: int, part: str = "") -> dict:
    """Launches of one windowed style transformer call at depth k (JAX's
    _windowed_machinery): the encoder's Key block (K2) and the decoder's
    self block (K2) each iteration; fused, K3 and K4; split, the
    Scale/Shift update as K9 and two K10, the tail as K9 and K10. ``part``
    "stream" (the encoder alone, a locked stream build) or "batch" (the
    decoder alone, a locked batch)."""
    zero = {e: 0 for e in all_launches()}
    fused = route == "fused"
    enc = {**zero, "window_block_windows": k,
           **({"encoder_scale_shift": k} if fused else
              {"window_attention_dual": k, "ln_mlp_residual": 2 * k})}
    dec = {**zero, "window_block_windows": k,
           **({"decoder_tail": k} if fused else
              {"window_attention_dual": k, "ln_mlp_residual": k})}
    return {"stream": enc, "batch": dec, "": table_sum((enc, dec))}[part]


def route_check(dtype: str, got: torch.Tensor, ref32: torch.Tensor,
                plain: torch.Tensor) -> dict:
    """f32: per-element MAE within TOL_SLICE_MAE of the mean |output| of
    the kernels-off f32 route; bf16: MAE against it at most TOL_BF16_NOISE
    times the plain bf16 route's."""
    got, ref32, plain = (t.float().cpu().numpy() for t in (got, ref32, plain))
    if not np.isfinite(got).all():
        raise AssertionError("output not finite")
    if dtype == "float32":
        return f32_check(got, ref32)
    mae = float(np.abs(got - ref32).mean())
    plain_mae = float(np.abs(plain - ref32).mean())
    return dict(mae_vs_f32=mae, plain_mae_vs_f32=plain_mae,
                noise_ratio=mae / plain_mae, noise_ratio_tol=TOL_BF16_NOISE,
                ok=mae / plain_mae <= TOL_BF16_NOISE)


def precision_ctx(dtype: str):
    return _TF32_OFF if dtype == "float32" else contextlib.nullcontext()


def run_split_route() -> dict:
    """``style_transformer_apply_windowed`` with ``fuse_iteration`` False
    (K9, K10) against True (K3, K4) and against the kernels-off route
    (the generic path in plain PyTorch), at serving's shape (512^2, batch
    8 + 8; bf16, f32) and the eval grid's (256^2, batch 8; f32), k = 1 and
    3: each route's ms (the card's, mean of SPLIT_ITERS), each call's
    launches exactly ``split_per_call``, the outputs by the slice's
    criteria; then the locked split route (a stream build and a batch
    against it) at serving's shape, bf16."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SPLIT_SEED)
    cfg = slice_config("bfloat16", True).transformer
    params = tree_map(lambda t: t.to(DEVICE), init_style_transformer(gen,
                                                                     cfg))
    off = cfg.replace(use_pallas=False)
    launches, rows = {}, []
    for shape, grid, batch, dtypes in SPLIT_SHAPES:
        fc32, fs32 = (torch.randn((batch, grid, grid, ST_C), generator=gen)
                      .to(DEVICE) for _ in range(2))
        for k in SPLIT_KS:
            with torch.inference_mode(), precision_ctx("float32"):
                ref32 = style_transformer_apply(params, fc32, fs32, off, k=k)
            for dtype in dtypes:
                fc, fs = (x.to(getattr(torch, dtype)) for x in (fc32, fs32))
                calls = {
                    "split": lambda: style_transformer_apply_windowed(
                        params, fc, fs, cfg, k=k, fuse_iteration=False),
                    "fused": lambda: style_transformer_apply_windowed(
                        params, fc, fs, cfg, k=k, fuse_iteration=True),
                    "off": lambda: style_transformer_apply(params, fc, fs,
                                                           off, k=k)}
                outs, ms = {}, {}
                with torch.inference_mode(), precision_ctx(dtype):
                    for route, fn in calls.items():
                        torch.cuda.synchronize()
                        reset_launches()
                        outs[route] = fn()
                        torch.cuda.synchronize()
                        got = all_launches()
                        want = ({e: 0 for e in got} if route == "off"
                                else split_per_call(route, k))
                        if got != want:
                            raise AssertionError(
                                f"split_route {shape} {dtype} k={k} "
                                f"{route}: launched {got}, expected {want}")
                        launches[f"{shape} {dtype} k={k} {route}"] = got
                        ms[route] = cuda_ms(fn, SPLIT_ITERS)
                row = dict(shape=shape, dtype=dtype, k=k, batch=batch,
                           tokens=[grid, grid], ms=ms,
                           split_vs_fused=ms["split"] / ms["fused"])
                for route in ("split", "fused"):
                    row[route] = route_check(dtype, outs[route], ref32,
                                             outs["off"])
                row["split_vs_fused_max_abs"] = float(
                    (outs["split"].float() - outs["fused"].float()).abs()
                    .max())
                emit("split_route", **row)
                rows.append(row)
                if not (row["split"]["ok"] and row["fused"]["ok"]):
                    raise AssertionError(f"split_route: {row}")
    # the locked split route: a stream build, then a batch against it
    grid, batch = SPLIT_SHAPES[0][1], SPLIT_SHAPES[0][2]
    fc, fs = (torch.randn((batch, grid, grid, ST_C), generator=gen)
              .to(DEVICE, torch.bfloat16) for _ in range(2))
    for k in SPLIT_KS:
        with torch.inference_mode():
            one = style_transformer_apply_windowed(params, fc, fs, cfg, k=k,
                                                   fuse_iteration=False)
            reset_launches()
            stream = style_stream_windowed(params, fs, cfg, k=k,
                                           fuse_iteration=False)
            torch.cuda.synchronize()
            built = all_launches()
            reset_launches()
            got = style_apply_windowed_from_stream(params, fc, stream, cfg,
                                                   fuse_iteration=False)
            torch.cuda.synchronize()
            decoded = all_launches()
        for label, n, part in (("stream", built, "stream"),
                               ("batch", decoded, "batch")):
            want = split_per_call("split", k, part)
            if n != want:
                raise AssertionError(f"locked split k={k} {label}: "
                                     f"launched {n}, expected {want}")
            launches[f"locked bfloat16 k={k} {label}"] = n
        diff = float((got.float() - one.float()).abs().max())
        scale = float(one.float().abs().max())
        emit("split_route_locked", dtype="bfloat16", k=k, batch=batch,
             max_abs_vs_one_pass=diff, tol=TOL_BF16_ROUTE * scale)
        if diff > TOL_BF16_ROUTE * scale:
            raise AssertionError(f"locked split k={k}: {diff} against the "
                                 f"one-pass split route")
    emit("split_route_wall", wall_s=time.perf_counter() - t0)
    return dict(rows=rows, launches=launches)


def exclude_config(dtype: str, kernels: bool) -> ModelConfig:
    cfg = (slice_config(dtype, True) if kernels
           else reference_config(dtype))
    return cfg.replace(transformer=cfg.transformer.replace(
        decoder_exclude_MLP_after_Fcs_self_MHA=True))


def exclude_per_batch(dtype: str, k: int) -> dict:
    """A request batch with the exclude-MLP decoder, fused route: the slice's
    table, with the decoder's self block as K8 in place of K2."""
    per = dict(PER_BATCH[dtype])
    per["window_block_windows"] = (0 if dtype == "bfloat16" else 4) + k
    per.update(encoder_scale_shift=k, decoder_tail=k, window_attention=k)
    return per


def run_exclude_mlp() -> dict:
    """``master_apply`` at 512^2, k = 1, batch 8 pairs, with an exclude-MLP
    decoder (weights of its own): bf16 and f32 with every kernel on
    against the kernels-off reference (the slice's criteria), each run's
    launches exactly ``exclude_per_batch`` and its ms (the card's); then
    the style transformer's split route with that decoder at f32: K2 k, K8
    k, K9 2k, K10 3k, against the fused route."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(EXCLUDE_SEED)
    params = init_master_model(exclude_config("bfloat16", True), gen,
                               device=DEVICE)
    if "mlp" in params["style_transformer"]["decoder"]["self_mha"]:
        raise AssertionError("an exclude-MLP decoder with a self-block MLP")
    rng = np.random.default_rng(EXCLUDE_SEED)
    pairs = [torch.as_tensor(rng.random((MAX_BATCH, SIZE, SIZE, 3),
                                        dtype=np.float32), device=DEVICE)
             for _ in range(2)]
    outs, ms, launches = {}, {}, {}
    for dtype in ("bfloat16", "float32"):
        for kernels in (True, False):
            fn = make_stylize_fn(exclude_config(dtype, kernels), k=1,
                                 device=DEVICE)
            torch.cuda.synchronize()
            reset_launches()
            out = fn(params, *pairs)
            torch.cuda.synchronize()
            got = all_launches()
            want = (exclude_per_batch(dtype, 1) if kernels
                    else {e: 0 for e in got})
            if got != want:
                raise AssertionError(f"exclude_mlp {dtype} kernels="
                                     f"{kernels}: launched {got}, expected "
                                     f"{want}")
            key = (dtype, kernels)
            launches[f"{dtype} {'on' if kernels else 'off'}"] = got
            outs[key] = out.cpu().numpy()
            ms[key] = cuda_ms(lambda: fn(params, *pairs), SPLIT_ITERS)
            finite_images(f"exclude_mlp {dtype}", outs[key], MAX_BATCH)
    checks = {
        "bfloat16": bf16_noise_verdict(outs["bfloat16", True],
                                       outs["bfloat16", False],
                                       outs["float32", False]),
        "float32": f32_check(outs["float32", True], outs["float32", False])}
    for dtype, check in checks.items():
        emit("exclude_mlp", dtype=dtype, size=SIZE, k=1, batch=MAX_BATCH,
             ms_kernels_on=ms[dtype, True], ms_kernels_off=ms[dtype, False],
             launches=launches[f"{dtype} on"],
             launches_per_batch=exclude_per_batch(dtype, 1), **check)
        if not check["ok"]:
            raise AssertionError(f"exclude_mlp {dtype}: {check}")
    # the split route with this decoder, on its Swin features
    cfg = exclude_config("float32", True)
    with torch.inference_mode(), _TF32_OFF:
        fc = encode_features(params, pairs[0], cfg)
        fs = encode_features(params, pairs[1], cfg)
        st = params["style_transformer"]
        fused = style_transformer_apply_windowed(st, fc, fs, cfg.transformer,
                                                 k=1, fuse_iteration=True)
        torch.cuda.synchronize()
        reset_launches()
        split = style_transformer_apply_windowed(st, fc, fs, cfg.transformer,
                                                 k=1, fuse_iteration=False)
        torch.cuda.synchronize()
    got = all_launches()
    want = {**split_per_call("split", 1), "window_block_windows": 1,
            "window_attention": 1}
    launches["split float32"] = got
    if got != want:
        raise AssertionError(f"exclude_mlp split: launched {got}, expected "
                             f"{want}")
    check = f32_check(split.cpu().numpy(), fused.cpu().numpy())
    emit("exclude_mlp_split", dtype="float32", k=1, launches=got,
         split_vs_fused=check, wall_s=time.perf_counter() - t0)
    if not check["ok"]:
        raise AssertionError(f"exclude_mlp split against fused: {check}")
    return dict(launches=launches, ms={f"{d} {'on' if on else 'off'}": v
                                       for (d, on), v in ms.items()})


def multipart(fields: dict) -> bytes:
    body = b"".join(
        b"--MMSTB\r\nContent-Disposition: form-data; name=\"%s\"; "
        b"filename=\"f\"\r\n\r\n" % name.encode() + data + b"\r\n"
        for name, data in fields.items())
    return body + b"--MMSTB--\r\n"


def http_call(url: str, body: bytes = None,
              ctype: str = "multipart/form-data; boundary=MMSTB"):
    """(status, content type, body) of a GET (no body) or POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


# The kind of each content body of http_inputs, in order.
HTTP_CONTENT_KINDS = ("jpeg q90", "png", "tiff lzw predictor 2", "tiff zstd",
                      "adam7 png", "webp lossy + alpha", "webp lossless",
                      "tga rle")
# The locked style s1's body (s0's is a JPEG of the styles).
HTTP_LOCKED_TIFF = "tiff/coco_deflate.tif"


def http_inputs(seed: int = HTTP_SEED) -> dict:
    """The phase's request bodies from a seed: 8 contents at COCO's
    640x480 and 4 styles at 512^2, smooth images encoded by the port's
    JPEG encoder at quality 90, but for one content as PNG, one as an
    Adam7 PNG, two the WebP files of tests/data/webp/ (lossy with alpha,
    lossless), one the LZW TIFF (predictor 2) and one the Zstandard TIFF
    of tests/data/tiff/ and one the RLE TGA of tests/data/tga/; the
    locked styles are a JPEG of the first style and the Deflate TIFF of
    tests/data/tiff/ (``locked_tiff``)."""
    rng = np.random.default_rng(seed)
    contents = smooth_images(rng, 8, HTTP_CONTENT_HW)
    styles = smooth_images(rng, 4, HTTP_STYLE_HW)
    bodies = [encode_jpeg(c, 90) for c in contents]
    bodies[1] = png_bytes(contents[1])
    bodies[4] = png_file(contents[4], 8, 2, interlace=True)
    data = os.path.dirname(FIXTURES)
    for i, rel in ((5, "webp/trainer_lossy_alpha.webp"),
                   (6, "webp/trainer_lossless.webp"),
                   (2, FORMAT_TIMING["tiff lzw predictor 2"]),
                   (3, FORMAT_TIMING["tiff zstd"]),
                   (7, FORMAT_TIMING["tga rle"])):
        with open(os.path.join(data, rel), "rb") as f:
            bodies[i] = f.read()
    with open(os.path.join(data, HTTP_LOCKED_TIFF), "rb") as f:
        locked_tiff = f.read()
    return dict(contents=bodies, styles=[encode_jpeg(s, 90) for s in styles],
                locked_tiff=locked_tiff)


def http_requests(inputs: dict) -> dict:
    """(k, path, fields) of each request by route: 8 /stylize per k (each
    content against a style in turn), a /stylize_locked per locked style
    and k, two /sweep."""
    c, s = inputs["contents"], inputs["styles"]
    out = {"stylize": [], "locked": [], "sweep": []}
    for k in HTTP_KS:
        for i in range(HTTP_PAIR_REQUESTS):
            out["stylize"].append((k, f"/stylize?k={k}", {
                "content": c[i], "style": s[(i + k) % len(s)]}))
    for k in HTTP_KS:
        for j, name in enumerate(("s0", "s1")):
            out["locked"].append((k, f"/stylize_locked?style={name}&k={k}",
                                  {"content": c[(j + k) % len(c)]}))
    for i in range(2):
        out["sweep"].append((1, "/sweep?k=1", {"content": c[i + 3],
                                                "style": s[i]}))
    return out


def direct_output(svcs: dict, route: str, k: int, path: str,
                  fields: dict):
    """The service's own output on the request's decoded inputs: one
    (H, W, 3) image, or {set: image} for the sweep."""
    content = serve._decode_to(SIZE, fields["content"])
    if route == "locked":
        name = path.split("style=")[1].split("&")[0]
        return svcs["locked"].stylize(content, name, k=k)
    style = serve._decode_to(SIZE, fields["style"])
    if route == "sweep":
        return svcs["sweep"].sweep(content, style, k=k)
    return svcs["pair"][k].stylize(content, style)


def reply_error(data: bytes, want01: np.ndarray) -> dict:
    """A JPEG reply decoded by the port's decoder against the output it
    encodes, quantised as the server quantises it, in levels."""
    got = decode_image(data).astype(np.int64)
    q = np.clip(want01 * 255, 0, 255).astype(np.uint8)
    if got.shape != q.shape:
        raise AssertionError(f"reply of shape {got.shape}, want {q.shape}")
    err = np.abs(got - q)
    return dict(mean=float(err.mean()), max=int(err.max()),
                bytes_equal=data == encode_jpeg(q, 95))


def pair_per_batch(dtype: str, k: int) -> dict:
    """The slice's table (PER_BATCH, k = K) at depth k."""
    per = dict(PER_BATCH[dtype])
    per.update(window_block_windows=(0 if dtype == "bfloat16" else 4) + 2 * k,
               encoder_scale_shift=k, decoder_tail=k)
    return per


def http_send(url: str, reqs: list) -> tuple:
    """POST each (k, path, fields) request from CLIENTS client threads, each
    in turn; (replies, per-request latencies in s, wall s)."""
    replies, lat, errors = [None] * len(reqs), [None] * len(reqs), []

    def client(idx):
        for i in idx:
            t = time.perf_counter()
            try:
                replies[i] = http_call(url + reqs[i][1],
                                       multipart(reqs[i][2]))
            except Exception as e:  # re-raised below, in the main thread
                errors.append(e)
                return
            lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=client,
                                args=(range(j, len(reqs), CLIENTS),))
               for j in range(CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    if errors or any(v is None for v in lat):
        raise AssertionError(f"requests failed: {errors}")
    return replies, lat, wall


def run_http() -> dict:
    """serve.main's services behind ``make_handler`` on a
    ``ThreadingHTTPServer`` at 127.0.0.1, port 0, at bf16 with every kernel
    on: pair at k = 1 and 3, two locked styles (read by the same decoder),
    a sweep over two seeded parameter sets. GET /healthz and two bad bodies
    (400), then 16 /stylize requests from 4 clients (per k, counted from
    zero: ``pair_per_batch`` per batch), 4 /stylize_locked (2 x
    ``locked_per_batch`` at each k) and 2 /sweep (2 x 2 pair batches),
    launches exact. Every reply's status and content type; each JPEG
    decoded by the port's decoder against the service's own output on the
    same decoded inputs: its bytes the encoder's on that output (the
    service's bytes, and so that request's and no other's), and its mean
    error within the JPEG noise at quality 95 (TOL_JPEG95_MEAN levels).
    p50 and max request ms, imgs/s, and the codecs' ms per request."""
    import base64
    from http.server import ThreadingHTTPServer

    t0 = time.perf_counter()
    cfg = slice_config("bfloat16", True)
    params = init_master_model(cfg, torch.Generator().manual_seed(HTTP_SEED),
                               device=DEVICE)
    params2 = init_master_model(
        cfg, torch.Generator().manual_seed(HTTP_SEED + 1), device=DEVICE)
    inputs = http_inputs()
    reqs = http_requests(inputs)
    locked_styles = {"s0": serve._decode_to(SIZE, inputs["styles"][0]),
                     "s1": serve._decode_to(SIZE, inputs["locked_tiff"])}
    pair = {k: StylizeService(params, cfg, size=SIZE, k=k,
                              max_batch=MAX_BATCH, device=DEVICE)
            for k in HTTP_KS}
    svcs = dict(pair=pair, locked=LockedStyleService(
        params, cfg, locked_styles, size=SIZE, ks=HTTP_KS,
        max_batch=MAX_BATCH, device=DEVICE), sweep=SweepService(
            {"set0": params, "set1": params2}, cfg, size=SIZE, ks=(1,),
            device=DEVICE))
    server = thread = None
    runs = {}
    try:
        for svc in (*pair.values(), svcs["locked"], svcs["sweep"]):
            svc.warmup()
        server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(
            pair, default_k=1, sweep_service=svcs["sweep"],
            locked_service=svcs["locked"]))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        code, ctype, data = http_call(url + "/healthz")
        health = json.loads(data)
        if (code, ctype) != (200, "application/json") or (
                health["ks"] != list(HTTP_KS)
                or health["locked_styles"] != ["s0", "s1"]
                or health["lambdas"] != ["set0", "set1"]):
            raise AssertionError(f"/healthz: {code} {ctype} {health}")
        for body, ctype_in in (
                (b"not multipart", "text/plain"),
                (multipart({"content": inputs["contents"][0][
                    :len(inputs["contents"][0]) // 2],
                            "style": inputs["styles"][0]}),
                 "multipart/form-data; boundary=MMSTB")):
            code, _, data = http_call(url + "/stylize", body, ctype_in)
            if code != 400:
                raise AssertionError(f"a bad body got {code}: {data[:200]}")
        plan = [(f"stylize k={k}", "stylize",
                 [r for r in reqs["stylize"] if r[0] == k],
                 pair_per_batch("bfloat16", k)) for k in HTTP_KS]
        plan += [("locked", "locked", reqs["locked"], table_sum(
            locked_per_batch("bfloat16", k) for k in HTTP_KS
            for _ in range(2))),
                 ("sweep", "sweep", reqs["sweep"],
                  {e: 4 * n for e, n in PER_BATCH["bfloat16"].items()})]
        for label, route, batch, per in plan:
            torch.cuda.synchronize()
            reset_launches()
            replies, lat, wall = http_send(url, batch)
            torch.cuda.synchronize()
            got = all_launches()
            # a pair run batches as its requests arrive: per batch; a
            # locked key and a sweep set take one batch a request: in all
            if route == "stylize":
                n = batches = got["decoder_tail"] // batch[0][0]
            else:
                n, batches = 1, len(batch) * (2 if route == "sweep" else 1)
            expect_launches(f"http {label}", got, per, n)
            runs[label] = dict(route=route, reqs=batch, replies=replies,
                               lat=lat, wall=wall, launches=got,
                               batches=batches)
        # every reply against its service's own output on the decoded inputs
        errors = []
        for label, run in runs.items():
            for (k, path, fields), (code, ctype, data) in zip(
                    run["reqs"], run["replies"]):
                want = direct_output(svcs, run["route"], k, path, fields)
                if run["route"] != "sweep":
                    if (code, ctype) != (200, "image/jpeg"):
                        raise AssertionError(f"{path}: {code} {ctype} "
                                             f"{data[:200]}")
                    errors.append(reply_error(data, want))
                    continue
                sets = json.loads(data) if code == 200 else {}
                if (ctype != "application/json"
                        or sorted(sets) != ["set0", "set1"]):
                    raise AssertionError(f"{path}: {code} {ctype}")
                errors.extend(reply_error(base64.b64decode(b64), want[name])
                              for name, b64 in sets.items())
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(60)
        for svc in (*pair.values(), svcs["locked"]):
            svc.close()
    stylize = [runs[f"stylize k={k}"] for k in HTTP_KS]
    lat = [v for run in stylize for v in run["lat"]]
    sample = [b for _, _, fields in reqs["stylize"][:4]
              for b in (fields["content"], fields["style"])]
    out = dict(
        dtype="bfloat16", size=SIZE, max_batch=MAX_BATCH, clients=CLIENTS,
        content_bodies=list(HTTP_CONTENT_KINDS),
        stylize_p50_ms=float(np.median(lat)) * 1e3,
        stylize_p50_note="not comparable with runs whose contents had a "
                         "CMYK JPEG and a GIF where a Zstandard TIFF and an "
                         "RLE TGA are now",
        stylize_max_ms=float(np.max(lat)) * 1e3,
        stylize_imgs_per_s=len(lat) / sum(run["wall"] for run in stylize),
        runs={label: dict(requests=len(run["reqs"]), batches=run["batches"],
                          imgs_per_s=len(run["reqs"]) / run["wall"],
                          p50_ms=float(np.median(run["lat"])) * 1e3,
                          max_ms=float(np.max(run["lat"])) * 1e3)
              for label, run in runs.items()},
        decode_ms_per_request=2 * host_ms(
            lambda: [serve._decode_to(SIZE, b) for b in sample], 2)
        / len(sample),
        encode_ms_per_reply=host_ms(
            lambda: serve._encode_jpeg(locked_styles["s0"]), 5),
        replies=len(errors),
        reply_err_mean_levels=max(e["mean"] for e in errors),
        reply_err_max_levels=max(e["max"] for e in errors),
        replies_bytes_equal=sum(e["bytes_equal"] for e in errors),
        tol_mean_levels=TOL_JPEG95_MEAN,
        launches={label: run["launches"] for label, run in runs.items()},
        wall_s=time.perf_counter() - t0)
    emit("http", **out)
    if (out["replies_bytes_equal"] != out["replies"]
            or out["reply_err_mean_levels"] > TOL_JPEG95_MEAN):
        raise AssertionError(f"http replies off their outputs: {errors}")
    return out


def run_serving_routes() -> dict:
    """The codecs, the split and exclude-MLP routes and the HTTP server,
    with draws of their own; each kernel's launches of each run."""
    t0 = time.perf_counter()
    codecs = run_codecs()
    split = run_split_route()
    exclude = run_exclude_mlp()
    http = run_http()
    emit("serving_routes", wall_s=time.perf_counter() - t0,
         codecs_wall_s=codecs["wall_s"])
    return dict(split=split["launches"], exclude_mlp=exclude["launches"],
                http=http["launches"])


# ---------------------------------------------------------------------------
# spatial: the band-owned path at 1024^2
# ---------------------------------------------------------------------------

SPATIAL_SEED = TRAIN_SEED + 13
SPATIAL_SIZE, SPATIAL_BATCH = 1024, 2
SPATIAL_ITERS = 3
# (dtype, kernels, k) per band count: bf16 with the kernels, and f32 with
# them off; k = 3 on one band only, which the script's own process runs.
SPATIAL_RUNS = {1: (("bfloat16", True, 1), ("bfloat16", True, 3),
                    ("float32", False, 1)),
                2: (("bfloat16", True, 1), ("float32", False, 1)),
                4: (("bfloat16", True, 1), ("float32", False, 1))}
TOL_SPATIAL_F32_MAE = 1e-4


def spatial_per_call(dtype: str, kernels: bool, k: int, n: int) -> dict:
    """Each rank's launches in one band-owned call: at bf16 with the
    kernels, K1 for the 4 Swin blocks, K2 for the Key and self blocks and
    K3, K4 per iteration; the phase decoder's kernels at n = 1 only (the
    plain decoder runs at n > 1); nothing with the kernels off."""
    table = dict.fromkeys(all_launches(), 0)
    if kernels and dtype == "bfloat16":
        table.update(window_block_rows=4, window_block_windows=2 * k,
                     encoder_scale_shift=k, decoder_tail=k)
        if n == 1:
            table.update({e: c for e, c in DECODER_PER_BATCH.items() if c})
    return table


def spatial_inputs():
    """The phase's content and style batches, (SPATIAL_BATCH, SPATIAL_SIZE,
    SPATIAL_SIZE, 3) in [0, 1), the same in every rank."""
    rng = np.random.default_rng(SPATIAL_SEED)
    shape = (SPATIAL_BATCH, SPATIAL_SIZE, SPATIAL_SIZE, 3)
    return (rng.random(shape, dtype=np.float32),
            rng.random(shape, dtype=np.float32))


def spatial_rank(rank: int, n: int, dev: torch.device, runs) -> dict:
    """One rank of the spatial phase, in a process group of n ranks: the
    seed's weights (the first rank's broadcast), this rank's H-band of the
    inputs, and per run a warm-up call, one call with the launches counted
    from zero, SPATIAL_ITERS timed calls (each started together after a
    barrier; ms to its synchronize), the peak memory allocated since the
    warm-up, and the counted call's bands put together on rank 0."""
    mesh = make_mesh(n, ("space",))
    params = replicate(init_master_model(
        ModelConfig(), torch.Generator().manual_seed(SPATIAL_SEED),
        device=dev), mesh)
    content, style = shard_images_spatial(
        tuple(torch.from_numpy(a).to(dev) for a in spatial_inputs()), mesh)
    out = {}
    for dtype, kernels, k in runs:
        fn = make_spatial_stylize_shmap(slice_config(dtype, kernels), mesh,
                                        k=k)
        fn(params, content, style)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        reset_launches()
        traffic = dict(spatial_shmap.TRAFFIC)
        band = fn(params, content, style)
        torch.cuda.synchronize(dev)
        launches = all_launches()
        traffic = {key: spatial_shmap.TRAFFIC[key] - v
                   for key, v in traffic.items()}
        times = []
        for _ in range(SPATIAL_ITERS):
            dist.barrier()
            t0 = time.perf_counter()
            fn(params, content, style)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        full = gather_images_spatial(band, mesh)
        out[(dtype, kernels, k)] = dict(
            ms=float(np.median(times)), times_ms=times,
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            launches=launches, band=list(band.shape), traffic=traffic,
            image=None if full is None else full.cpu().numpy())
    return out


def run_spatial() -> dict:
    """The band-owned spatial path (parallel/spatial_shmap.py) at 1024^2,
    batch 2, ModelConfig defaults, weights from SPATIAL_SEED: one band in a
    world-1 NCCL group in this process; 2 and 4 bands as ranks that share
    the card over gloo (the halos through pinned host copies); 2 and 4
    bands over NCCL where there are that many cards. Each run against the
    single-device master_apply on the card on the same inputs: bf16 by
    the bf16 noise verdict against the same setting, f32 (kernels off)
    within TOL_SPATIAL_F32_MAE of the f32 reference route; each rank's
    launches of one call exactly ``spatial_per_call``. One line per run
    (ms of one call, the median of SPATIAL_ITERS after a warm-up; each
    rank's peak memory allocated); before them, one line per
    single-device call (master_apply at the references' settings and the
    f32 kernels-off route, the f32 nine-conv decoder alone on the whole
    feature map and on half of it: ms and peak memory). Returns each
    kernel's launches per run and rank."""
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    params = init_master_model(ModelConfig(),
                               torch.Generator().manual_seed(SPATIAL_SEED),
                               device=dev)
    content, style = (torch.from_numpy(a).to(dev) for a in spatial_inputs())
    refs = {}   # by label, then by (dtype, k)
    # The single-device references (the f32 reference route: kernels off,
    # nine plain convs; bf16 with the kernels), and the f32 kernels-off
    # route with the phase decoder, the band path's configuration at one
    # band: each one's output, ms and peak memory, beside the bands'.
    singles = [(f"{dtype}_{label}_k{k}", cfg, k)
               for dtype, label, cfg in (
                   ("float32", "reference", reference_config("float32")),
                   ("bfloat16", "on", slice_config("bfloat16", True)))
               for k in (1, 3)]
    singles.append(("float32_off_k1", slice_config("float32", False), 1))
    # and the f32 nine-conv decoder alone on the whole (2, 128, 128, 256)
    # feature map, and on one of two bands of it (2, 64, 128, 256)
    feats = torch.randn((SPATIAL_BATCH, SPATIAL_SIZE // 8, SPATIAL_SIZE // 8,
                         256), generator=torch.Generator().manual_seed(
                             SPATIAL_SEED)).to(dev)
    dcfg = spatial_shmap.plain_decoder(ModelConfig()).decoder
    singles += [(f"float32_decoder_{label}", x, None)
                for label, x in (("whole", feats),
                                 ("half", feats[:, :SPATIAL_SIZE // 16]))]
    with torch.inference_mode():
        for label, cfg, k in singles:
            if k is None:
                def call(x=cfg):
                    with _TF32_OFF:
                        return cnn_decoder_apply(params["decoder"], x, dcfg)
            else:
                def call(cfg=cfg, k=k):
                    return master_apply(params, content, style, cfg, k=k)
            call()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(SPATIAL_ITERS):
                t1 = time.perf_counter()
                out = call()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            refs[label] = out.cpu().numpy()
            emit("spatial_single", run=label, k=k, size=SPATIAL_SIZE,
                 batch=SPATIAL_BATCH, shape=list(out.shape),
                 ms=float(np.median(times)), times_ms=times,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    refs = {(dtype, k): refs[f"{dtype}_{label}_k{k}"] for k in (1, 3)
            for dtype, label in (("float32", "reference"),
                                 ("bfloat16", "on"))}
    del params, content, style, out, feats
    torch.cuda.empty_cache()
    results = {}
    with tempfile.TemporaryDirectory(prefix="mmst_spatial_") as tmp:
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
            world_size=1, rank=0)
        try:
            results[("nccl", 1)] = [spatial_rank(0, 1, dev, SPATIAL_RUNS[1])]
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    for n in (2, 4):
        results[("gloo", n)] = spawn_ranks(spatial_rank, n, backend="gloo",
                                           device="cuda",
                                           args=(SPATIAL_RUNS[n],))
    # One card per rank over NCCL, where the machine has the cards.
    cards = torch.cuda.device_count()
    nccl = [n for n in (2, 4) if cards >= n]
    for n in nccl:
        results[("nccl", n)] = spawn_ranks(spatial_rank, n, backend="nccl",
                                           device="cuda",
                                           args=(SPATIAL_RUNS[n],))
    emit("spatial_cards", count=cards, nccl_bands=nccl)
    launches, failed = {}, []
    for (backend, n), ranks in results.items():
        for dtype, kernels, k in SPATIAL_RUNS[n]:
            label = f"{backend}_n{n}_{dtype}_{'on' if kernels else 'off'}_k{k}"
            per = [r[(dtype, kernels, k)] for r in ranks]
            img = per[0]["image"]
            want = spatial_per_call(dtype, kernels, k, n)
            launches[label] = [p["launches"] for p in per]
            checks = dict(launches_exact=all(p["launches"] == want
                                             for p in per),
                          shape_finite=bool(
                              img.shape == (SPATIAL_BATCH, SPATIAL_SIZE,
                                            SPATIAL_SIZE, 3)
                              and np.isfinite(img).all()))
            if dtype == "bfloat16":
                verdict = bf16_noise_verdict(img, refs[(dtype, k)],
                                             refs[("float32", k)])
            else:
                ref32 = refs[("float32", k)]
                mae = float(np.abs(img - ref32).mean())
                verdict = dict(mae_vs_f32=mae, mae_tol=TOL_SPATIAL_F32_MAE,
                               max_abs_vs_f32=float(np.abs(img - ref32).max()),
                               mean_abs_output=float(np.abs(ref32).mean()),
                               ok=mae <= TOL_SPATIAL_F32_MAE)
            checks["output"] = verdict["ok"]
            emit("spatial", run=label, backend=backend, bands=n, dtype=dtype,
                 kernels=kernels, k=k, size=SPATIAL_SIZE,
                 batch=SPATIAL_BATCH, band_shape=per[0]["band"],
                 ms=max(p["ms"] for p in per),
                 rank_ms=[p["ms"] for p in per],
                 rank_times_ms=[p["times_ms"] for p in per],
                 rank_peak_gib=[p["peak_gib"] for p in per],
                 rank_sent_messages=[p["traffic"]["messages"] for p in per],
                 rank_sent_mbytes=[p["traffic"]["bytes"] / 1e6 for p in per],
                 launches={e: [p["launches"][e] for p in per]
                           for e, c in want.items() if c},
                 launches_want={e: c for e, c in want.items() if c},
                 **verdict, checks=checks)
            if not all(checks.values()):
                failed.append(label)
    emit("spatial_phase", wall_s=time.perf_counter() - t0, failed=failed)
    if failed:
        raise AssertionError(f"spatial runs failed: {failed}")
    return launches


# ---------------------------------------------------------------------------
# data_parallel: the training steps over a data mesh at 256^2, batch 8
# ---------------------------------------------------------------------------

DP_SEED = TRAIN_SEED + 14
DP_NS = (2, 4)
# steps of a run after its warm-up: the first is checked, all are timed
DP_STEPS = 3
DP_META_INNER, DP_TRAINER_ITERS = 2, 3
# mode -> (TrainConfig fields, k); k None is drawn from the step generator
DP_MODES = {
    "plain_k1": ({}, 1),
    "plain": ({}, None),
    "meta": ({"mode": "meta", "num_inner_updates": DP_META_INNER,
              "outer_lr": META_OUTER_LR}, None),
    "fast_adaptation": ({"mode": "fast_adaptation"}, None),
    "accum": ({"grad_accum_steps": ACCUM}, None),
}
DP_DTYPES = ("bfloat16", "float32")


def dp_config(mode: str, dtype: str) -> ExperimentConfig:
    """The train phase's configuration (kernels on) in ``mode``."""
    return with_train(train_config(dtype, True), **DP_MODES[mode][0])


def dp_table(mode: str, metrics: dict) -> dict:
    """The one-device step's launches for the depths it drew."""
    if mode == "meta":
        return table_sum(train_per_step(k) for k in metrics["ks"])
    if mode == "fast_adaptation":
        return adapt_per_step(metrics["k"])
    if mode == "accum":
        return accum_per_step(metrics["k"])
    return train_per_step(metrics["k"])


def dp_inputs():
    """The global batches, on the host: contents (8, 256, 256, 3), the
    meta step's (2, 8, 256, 256, 3), one style repeated to 8, uniform
    noise from DP_SEED."""
    rng = np.random.default_rng(DP_SEED)
    shape = (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3)
    content = rng.random(shape, dtype=np.float32)
    contents = rng.random((DP_META_INNER,) + shape, dtype=np.float32)
    style = np.repeat(rng.random((1,) + shape[1:], dtype=np.float32),
                      TRAIN_BATCH, 0)
    return content, contents, style


def dp_weights(dev):
    gen = torch.Generator().manual_seed(DP_SEED)
    return (init_master_model(train_config("bfloat16", True).model, gen,
                              device=dev),
            init_vgg19_features(gen, device=dev))


def state_checksum(state) -> list:
    """Two int64 sums of the bits of every leaf and Adam moment, one plain
    and one weighted by position (wrapping, so order-free): equal on two
    ranks only if their states are, bit for bit, in all likelihood."""
    sums = []
    for t in (list(flatten_params(state.params).values()) + state.opt.mu
              + state.opt.nu):
        bits = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        sums += [bits.sum(), (bits * w).sum()]
    return torch.stack(sums).cpu().tolist() + [state.step, state.opt.count]


def allreduce_ms(state, mesh, dev) -> float:
    """ms of one ``all_reduce_mean`` of the state's trainable leaves and 3
    losses (what a step all-reduces), median of 3 after a warm-up, each
    started together after a barrier and ended by a synchronize."""
    like = ([torch.zeros_like(t) for t in state.trainable().values()]
            + [torch.zeros((), device=dev) for _ in range(3)])
    all_reduce_mean(like, mesh)
    times = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        all_reduce_mean(like, mesh)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def dp_run(mode: str, dtype: str, params0, vgg, inputs, dev, mesh=None,
           scale: float = 1.0, steps: int = DP_STEPS,
           warm: bool = True) -> dict:
    """``steps`` steps of ``mode`` at ``dtype`` from params0, one step
    generator of a fixed seed, after an untimed step on a copy of its own:
    on the global batch, or with a mesh on this rank's rows of it through
    the data-parallel step (the contents scaled by ``scale``). The first
    step's launches counted from zero, its metrics and Adam's first
    moments (host copies); every step's ms to its synchronize (after a
    barrier with a mesh) and the peak memory allocated since the warm-up;
    with a mesh, the state's checksum gathered over the group after every
    step, the all-reduces a step and their MB, and one's ms."""
    cfg = dp_config(mode, dtype)
    meta = cfg.train.mode == "meta"
    content, contents, style = inputs
    x = contents if meta else content
    if mesh is not None:
        rows = DataShard.on(mesh, max(cfg.train.grad_accum_steps, 1)).rows(
            TRAIN_BATCH)
        x, style = (x[:, rows] if meta else x[rows]), style[rows]
    x = torch.from_numpy(np.ascontiguousarray(x * np.float32(scale))).to(dev)
    style = torch.from_numpy(np.ascontiguousarray(style)).to(dev)
    k = DP_MODES[mode][1]
    kw = ({"ks": None if k is None else [k] * DP_META_INNER} if meta
          else {"k": k})
    step = (make_meta_train_step if meta else make_train_step)(
        cfg, vgg, device=dev, mesh=mesh)
    if warm:
        step(create_train_state(clone_params(params0), cfg.train), x, style,
             torch.Generator().manual_seed(0), **kw)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = create_train_state(clone_params(params0), cfg.train)
    gen = torch.Generator().manual_seed(DP_SEED + 100 + list(DP_MODES).index(
        mode))
    out = dict(times_ms=[], checksums_equal=True)
    for i in range(steps):
        if mesh is not None:
            dist.barrier()
        reset_launches()
        sent = dict(port_mesh.ALL_REDUCES)
        t0 = time.perf_counter()
        state, m = step(state, x, style, gen, **kw)
        torch.cuda.synchronize(dev)
        out["times_ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out.update(launches=all_launches(), metrics=m,
                       mu={key: t.detach().cpu() for key, t in
                           moments(state)[0].items()},
                       allreduce_calls=port_mesh.ALL_REDUCES["calls"]
                       - sent["calls"],
                       allreduce_mb=(port_mesh.ALL_REDUCES["bytes"]
                                     - sent["bytes"]) / 1e6)
        if not all(np.isfinite(m[name]) for name in ("total", "content",
                                                     "style")):
            raise AssertionError(f"{mode} {dtype} step {i}: {m}")
        if mesh is not None:
            sums = [None] * mesh.size()
            dist.all_gather_object(sums, state_checksum(state))
            out["checksums_equal"] &= all(c == sums[0] for c in sums)
    out.update(ms=float(np.median(out["times_ms"])),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    if mesh is not None:
        out["allreduce_ms"] = allreduce_ms(state, mesh, dev)
    return out


def dp_rank(rank: int, n: int, dev: torch.device, runs) -> dict:
    """One rank of the data_parallel phase in a process group of n: the
    seed's weights (the first rank's broadcast, as the trainer replicates
    them) and each (mode, dtype) run of ``dp_run`` on this rank's rows;
    Adam's moments from rank 0 only."""
    mesh = make_mesh(n)
    params0, vgg = (replicate(t, mesh) for t in dp_weights(dev))
    inputs = dp_inputs()
    out = {}
    for mode, dtype in runs:
        out[(mode, dtype)] = dp_run(mode, dtype, params0, vgg, inputs, dev,
                                    mesh)
        if rank:
            del out[(mode, dtype)]["mu"]
    return out


def dp_trainer_rank(rank: int, n: int, dev: torch.device, argv) -> dict:
    """``trainer.train`` on the command line's configuration in one rank,
    with deterministic algorithms, its printed lines kept off the script's
    output."""
    args = trainer.build_argparser().parse_args(argv)
    with deterministic_algorithms(), \
            contextlib.redirect_stdout(io.StringIO()):
        return trainer.train(trainer.config_from_args(args),
                             exp_dir=args.exp_dir, log_every=args.log_every,
                             device=dev)


def run_dp_trainer() -> dict:
    """The trainer with ``num_devices=2`` in two gloo ranks that share the
    card, on the trainer phase's folders and command line, for
    DP_TRAINER_ITERS plain iterations, beside the one-device trainer at
    bf16 and at f32 (``trainer.main``): one experiment dir (config, one
    metrics line per iteration, one checkpoint, one dump), and the logged
    losses within the bf16 verdict: summed over the iterations, |2 ranks -
    f32| at most TOL_BF16_NOISE x |one device - f32| per loss. All three
    run with deterministic algorithms: under PyTorch's defaults cuDNN's
    choice of algorithm moves a bf16 trainer's content loss after its
    first step by as much as bf16 moves it from f32, and the one-device
    trainer fails this verdict against a second run of itself."""
    t0 = time.perf_counter()
    losses = ("total", "content", "style")
    with tempfile.TemporaryDirectory() as tmp:
        cdir, sdir = trainer_folders(tmp)

        def argv(exp, *extra):
            return trainer_argv(cdir, sdir, os.path.join(tmp, exp),
                                "--max_iterations", str(DP_TRAINER_ITERS),
                                *extra)

        walls, ops = {}, set()
        for label, extra in (("one_bf16", ()),
                             ("one_f32", ("--compute_dtype", "float32"))):
            t1 = time.perf_counter()
            with deterministic_algorithms() as caught, \
                    contextlib.redirect_stdout(io.StringIO()):
                trainer.main(argv(label, *extra))
            walls[label] = time.perf_counter() - t1
            ops |= {str(w.message)[:200] for w in caught}
        t1 = time.perf_counter()
        spawn_ranks(dp_trainer_rank, 2, backend="gloo", device="cuda",
                    args=(argv("dp", "--num_devices", "2"),))
        walls["dp"] = time.perf_counter() - t1
        logs = {label: read_jsonl(os.path.join(tmp, label, "metrics.jsonl"))
                for label in ("one_bf16", "one_f32", "dp")}
        dp_dir = os.path.join(tmp, "dp")
        files = sorted(os.listdir(dp_dir))
        ckpts = sorted(os.listdir(os.path.join(dp_dir, "checkpoints")))
        others = sorted(f for f in os.listdir(tmp) if f.startswith("dp_"))
    want_files = ["checkpoints", "config.json", "metrics.jsonl",
                  f"stylized_{DP_TRAINER_ITERS}.png"]
    steps = [r["step"] for r in logs["dp"]]
    ratio = {}
    for name in losses:
        ref = [r[name] for r in logs["one_f32"]]
        got = sum(abs(r[name] - f) for r, f in zip(logs["dp"], ref))
        one = sum(abs(r[name] - f) for r, f in zip(logs["one_bf16"], ref))
        ratio[name] = got / one
    out = dict(iterations=DP_TRAINER_ITERS, ranks=2, backend="gloo",
               files=files, checkpoints=ckpts, other_dirs=others,
               steps=steps, ks=[int(r["k"]) for r in logs["dp"]],
               one_device_ks=[int(r["k"]) for r in logs["one_bf16"]],
               losses={label: [r["total"] for r in rows]
                       for label, rows in logs.items()},
               loss_noise_ratio=ratio, loss_noise_tol=TOL_BF16_NOISE,
               imgs_per_s={label: rows[-1]["imgs_per_sec"]
                           for label, rows in logs.items()},
               nondeterministic_ops=sorted(ops), run_wall_s=walls,
               wall_s=time.perf_counter() - t0)
    out["checks"] = dict(
        one_dir=files == want_files and others == [],
        one_line_per_iteration=steps == list(range(1, DP_TRAINER_ITERS + 1)),
        one_checkpoint=ckpts == [str(DP_TRAINER_ITERS), "config.json"],
        same_ks=out["ks"] == out["one_device_ks"],
        losses=max(ratio.values()) <= TOL_BF16_NOISE)
    emit("data_parallel_trainer", **out)
    return out


def run_data_parallel() -> dict:
    """Data parallelism (train/step.py with a mesh) at the training slice's
    width and shape: ModelConfig defaults, 256^2, global batch 8, weights
    from DP_SEED. Each mode of DP_MODES (plain at k = 1 and with k drawn,
    meta with 2 inner updates, fast adaptation, accumulation 2) at bf16 and
    f32, kernels on: first on one device here (the reference; the f32 runs
    also on the contents scaled by 1 + eps for the spread), then on 2 and
    4 ranks that share the card over gloo, and over NCCL with a card a rank
    where the machine has the cards. Each rank's first step: launches
    exactly the one-device step's table, Adam's first moments against the
    one-device step's (f32 by ``f32_verdict``, bf16 by ``bf16_verdict``
    against the one-device bf16 step's distance from f32), the same k;
    after every step every rank's state bit-equal to rank 0's. One line a
    run: per rank ms of a step (median of DP_STEPS after a warm-up),
    global imgs/s, peak memory, all-reduce ms and MB a step, beside the
    one-device step's. Then the trainer over 2 ranks (``run_dp_trainer``).
    Returns each kernel's launches per run and rank."""
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    params0, vgg = dp_weights(dev)
    inputs = dp_inputs()
    runs = [(mode, dtype) for mode in DP_MODES for dtype in DP_DTYPES]
    single = {run: dp_run(*run, params0, vgg, inputs, dev) for run in runs}
    moved = {mode: [dp_run(mode, "float32", params0, vgg, inputs, dev,
                           scale=1 + eps, steps=1, warm=False)["mu"]
                    for eps in TRAIN_SPREAD_EPS] for mode in DP_MODES}
    for (mode, dtype), r in single.items():
        emit("data_parallel_single", run=f"{mode}_{dtype}", mode=mode,
             dtype=dtype, ms=r["ms"], times_ms=r["times_ms"],
             peak_gib=r["peak_gib"], loss=r["metrics"]["total"],
             k=r["metrics"].get("ks", r["metrics"]["k"]))
        if r["launches"] != dp_table(mode, r["metrics"]):
            raise AssertionError(f"one-device {mode} {dtype} launched "
                                 f"{r['launches']}")
    del params0, vgg
    torch.cuda.empty_cache()
    results = {}
    for n in DP_NS:
        results[("gloo", n)] = spawn_ranks(dp_rank, n, backend="gloo",
                                           device="cuda", args=(runs,))
    cards = torch.cuda.device_count()
    nccl = [n for n in DP_NS if cards >= n]
    for n in nccl:
        results[("nccl", n)] = spawn_ranks(dp_rank, n, backend="nccl",
                                           device="cuda", args=(runs,))
    emit("data_parallel_cards", count=cards, nccl_ranks=nccl)
    launches, failed = {}, []
    for (backend, n), ranks in results.items():
        for mode, dtype in runs:
            label = f"{backend}_n{n}_{mode}_{dtype}"
            per = [r[(mode, dtype)] for r in ranks]
            one = single[(mode, dtype)]
            m0 = per[0]["metrics"]
            if dtype == "float32":
                verdict = f32_verdict(per[0]["mu"], one["mu"], moved[mode])
            else:
                verdict = bf16_verdict(per[0]["mu"], one["mu"],
                                       single[(mode, "float32")]["mu"])
            launches[label] = [p["launches"] for p in per]
            want = dp_table(mode, one["metrics"])
            drawn = m0.get("ks", m0["k"])
            checks = dict(
                launches_exact=all(p["launches"] == want for p in per),
                same_k=all(p["metrics"].get("ks", p["metrics"]["k"])
                           == one["metrics"].get("ks", one["metrics"]["k"])
                           for p in per),
                states_bit_equal=all(p["checksums_equal"] for p in per),
                allreduces=all(p["allreduce_calls"] == (
                    DP_META_INNER if mode == "meta" else 1) for p in per),
                grads=(verdict["f32_over_tol"] <= 1.0 if dtype == "float32"
                       else verdict["bf16_noise_ratio"] <= TOL_BF16_NOISE))
            images = TRAIN_BATCH * (DP_META_INNER if mode == "meta" else 1)
            ms = max(p["ms"] for p in per)
            emit("data_parallel", run=label, backend=backend, ranks=n,
                 mode=mode, dtype=dtype, k=drawn, size=TRAIN_SIZE,
                 batch=TRAIN_BATCH, rank_rows=TRAIN_BATCH // n,
                 ms=ms, rank_ms=[p["ms"] for p in per],
                 rank_times_ms=[p["times_ms"] for p in per],
                 imgs_per_s=images / ms * 1e3,
                 rank_peak_gib=[p["peak_gib"] for p in per],
                 allreduce_ms=[p["allreduce_ms"] * p["allreduce_calls"]
                               for p in per],
                 allreduce_mb=per[0]["allreduce_mb"],
                 allreduce_calls=per[0]["allreduce_calls"],
                 loss=m0["total"], single_loss=one["metrics"]["total"],
                 single_ms=one["ms"], single_imgs_per_s=images / one["ms"]
                 * 1e3, single_peak_gib=one["peak_gib"],
                 launches={e: [p["launches"][e] for p in per]
                           for e, c in want.items() if c},
                 launches_want={e: c for e, c in want.items() if c},
                 **verdict, checks=checks)
            if not all(checks.values()):
                failed.append(label)
    trained = run_dp_trainer()
    if not all(trained["checks"].values()):
        failed.append("trainer")
    emit("data_parallel_phase", wall_s=time.perf_counter() - t0,
         failed=failed)
    if failed:
        raise AssertionError(f"data-parallel runs failed: {failed}")
    return launches


def main(argv=None) -> int:
    only = (argv if argv is not None else sys.argv[1:])
    if only not in ([], ["--only-train-grads"]):
        print("usage: chip_smoke.py [--only-train-grads]", file=sys.stderr)
        return 2
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

    if only:
        # The training phase's gradient checks alone (a planted fault's
        # check is quick to rerun this way); no result line.
        params0, vgg, batches = train_inputs()
        grad_checks(params0, vgg, *batches[0])
        return 0

    gen = torch.Generator().manual_seed(0)
    rows = check_kernels(gen)
    # K5 at the training shapes, from a generator of its own so that the
    # serving weights stay the draw they were.
    stencil_shape_cases(torch.Generator().manual_seed(TRAIN_SEED + 3), [])

    params = init_master_model(slice_config("bfloat16", True), gen,
                               device=DEVICE)
    rng = np.random.default_rng(0)

    def pairs(n):
        return [(rng.random((SIZE, SIZE, 3), dtype=np.float32),
                 rng.random((SIZE, SIZE, 3), dtype=np.float32))
                for _ in range(n)]

    reqs = pairs(REQUESTS)
    launches, _, refs = run_slice(params, reqs)
    run_concurrent(params, reqs)
    check_f32_entry(params, rng)
    batch = np.stack([p for pair in pairs(MAX_BATCH) for p in pair])
    emit("stages", dtype="bfloat16", batch=MAX_BATCH, size=SIZE, k=K,
         **stage_times(params, batch[0::2], batch[1::2]))
    # The pair slice reuses the weights, the requests and the reference
    # outputs, and draws nothing.
    pair = run_pair_slice(params, reqs, refs)
    del refs
    # The training slice's kernel cases and run draw from generators of
    # their own, after the serving phases, whose weights stay the draw they
    # were checked on before the training slice came.
    train_kernel_cases(torch.Generator().manual_seed(TRAIN_SEED + 1), rows)
    train = run_train()
    # The kernels of the pair slice and K13, from a generator of their own,
    # after every phase whose draws they would otherwise move.
    gen_k = torch.Generator().manual_seed(TRAIN_SEED + 2)
    pair_cases(gen_k, rows)
    rgb_cases(gen_k, rows)
    patch_embed_cases(gen_k, rows)
    refusal_checks()
    # Style-locked serving and the sweep on the slice's weights,
    # after every phase, with draws of their own.
    locked = run_locked_phases(params)
    del params
    # The meta step, fast adaptation, remat and accumulation, on the
    # training phase's weights, after every phase, with draws of their own.
    modes = run_new_training_modes()
    # The training entry point on image folders, after every phase, with
    # draws of its own.
    trained = run_trainer(train)
    # The JAX trainer's checkpoints: its fixtures read and trained from,
    # and the full-width save and restore, with draws of their own.
    orbax = run_orbax(smi)
    # The evaluation and weight entry points, after every phase, with
    # draws of their own.
    entry_points = run_entry_points(smi)
    # The codecs, the style transformer's split and exclude-MLP routes and
    # the HTTP server, after every phase, with draws of their own.
    routes = run_serving_routes()
    # K1 at a band's geometry, and the band-owned spatial path at 1024^2,
    # after every phase, with draws of their own.
    band_block_cases(torch.Generator().manual_seed(SPATIAL_SEED + 1), rows)
    spatial = run_spatial()
    # The training steps over a data mesh and the trainer over ranks,
    # after every phase, with draws of their own.
    data_parallel = run_data_parallel()

    def summary(entry, source, replaces, mine, count, origin, per,
                library=True):
        """One entry of the kernels line: ``mine`` the bf16 kernels rows
        of one call each, with its weight in the sum."""
        lib_ms = [r["library_ms"] for r, _ in mine]
        ms = sum(r["ms"] * n for r, n in mine)
        bound = sum(r["bound_ms"] * n for r, n in mine)
        body = {k: max(r[k] for r, _ in mine)
                for k in ("registers", "smem_dynamic", "smem_static",
                          "local_bytes")
                if k in mine[0][0]}
        if "body" in mine[0][0]:
            body["body"] = sorted({r["body"] for r, _ in mine})
        return dict(
            name=entry, route="cuda",
            source=f"mastermetastyletransfer_tpu_torch/csrc/{source}",
            replaces=replaces, launches=count, launches_from=origin,
            max_abs_err=max(r["max_abs_err"] for r, _ in mine),
            ms=ms, plain_ms=sum(r["plain_ms"] * n for r, n in mine),
            bound_ms=bound, share_of_bound=bound / ms,
            bound_by=("operations" if sum(r["ops_ms"] * n for r, n in mine)
                      >= sum(r["bytes_ms"] * n for r, n in mine)
                      else "bytes"),
            library_ms=(None if not library or None in lib_ms
                        else sum(v * n for v, (_, n) in zip(lib_ms, mine))),
            dtype="bfloat16", per=per,
            smem_bytes=max(r["smem_bytes"] for r, _ in mine), **body)

    def bf16_rows(entry, calls):
        return [(r, calls[r["case"]]) for r in rows if r["entry"] == entry
                and r["dtype"] == "bfloat16" and r["case"] in calls]

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
        kernels.append(summary(entry, source, replaces,
                               bf16_rows(entry, dict.fromkeys(cases, 1)),
                               launches[entry], "bfloat16 slice run", per))
        # The style-locked path's runs (each counted from zero), and the
        # stream builds of its bf16 service (2 styles x k = 1, 3).
        kernels[-1]["locked_launches"] = {run: counts[entry]
                                          for run, counts in locked.items()}
    # The training kernels: launches from the bf16 train run, times summed
    # over the calls of one step at k=1.
    for entry, replaces, calls, per in (
            ("window_attention", "ops/pallas_attention.py:384",
             {"swin_stage1": 2, "swin_stage2": 2, "style_transformer": 2},
             "the 4 Swin blocks of one 16-image pass and the style "
             "transformer's Key and self blocks, one step at k=1"),
            ("window_attention_bwd", "ops/pallas_attention_vjp.py:274",
             {"style_transformer": 2}, "one step at k=1"),
            ("window_attention_dual", "ops/pallas_attention.py:428",
             {"st_dual": 1, "st_shared_wv": 1}, "one step at k=1"),
            ("window_attention_dual_bwd", "ops/pallas_attention_vjp.py:522",
             {"st_dual": 1, "st_shared_wv": 1}, "one step at k=1"),
            ("ln_mlp_residual", "ops/pallas_mlp.py:137",
             {"swin_stage1": 2, "swin_stage2": 2, "st_ln": 1,
              "st_no_ln": 4}, "one step at k=1"),
            ("ln_mlp_residual_bwd", "ops/pallas_mlp_vjp.py:133",
             {"st_ln": 1, "st_no_ln": 4}, "one step at k=1")):
        source = ("window_attention.cu" if entry.startswith("window")
                  else "ln_mlp.cu")
        kernels.append(summary(entry, source, replaces,
                               bf16_rows(entry, calls),
                               train["launches"][entry],
                               "bfloat16 train run", per, library=False))
    for k in kernels:
        if k["name"] in TRAINING_ENTRIES:
            # The training modes' runs, each counted from zero: 3 meta
            # steps, 20 adaptation steps, 6 remat and 6 accum steps.
            k.update({f"{mode}_launches": modes[mode][k["name"]]
                      for mode in ("meta", "adapt", "remat", "accum")})
        if k["name"] in ("stencil_phase_conv", "phase_align"):
            k["train_launches"] = train["launches"][k["name"]]
            k["train_bwd_ms"] = sum(
                r["ms"] for r in rows if r["entry"] == k["name"] + "_bwd"
                and r["dtype"] == "bfloat16")
    # The pair slice's kernels: launches from its bf16 runs, times summed
    # over the calls of one request batch; K13, which no path runs.
    for entry, source, replaces, cases, route, per in (
            ("window_block_pair_rows", "block_pair.cu",
             "ops/pallas_attention.py:836", ("swin_stage1", "swin_stage2"),
             "bfloat16", "the 2 pair launches of one 16-image Swin pass"),
            ("stencil_phase2_rgb128", "phase_conv.cu",
             "ops/pallas_conv.py:761", ("conv8",), "bfloat16",
             "conv8 of one batch"),
            ("stencil_phase2_rgb", "phase_conv.cu",
             "ops/pallas_conv.py:600", ("conv8",), "rgb",
             "conv8 of one batch (_RGB_KERNEL_ON)"),
            ("patch_embed", "patch_embed.cu", "ops/pallas_conv.py:882",
             ("swin_patch_embed",), None,
             "the patch embedding of one 16-image pass")):
        if route is None:
            count, origin = 0, ("no path: the kernel phase alone runs it, "
                                "as only a test runs the JAX kernel")
        else:
            count = pair[route]["launches"][entry]
            origin = ("bfloat16 pair slice run" + (" with _RGB_KERNEL_ON"
                                                   if route == "rgb" else ""))
        k = summary(entry, source, replaces,
                    bf16_rows(entry, dict.fromkeys(cases, 1)), count, origin,
                    per, library=entry.startswith("stencil"))
        if entry.startswith("stencil"):
            k["bwd_ms"] = sum(r["ms"] for r in rows
                              if r["entry"] == entry + "_bwd"
                              and r["dtype"] == "bfloat16")
        kernels.append(k)
    for k in kernels:
        # The trainer phase's four runs (plain 6, resumed 3, meta 2, fast
        # adaptation 3 iterations), each counted from zero.
        k["trainer_launches"] = trained["launches"][k["name"]]
        # The orbax phase's step from each JAX-written fixture, counted
        # from zero.
        k["orbax_launches"] = {
            name: run["launches"].get(k["name"], 0)
            for name, run in orbax["fixtures"].items()}
        # The eval phase's kernels-on grids and its command line's, and
        # the adaptation command line's run (20 steps, 11 stylize calls),
        # each counted from zero.
        k["eval_launches"] = {
            run: counts[k["name"]]
            for run, counts in entry_points["eval"].items()}
        k["adapt_cli_launches"] = entry_points["adapt_cli"][k["name"]]
        # The split route's, the exclude-MLP decoder's and the HTTP
        # server's runs, each counted from zero.
        for run, tables in routes.items():
            k[f"{run}_launches"] = {label: counts[k["name"]]
                                    for label, counts in tables.items()}
        # The spatial phase's runs: each rank's launches of one call.
        k["spatial_launches"] = {label: [counts[k["name"]] for counts in per]
                                 for label, per in spatial.items()}
        # The data-parallel runs: each rank's launches of one step.
        k["data_parallel_launches"] = {
            label: [counts[k["name"]] for counts in per]
            for label, per in data_parallel.items()}
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
