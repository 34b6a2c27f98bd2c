"""Band-owned spatial (context) parallelism on torch.distributed (JAX
counterpart: parallel/spatial_shmap.py, a shard_map with explicit ppermute
halos).

Each rank of the mesh's space axis OWNS a horizontal band of the image
and of every window grid (whole window rows). Windows are independent
within an attention phase, so the only traffic between bands is

  * the cyclic roll of the shifted phase (reference
    codes/style_transformer.py:98-100 ``torch.roll``): the sh topmost rows
    go to the previous band (sh = 3 for the Swin, 4 for the style
    transformer), and back for the un-roll (``_band_roll_h``,
    ``_band_unroll_h``);
  * the band REPARTITION at stage boundaries (uniform valid bands <->
    padded window-aligned bands): whole bands from the neighbours at a
    fixed set of offsets, then this band's rows out of them
    (``_band_repartition``). Window-row counts rarely divide the band
    count, so the band grid is padded with extra all-pad window rows; the
    result stays exact against the reference's minimal padding because
    windows never overlap and every image-global statistic is taken with
    masks of the REFERENCE's grid (``_build_aux``);
  * below the style transformer, at n > 1, one row from each neighbour
    for each 3x3 conv of the decoder (``_band_reflect_conv``).

Everything else -- the patch embed (stride 4, patches of their own),
patch merging (2x2, bands stay even), LN, MLP, modulation (token-local),
window attention (window-local) -- runs band-local. The two image-GLOBAL
ops, the masked instance norms of the decoder's entry and its post-linear
Key IN (reference codes/style_transformer.py:1053-1057, :520-530), sum
their statistics over the bands (``band_sum``, f32).

Each rank builds the geometry's masks once and keeps only its own
window-row slab of each (JAX's ``P("space")`` operands). The kernels run
inside each band, on a CUDA tensor, where JAX's band path picks them: K1
(the rows entry of ops/window_block.py) for each Swin block at bf16 within
the row width JAX's gate allows, with the H-roll done outside it as the
halo and the W-roll inside; at bf16 with ``use_pallas``, K2 for the style
encoder's Key block and the decoder's self block, K3 for the Scale/Shift
update, K4 for the decoder tail. Otherwise the kernels' plain versions,
the function of JAX's plain band ops. The style transformer is
models/style_transformer's window-resident machinery itself
(``_windowed_machinery``) on the band's slabs, with its statistics summed
over the bands.

The decoder: at n = 1 the configured one (the phase-space decoder with
K5-K7 under ``use_pallas``), as JAX keeps it (its :681-687). At n > 1 JAX
swaps in the plain nine-conv decoder and lets GSPMD shard it; PyTorch has
no GSPMD, so the port runs that plain decoder band-local: each
reflect-padded 3x3 conv takes one halo row from each neighbouring band,
reflection happens only at the image's first and last rows (the first and
last band), nearest upsampling is band-local.

Collectives follow the space group's backend (parallel/mesh.py
``to_wire``): NCCL with the CUDA tensors themselves, one card per rank;
gloo with CPU tensors (the CPU tests), and on one shared card through
pinned host copies. At n = 1 every collective is JAX's local branch.

Evaluation only (dropout and stochastic depth are the identity), as JAX's
path. Numerics mirror the single-device path op for op; the CPU tests
hold it to JAX's ``master_apply`` and ``make_spatial_stylize_shmap``
(tests/test_torch_parallel*.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from mastermetastyletransfer_tpu_torch.config import (
    DecoderConfig, ModelConfig, StyleTransformerConfig,
)
from mastermetastyletransfer_tpu_torch.models.decoder import (
    _channel_plan, cnn_decoder_apply,
)
from mastermetastyletransfer_tpu_torch.models.master import (
    DTYPES, _stage_ctx,
)
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    WindowGrid, _windowed_machinery,
)
from mastermetastyletransfer_tpu_torch.models.swin import (
    _block_cfg, patch_embed, patch_merging,
)
from mastermetastyletransfer_tpu_torch.ops import window_block
from mastermetastyletransfer_tpu_torch.ops.attention import (
    ROWS_MAX_ELEMENTS, _pallas_dim_ok,
)
from mastermetastyletransfer_tpu_torch.ops.conv import upsample_nearest
from mastermetastyletransfer_tpu_torch.ops.windows import (
    effective_shift, shift_attention_mask, valid_token_mask,
)
from mastermetastyletransfer_tpu_torch.parallel.mesh import (
    axis_index, to_wire, wire_empty,
)


# What this rank has sent to other bands: point-to-point messages and
# all-reduces, and their bytes (a counter, as the kernels' LAUNCHES).
TRAFFIC = {"messages": 0, "bytes": 0}


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# band collectives
# ---------------------------------------------------------------------------

class Band(NamedTuple):
    """This rank's place on the space axis: the axis's process group, its
    size n, this band's index, and the global ranks of the bands in band
    order (the peers of a point-to-point op)."""
    group: Optional[dist.ProcessGroup]
    n: int
    index: int
    peers: tuple


def band_of(mesh: DeviceMesh, space_axis: str = "space") -> Band:
    group = mesh.get_group(space_axis)
    return Band(group, mesh.size(axis_index(mesh, space_axis)),
                mesh.get_local_rank(space_axis),
                tuple(dist.get_process_group_ranks(group)))


def _ppermute(x: torch.Tensor, off: int, band: Band) -> torch.Tensor:
    """lax.ppermute with JAX's ``_nbr(n, off)`` pairs: band d receives band
    (d + off) % n's x (every band's x has one shape) and sends its own to
    band (d - off) % n."""
    n, d = band.n, band.index
    send = to_wire(x, band.group)
    recv = wire_empty(x, band.group)
    ops = [dist.P2POp(dist.isend, send, band.peers[(d - off) % n],
                      band.group),
           dist.P2POp(dist.irecv, recv, band.peers[(d + off) % n],
                      band.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    TRAFFIC["messages"] += 1
    TRAFFIC["bytes"] += send.numel() * send.element_size()
    return recv.to(x.device)


def band_sum(t: torch.Tensor, band: Band) -> torch.Tensor:
    """lax.psum over the space axis: t summed elementwise over the bands,
    on every band."""
    if band.n == 1:
        return t
    w = to_wire(t, band.group)
    if w.data_ptr() == t.data_ptr():
        w = w.clone()
    dist.all_reduce(w, group=band.group)
    TRAFFIC["messages"] += 1
    TRAFFIC["bytes"] += w.numel() * w.element_size()
    return w.to(t.device)


def _band_roll_h(x: torch.Tensor, sh: int, band: Band) -> torch.Tensor:
    """Global torch.roll(x, -sh, 1) on uniform H-bands: each band takes
    the sh topmost rows of the NEXT band (the shifted-window halo, one
    window row at most)."""
    if band.n == 1:
        return torch.roll(x, -sh, 1)
    halo = _ppermute(x[:, :sh], 1, band)
    return torch.cat([x[:, sh:], halo], 1)


def _band_unroll_h(x: torch.Tensor, sh: int, band: Band) -> torch.Tensor:
    """Inverse of _band_roll_h (global torch.roll(x, +sh, 1))."""
    if band.n == 1:
        return torch.roll(x, sh, 1)
    halo = _ppermute(x[:, -sh:], -1, band)
    return torch.cat([halo, x[:, :-sh]], 1)


def _band_repartition(x: torch.Tensor, o_rows: int, band: Band,
                      h_valid: int) -> torch.Tensor:
    """Redistribute uniform H-bands of i_rows rows (global grid n*i_rows)
    into uniform bands of o_rows rows (global grid n*o_rows). Output rows
    with global index >= h_valid come back ZERO (window padding). Used at
    stage boundaries: valid grid -> padded window-aligned grid and back.

    The neighbour offsets the bands need are the same Python ints as in
    JAX; each offset is one whole-band ppermute, and this band slices its
    o_rows out of the gathered slab at a Python-int start (JAX needs a
    traced dynamic_slice: its band index is a tracer)."""
    b, i_rows, w, c = x.shape
    n, d = band.n, band.index
    if n == 1:
        if o_rows > i_rows:
            out = F.pad(x, (0, 0, 0, 0, 0, o_rows - i_rows))
        else:
            out = x[:, :o_rows]
    else:
        offs = set()
        for e in range(n):
            s = o_rows * e
            offs.add(min(s // i_rows, n - 1) - e)
            offs.add(min((s + o_rows - 1) // i_rows, n - 1) - e)
        off_min, off_max = min(offs), max(offs)
        slabs = [x if off == 0 else _ppermute(x, off, band)
                 for off in range(off_min, off_max + 1)]
        big = torch.cat(slabs, 1)     # global rows [(d+off_min)*i_rows, ...)
        start = o_rows * d - (d + off_min) * i_rows
        deficit = start + o_rows - big.shape[1]
        if deficit > 0:
            big = F.pad(big, (0, 0, 0, 0, 0, deficit))
        out = big[:, start:start + o_rows]
    keep = max(0, min(o_rows, h_valid - o_rows * d))
    if keep < o_rows:
        out = torch.cat([out[:, :keep], out.new_zeros(
            (b, o_rows - keep, w, c))], 1)
    return out.contiguous()


# ---------------------------------------------------------------------------
# band-local window machinery
# ---------------------------------------------------------------------------

def _part(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """(B, hb, Wp, C) band -> (B, nW_loc, N, C), window-row-major (the
    order of the mask slabs)."""
    b, hb, wp, c = x.shape
    x = x.reshape(b, hb // wh, wh, wp // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (hb // wh) * (wp // ww), wh * ww, c)


def _merge(x4: torch.Tensor, hb: int, wp: int, wh: int,
           ww: int) -> torch.Tensor:
    b, _, _, c = x4.shape
    x = x4.reshape(b, hb // wh, wp // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hb, wp, c)


# The compute types at which the band path takes K1-K4 where use_pallas
# asks for them: JAX's band gate fuses at 2-byte types only (its f32
# kernels overflow the TPU's scoped VMEM). Read at each call.
KERNEL_DTYPES = (torch.bfloat16,)


def _rows_kernel_ok(x: torch.Tensor, c: int, wh: int, ww: int) -> bool:
    """JAX's gate of the row-resident kernel inside a band (its
    ``_rows_kernel_ok``, the gate of ops/attention's block entry): a kernel
    dtype and a row of windows of at most ROWS_MAX_ELEMENTS elements.
    (JAX's interpret mode, which takes the kernel at any type on the CPU,
    has no counterpart: a CPU tensor runs the kernel's plain version.)"""
    return (x.dtype in KERNEL_DTYPES
            and (x.shape[2] // ww) * ww * wh * c <= ROWS_MAX_ELEMENTS)


def _st_kernels_ok(cfg: StyleTransformerConfig, dtype: torch.dtype) -> bool:
    """JAX's gate of K2-K4 on a band: use_pallas, the kernels' widths, a
    kernel dtype."""
    return (cfg.use_pallas and _pallas_dim_ok(cfg.encoder_dim)
            and dtype in KERNEL_DTYPES)


def _band_swin_block(bp, x, acfg, mask_slab, pm2, sh: int, sw: int,
                     band: Band, kernel: bool):
    """One Swin block on a padded-resident band, through K1 (``kernel``) or
    its plain version: the H-roll is the ppermute halo (the block's own
    roll is cyclic over ITS array, which would wrap within the band), the
    W-roll stays in the block, and the band's mask and validity slabs go
    in. The output is in the plain frame of the input. pm2: (nW_loc, N)
    validity slab (zeroes the LN view of pad tokens and of whatever the
    padded-resident stage holds in pad rows)."""
    if sh:
        x = _band_roll_h(x, sh, band)
    w = window_block.block_weights(bp, acfg.window_size, x.dtype, True)
    block = (window_block.window_block_rows if kernel
             else window_block.window_block_rows_plain)
    out = block(x.contiguous(), w, heads=acfg.num_heads,
                window=acfg.window_size, shift=(0, sw), mask=mask_slab,
                padmask=pm2)
    if sh:
        out = _band_unroll_h(out, sh, band)
    return out


def _pad_w(x: torch.Tensor, wp: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, wp - x.shape[2])) if x.shape[2] < wp else x


def _swin_local(sp, images, scfg, aux, meta, band: Band):
    """Swin first-2-stages on an image H-band (B, H/n, W, 3) -> feature
    band (B, H/8n, W/8, 2E). Mirrors models/swin.swin_backbone_apply
    (reference codes/utils.py:59-102), band-owned."""
    x = patch_embed(sp["patch_embed"], images, scfg)
    wh, ww = scfg.window_size
    for stage in range(2):
        if stage == 1:
            x = patch_merging(sp["patch_merge"], x)
        g = meta[f"s{stage}"]
        x = _band_repartition(_pad_w(x, g["Wp"]), g["rows_loc"], band,
                              h_valid=g["hs"])
        for blk in range(scfg.depths[stage]):
            acfg = _block_cfg(scfg, stage, blk)
            shifted = blk % 2 == 1
            sh, sw = (g["sh"], g["sw"]) if shifted else (0, 0)
            bp = sp[f"stage{stage}_block{blk}"]
            pm2 = aux[f"s{stage}_pm1" if shifted else f"s{stage}_pm0"]
            mask_slab = (aux[f"s{stage}_mask"] if (shifted and (sh or sw))
                         else None)
            kernel = (scfg.use_pallas and _pallas_dim_ok(acfg.dim)
                      and _rows_kernel_ok(x, acfg.dim, wh, ww))
            x = _band_swin_block(bp, x, acfg, mask_slab, pm2, sh, sw, band,
                                 kernel)
        x = _band_repartition(x, g["hs"] // band.n, band, h_valid=g["hs"])
        x = x[:, :, :g["ws"]]
    return x


# ---------------------------------------------------------------------------
# band-local style transformer
# ---------------------------------------------------------------------------

def _st_local(params, fc, fs, cfg, aux, meta, band: Band, k: int):
    """Style transformer on uniform feature bands (B, h2/n, w2, C):
    pad/roll/partition ONCE (the windowed path's structure), run the k
    iterations band-local, merge/unroll/unpad once."""
    g = meta["st"]
    wh, ww = cfg.encoder_window_size

    def to_windows(x):
        x = _band_repartition(_pad_w(x, g["Wp"]), g["rows_loc"], band,
                              h_valid=g["hs"])
        if g["sh"]:
            x = _band_roll_h(x, g["sh"], band)
        if g["sw"]:
            x = torch.roll(x, -g["sw"], 2)
        return _part(x, wh, ww)

    fc4, fs4 = to_windows(fc), to_windows(fs)
    # The single-device machinery on this band's slabs, the image-global
    # statistics summed over the bands.
    grid = WindowGrid(
        mask=aux["st_mask"] if (g["sh"] or g["sw"]) else None,
        padmask=aux["st_pm"], count=g["count"],
        reduce=functools.partial(band_sum, band=band),
        key_in=(aux["st_refpad"], g["count_ref"]))
    encoder, decoder = _windowed_machinery(
        params, cfg, grid, fc4.dtype,
        kernels=_st_kernels_ok(cfg, fc4.dtype))
    Key = Scale = Shift = fs4
    Fcs = fc4
    for _ in range(int(k)):
        Key, Scale, Shift = encoder(Key, Scale, Shift)
        Fcs = decoder(Fcs, Key, Scale, Shift)

    x = _merge(Fcs, g["rows_loc"], g["Wp"], wh, ww)
    if g["sw"]:
        x = torch.roll(x, g["sw"], 2)
    if g["sh"]:
        x = _band_unroll_h(x, g["sh"], band)
    x = _band_repartition(x, g["hs"] // band.n, band, h_valid=g["hs"])
    return x[:, :, :g["ws"]]


# ---------------------------------------------------------------------------
# band-local plain decoder
# ---------------------------------------------------------------------------

def _band_reflect_conv(params: dict, x: torch.Tensor, band: Band, *,
                       relu: bool) -> torch.Tensor:
    """ops/conv.reflect_conv on an H-band of n > 1: the row above and the
    row below come from the neighbouring bands; the first band reflects
    the image's row 1 above row 0, the last its row H-2 below row H-1
    (each taken from the band and its halo, so a band of one row works
    too); W reflects locally."""
    top = _ppermute(x[:, -1:], -1, band)
    bot = _ppermute(x[:, :1], 1, band)
    if band.index == 0:
        top = torch.cat([x, bot], 1)[:, 1:2]
    if band.index == band.n - 1:
        bot = torch.cat([top, x], 1)[:, -2:-1]
    xh = torch.cat([top, x, bot], 1).permute(0, 3, 1, 2)
    xh = F.pad(xh, (1, 1, 0, 0), mode="reflect")
    w = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)   # HWIO -> OIHW
    y = F.conv2d(xh, w, params["bias"].to(x.dtype))
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1)


def _band_decoder(params: dict, x: torch.Tensor, cfg: DecoderConfig,
                  band: Band) -> torch.Tensor:
    """The plain nine-conv decoder (cnn_decoder_apply with
    fuse_upsample=False) on a feature band -> the RGB band (n > 1)."""
    plan = _channel_plan(cfg.channel_dim)
    for i, (_, _, up) in enumerate(plan):
        x = _band_reflect_conv(params[f"conv{i}"], x, band,
                               relu=i < len(plan) - 1)
        if up:
            x = upsample_nearest(x, 2)
    return x


# ---------------------------------------------------------------------------
# mask/geometry construction + the public API
# ---------------------------------------------------------------------------

def _grid_meta(hs: int, ws: int, wh: int, ww: int, shift, n: int) -> dict:
    nww = -(-ws // ww)
    wp = nww * ww
    nwh = -(-hs // wh)
    nwh_pad = _ceil_to(nwh, n)
    pad_h = nwh_pad * wh
    sh, sw = effective_shift(pad_h, wp, (wh, ww), shift)
    return dict(hs=hs, ws=ws, Wp=wp, nww=nww, nwh_pad=nwh_pad, pad_h=pad_h,
                pad_h_ref=nwh * wh, sh=sh, sw=sw, rows_loc=pad_h // n)


def _shift_mask_refgrid(g: dict, wh: int, ww: int) -> np.ndarray:
    """Shifted-phase attention mask on the band grid, exact w.r.t. the
    reference's MINIMAL padded grid. The band grid pads the window-row
    count up to the band count with extra all-pad rows; for UNSHIFTED
    blocks that is invisible (the reference pad height nWh*wh is a window
    multiple, so extra rows never share a window with reference tokens),
    but the shifted phase's cyclic roll pulls extra pad rows into the
    bottom-boundary windows, where the reference's tokens would see them
    as additional bias-carrying KEYS (reference pads take part as keys).
    Keys outside the reference grid therefore get -1e9 (exactly excluded:
    the reference grid has no such tokens), on top of the region mask."""
    m = np.array(shift_attention_mask(g["pad_h"], g["Wp"], wh, ww, g["sh"],
                                      g["sw"]), np.float32)
    if g["pad_h"] > g["pad_h_ref"]:
        rp = valid_token_mask(g["pad_h_ref"], g["Wp"], g["pad_h"], g["Wp"],
                              wh, ww, g["sh"], g["sw"])
        m = m + np.where(rp == 0.0, np.float32(-1e9),
                         np.float32(0.0))[:, None, :]
    return m


def _aux_arrays(H: int, W: int, cfg: ModelConfig, n: int):
    """Static geometry (meta: Python ints) and the whole-grid mask arrays
    (numpy, float32), each leading with the window-row axis -- JAX's
    ``_build_aux`` without its PartitionSpecs: (nWh_pad, nWw, N) validity
    masks, (nWh_pad, nWw, N, N) shift masks."""
    meta, aux = {}, {}
    scfg = cfg.swin
    wh, ww = scfg.window_size
    nn = wh * ww
    for stage in (0, 1):
        hs, ws = H // (4 * 2 ** stage), W // (4 * 2 ** stage)
        g = _grid_meta(hs, ws, wh, ww, (wh // 2, ww // 2), n)
        meta[f"s{stage}"] = g
        shape = (g["nwh_pad"], g["nww"], nn)
        aux[f"s{stage}_pm0"] = valid_token_mask(
            hs, ws, g["pad_h"], g["Wp"], wh, ww, 0, 0).reshape(shape)
        aux[f"s{stage}_pm1"] = valid_token_mask(
            hs, ws, g["pad_h"], g["Wp"], wh, ww, g["sh"],
            g["sw"]).reshape(shape)
        if g["sh"] or g["sw"]:
            aux[f"s{stage}_mask"] = _shift_mask_refgrid(
                g, wh, ww).reshape(shape + (nn,))

    tcfg = cfg.transformer
    twh, tww = tcfg.encoder_window_size
    nn = twh * tww
    h2, w2 = H // 8, W // 8
    g = _grid_meta(h2, w2, twh, tww, tcfg.encoder_shift_size, n)
    g["count"] = float(h2 * w2)
    g["count_ref"] = float(g["pad_h_ref"] * g["Wp"])
    meta["st"] = g
    shape = (g["nwh_pad"], g["nww"], nn)
    aux["st_pm"] = valid_token_mask(h2, w2, g["pad_h"], g["Wp"], twh, tww,
                                    g["sh"], g["sw"]).reshape(shape)
    aux["st_refpad"] = valid_token_mask(
        g["pad_h_ref"], g["Wp"], g["pad_h"], g["Wp"], twh, tww, g["sh"],
        g["sw"]).reshape(shape)
    if g["sh"] or g["sw"]:
        aux["st_mask"] = _shift_mask_refgrid(g, twh,
                                             tww).reshape(shape + (nn,))
    return aux, meta


@functools.lru_cache(maxsize=16)
def _build_aux(H: int, W: int, cfg: ModelConfig, n: int, index: int,
               device: torch.device):
    """This band's slab of every mask (its window rows, flattened to
    (nW_loc, N) and (nW_loc, N, N), float32, contiguous, on ``device``)
    and the geometry; built once per (shape, config, band). Built outside
    inference mode, as the port's other cached constants, so that any
    caller may use them."""
    arrays, meta = _aux_arrays(H, W, cfg, n)
    aux = {}
    with torch.inference_mode(False):
        for name, a in arrays.items():
            rows = a.shape[0] // n
            slab = a[index * rows:(index + 1) * rows]
            aux[name] = torch.from_numpy(np.ascontiguousarray(
                slab.reshape((-1,) + slab.shape[2:]))).to(device)
    return aux, meta


def spatial_shmap_unsupported(cfg: ModelConfig, H: int, W: int,
                              n: int) -> Optional[str]:
    """Reason this (config, shape, band count) cannot run the band-owned
    path, or None. Same support envelope as the windowed fast path (one
    shared window geometry) plus band-divisibility."""
    t = cfg.transformer
    if t.decoder_use_regular_MHA_instead_of_Swin_at_the_end:
        return "regular-MHA decoder tail is global attention (not banded)"
    if (t.encoder_window_size != t.decoder_window_size
            or t.encoder_shift_size != t.decoder_shift_size
            or t.encoder_dim != t.decoder_dim):
        return "encoder/decoder window geometries differ"
    if H % 8 or W % 8:
        return f"H, W must be multiples of 8 (patch embed + merge): {H}x{W}"
    if (H // 4) % n or (H // 8) % n:
        return f"token rows must divide the space axis: H={H}, n={n}"
    if (H // (4 * n)) % 2:
        return "per-band stage-1 rows must be even for PatchMerging"
    return None


def _stylize_features_local(params, content, style, aux, *, cfg, k, band,
                            meta):
    """Per-band body: Swin (content + style batched) and the style
    transformer on H-bands. Returns the feature band for the decoder."""
    sd = DTYPES[cfg.stage_dtype("swin")]
    b = content.shape[0]
    both = torch.cat([content.to(sd), style.to(sd)])
    with _stage_ctx(cfg, "swin"):
        feats = _swin_local(params["swin"], both, cfg.swin, aux, meta, band)
    td = DTYPES[cfg.stage_dtype("transformer")]
    fc, fs = feats[:b].to(td), feats[b:].to(td)
    with _stage_ctx(cfg, "transformer"):
        return _st_local(params["style_transformer"], fc, fs,
                         cfg.transformer, aux, meta, band, k)


def plain_decoder(cfg: ModelConfig) -> ModelConfig:
    """cfg with the decoder's plain nine-conv form (no phase space, no
    stencil kernels): the form the band path runs at n > 1."""
    return cfg.replace(decoder=cfg.decoder.replace(
        fuse_upsample=False, use_stencil_conv=False, use_pallas=False))


def make_spatial_stylize_shmap(cfg: ModelConfig, mesh: DeviceMesh, *,
                               k: int = 1, space_axis: str = "space",
                               data_axis: Optional[str] = None):
    """Band-owned spatial stylize on this rank: returns ``fn(params,
    content, style)`` where content and style are this rank's shards,
    (B / data, H / n, W, 3) (``parallel.spatial.shard_images_spatial``;
    with ``data_axis`` the batch is split over that axis too, and each
    data row of the mesh runs on its own), params the whole tree on this
    rank's device (``parallel.mesh.replicate``), and the result this rank's
    band of the float32 RGB output (``gather_images_spatial`` puts the
    bands together). Every rank of the mesh calls fn together.

    The Swin and the style transformer run band-owned with explicit halos;
    the decoder runs as configured at n = 1 and as the plain nine-conv
    decoder, band-local, at n > 1 (JAX swaps to that form there too and
    lets GSPMD shard it; measured r5 in JAX: the phase decoder is the
    faster one on one device)."""
    band = band_of(mesh, space_axis)
    if data_axis is not None:
        axis_index(mesh, data_axis)
    n = band.n
    ccfg = cfg if n == 1 else plain_decoder(cfg)

    def fn(params, content, style):
        _, hb, W, _ = content.shape
        H = hb * n
        bad = spatial_shmap_unsupported(ccfg, H, W, n)
        if bad:
            raise ValueError(f"band-owned spatial path unsupported: {bad}")
        if style.shape != content.shape:
            raise ValueError(f"style shard {tuple(style.shape)} and content "
                             f"shard {tuple(content.shape)} differ")
        aux, meta = _build_aux(H, W, ccfg, n, band.index, content.device)
        with torch.inference_mode():
            fcs = _stylize_features_local(params, content, style, aux,
                                          cfg=ccfg, k=k, band=band,
                                          meta=meta)
            dd = DTYPES[ccfg.stage_dtype("decoder")]
            with _stage_ctx(ccfg, "decoder"):
                if n == 1:
                    out = cnn_decoder_apply(params["decoder"], fcs.to(dd),
                                            ccfg.decoder)
                else:
                    out = _band_decoder(params["decoder"], fcs.to(dd),
                                        ccfg.decoder, band)
            return out.float()

    return fn
