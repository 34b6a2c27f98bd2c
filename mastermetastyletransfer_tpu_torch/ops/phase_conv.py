"""The decoder's phase-space kernels (JAX counterparts: the Pallas kernels K5
``stencil_phase_conv``, K6 ``stencil_phase2_conv`` and
``stencil_phase2_conv_padcols``, K7 ``phase_align`` and K12
``stencil_phase2_rgb`` and ``stencil_phase2_rgb128`` in ops/pallas_conv.py),
over the phase tensors of ops/conv.py.

* ``stencil_phase_conv`` (K5) and ``stencil_phase2_conv`` (K6): a 2x2-tap
  convolution of a padded phase tensor pp (B, H+2, W+2, Cin) into 4 (K5)
  or 16 (K6) output groups of C' channels, each group reading pp at its own
  offset (the phase align folded into the reads), then bias, ReLU and one
  rounding to the input type:

      out[b, i, j, g] = ReLU(sum over (dy, dx) of
                             pp[b, i + oy_g + dy, j + ox_g + dx] @ w[dy, dx][:, g]
                             + bias[g])

* ``stencil_phase2_conv_padcols`` (K6): the same, returned with the next L2
  conv's phase-pad columns, (B, H, W+2, 16 C');
* ``phase_align`` (K7): (B, H+1, W+1, 4 C') -> (B, H, W, 4 C'), group
  g = 2a + b taken at offset (a, b);
* ``stencil_phase2_rgb`` and ``stencil_phase2_rgb128`` (K12): the RGB conv
  on the L2 phase tensor, the same stencil with groups of C' <= 8 channels
  and the read offsets of the align bases; the first returns the
  interleaved fine grid (B, 4H, 4W, C'), the second the aligned L2 tensor
  (B, H, W, 128) with group g in lanes [8g, 8g + 8).

All six are one CUDA source (csrc/phase_conv.cu). K5 at bfloat16, both K6
entries and both K12 entries run its tensor-core stencil body
(csrc/stencil_tc.cuh; at float32 its FMA form, never TF32), whose tiling
``stencil_plan`` below computes and passes in; K5 at float32 runs the
scalar-FMA body. Each wrapper runs its kernel for a CUDA tensor and
the plain PyTorch version below for a CPU tensor; any other device raises.
The plain versions are the yardstick the kernels are held to: f32 sums of
products of T-typed operands, the f32 bias, ReLU, and one rounding to T,
as the kernels and the JAX kernels do.

K5, K6's plain entry, K7 and both K12 entries are
``torch.autograd.Function``s whose backward passes are plain PyTorch ports
of the JAX package's (plain XLA there too); K6's pad-columns entry is for
evaluation and refuses autograd on the card
(ops/window_block.py:refuse_grad).

``LAUNCHES`` counts kernel launches per entry; a wrapper adds one only where
it launches its kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from mastermetastyletransfer_tpu_torch.ops import _build
from mastermetastyletransfer_tpu_torch.ops.window_block import (
    _need, _on_cuda, refuse_grad,
)

LAUNCHES = {"stencil_phase_conv": 0, "stencil_phase2_conv": 0,
            "stencil_phase2_conv_padcols": 0, "phase_align": 0,
            "stencil_phase2_rgb": 0, "stencil_phase2_rgb128": 0}

PadMaps = Sequence[Tuple[int, int]]


class GroupTable(NamedTuple):
    """What the stencil kernel needs of a composed phase kernel, per output
    group g: its read offsets into the padded input, and the bitmask of its
    nonzero weight blocks, bit tap * nchunks + chunk (tap = 2 dy + dx; the
    input channels split into ``nchunks`` equal chunks, its input phases).
    Built from the phase algebra in ops/conv.py, never from the weights."""
    offsets: Tuple[Tuple[int, int], ...]
    blocks: Tuple[int, ...]
    nchunks: int

    @property
    def present(self) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
        """Per group, the (dy, dx) taps with a nonzero block (the JAX
        kernels' ``present``)."""
        return tuple(tuple((t // 2, t % 2) for t in range(4)
                           if (mask >> (t * self.nchunks))
                           & ((1 << self.nchunks) - 1))
                     for mask in self.blocks)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _stencil_plain(pp: torch.Tensor, pk: torch.Tensor, bias: torch.Tensor,
                   offsets, relu: bool) -> torch.Tensor:
    """Every group over all four taps (the absent blocks of the composed
    kernels are exact zeros and add nothing). Products of T-typed operands
    summed in f32 (float32 matmuls, which PyTorch runs without TF32 by
    default), the f32 bias, ReLU, one rounding."""
    _, hp, wp, _ = pp.shape
    h, w = hp - 2, wp - 2
    c_out = pk.shape[-1] // len(offsets)
    ppf, pkf = pp.float(), pk.float()
    outs = []
    for g, (oy, ox) in enumerate(offsets):
        cols = slice(g * c_out, (g + 1) * c_out)
        acc = None
        for dy in range(2):
            for dx in range(2):
                t = (ppf[:, oy + dy:oy + dy + h, ox + dx:ox + dx + w]
                     @ pkf[dy, dx, :, cols])
                acc = t if acc is None else acc + t
        outs.append(acc)
    y = torch.cat(outs, -1) + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(pp.dtype)


def stencil_phase_conv_plain(pp: torch.Tensor, pk: torch.Tensor,
                             bias4: torch.Tensor, table: GroupTable,
                             relu: bool = True) -> torch.Tensor:
    """K5's function: (B, H+2, W+2, Cin) -> (B, H, W, 4 C')."""
    return _stencil_plain(pp, pk, bias4, table.offsets, relu)


def stencil_phase2_conv_plain(pp: torch.Tensor, pk: torch.Tensor,
                              bias16: torch.Tensor, table: GroupTable,
                              relu: bool = True) -> torch.Tensor:
    """K6's function: (B, H+2, W+2, Cin) -> (B, H, W, 16 C')."""
    return _stencil_plain(pp, pk, bias16, table.offsets, relu)


@functools.lru_cache(maxsize=None)
def _border_index(maps: Tuple[Tuple[int, int], ...], nph: int, c: int,
                  row_axis: bool, device: torch.device) -> torch.Tensor:
    """pad_border's gather index over the stacked sources, on device (built
    outside inference mode: cached, it may serve autograd too)."""
    srcs = sorted({s for s, _ in maps})
    n2c = nph * nph * c
    with torch.inference_mode(False):
        lane = torch.arange(n2c)
        r, q, ch = lane // (nph * c), (lane // c) % nph, lane % c
        slot, other = (r, q) if row_axis else (q, r)
        which = torch.tensor([srcs.index(s) for s, _ in maps])[slot]
        phase = torch.tensor([p for _, p in maps])[slot]
        group = phase * nph + other if row_axis else other * nph + phase
        return (which * n2c + group * c + ch).to(device)


def pad_border(get: Callable[[int], torch.Tensor], maps: PadMaps, nph: int,
               c: int, row_axis: bool) -> torch.Tensor:
    """One phase-pad border row (``row_axis``) or column of a phase tensor
    with nph x nph phase groups of c channels: pad slot g copies, for every
    phase along the other axis and every channel, the lane group of source
    index maps[g][0] whose phase along this axis is maps[g][1]
    (ops/conv.py:_phase2_pad_maps). ``get(s)`` returns source row or column
    s, (..., nph^2 c). One exact index gather over the stacked sources,
    its index built once per maps, shape and device."""
    maps = tuple(tuple(m) for m in maps)
    stacked = torch.cat([get(s) for s in sorted({s for s, _ in maps})], -1)
    return stacked.index_select(
        -1, _border_index(maps, nph, c, row_axis, stacked.device))


def stencil_phase2_conv_padcols_plain(pp: torch.Tensor, pk: torch.Tensor,
                                      bias16: torch.Tensor,
                                      table: GroupTable,
                                      colmaps: Tuple[PadMaps, PadMaps],
                                      relu: bool = True) -> torch.Tensor:
    """K6 padcols' function: the L2 output with its pad columns, (B, H,
    W+2, 16 C'). ``colmaps`` = (left, right) slot maps of the columns
    (ops/conv.py:_phase2_pad_maps(W, 4, False))."""
    y = stencil_phase2_conv_plain(pp, pk, bias16, table, relu)
    c_out = y.shape[-1] // 16
    left, right = (pad_border(lambda s: y[:, :, s], m, 4, c_out, False)
                   for m in colmaps)
    return torch.cat([left[:, :, None], y, right[:, :, None]], 2)


def phase_align_plain(big: torch.Tensor, c_out: int) -> torch.Tensor:
    """K7's function: (B, H+1, W+1, 4 C') -> (B, H, W, 4 C'), group
    g = 2a + b at offset (a, b)."""
    _, hp, wp, _ = big.shape
    h, w = hp - 1, wp - 1
    return torch.cat([big[:, a:a + h, b:b + w,
                          (2 * a + b) * c_out:(2 * a + b + 1) * c_out]
                      for a in range(2) for b in range(2)], -1)


def rgb_table(bases) -> GroupTable:
    """The dense table of K12's JAX kernels: group g = 4a + b reads at
    (bases[a], bases[b]) and every tap's whole input (one chunk)."""
    return GroupTable(tuple((bases[g // 4], bases[g % 4])
                            for g in range(16)), (0b1111,) * 16, 1)


def _rgb_aligned(pp: torch.Tensor, pk: torch.Tensor, bias: torch.Tensor,
                 bases, relu: bool) -> torch.Tensor:
    """K12's sums: the composed 2x2 conv of pp over (H+1, W+1) in f32
    (float32 products of T-typed operands), the f32 bias, ReLU, and group g
    = 4a + b of its N / 16 lanes taken at (bases[a], bases[b]); (B, H, W,
    N), f32, not yet rounded."""
    _, hp, wp, _ = pp.shape
    h, w = hp - 2, wp - 2
    cg = pk.shape[-1] // 16
    ppf, pkf = pp.float(), pk.float()
    big = None
    for dy in range(2):
        for dx in range(2):
            t = ppf[:, dy:dy + h + 1, dx:dx + w + 1] @ pkf[dy, dx]
            big = t if big is None else big + t
    big = big + bias.float()
    if relu:
        big = torch.relu(big)
    return torch.cat([big[:, bases[g // 4]:bases[g // 4] + h,
                          bases[g % 4]:bases[g % 4] + w,
                          g * cg:(g + 1) * cg] for g in range(16)], -1)


def _interleave(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 16 C), group 4a + b -> the fine grid (B, 4H, 4W, C)."""
    b, h, w, c16 = x.shape
    c = c16 // 16
    return (x.reshape(b, h, w, 4, 4, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, 4 * h, 4 * w, c))


def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    """The fine grid (B, 4H, 4W, C) -> (B, H, W, 16 C), group 4a + b."""
    b, h4, w4, c = x.shape
    return (x.reshape(b, h4 // 4, 4, w4 // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, h4 // 4, w4 // 4, 16 * c))


def stencil_phase2_rgb_plain(pp: torch.Tensor, pk: torch.Tensor,
                             bias16: torch.Tensor, bases,
                             relu: bool = False) -> torch.Tensor:
    """K12 ``rgb``'s function: pp (B, H+2, W+2, Cin), pk (2, 2, Cin, 16 C')
    -> the fine grid (B, 4H, 4W, C'); one rounding to pp's type, as
    ``_rgb_kernel`` rounds its sums before its exact selection."""
    return _interleave(_rgb_aligned(pp, pk, bias16, bases, relu)
                       .to(pp.dtype))


def stencil_phase2_rgb128_plain(pp: torch.Tensor, pk128: torch.Tensor,
                                bias128: torch.Tensor, bases,
                                relu: bool = False) -> torch.Tensor:
    """K12 ``rgb128``'s function: pk128 (2, 2, Cin, 128) with group g's
    lanes at [8g, 8g + 8) -> the aligned L2 tensor (B, H, W, 128), zero
    lanes included; one rounding, as ``_rgb128_kernel`` rounds after its
    masked align."""
    return _rgb_aligned(pp, pk128, bias128, bases, relu).to(pp.dtype)


# ---------------------------------------------------------------------------
# The tensor-core body's plan (csrc/stencil_tc.cuh)
# ---------------------------------------------------------------------------

_TILE = (8, 16)             # coarse output pixels per block (rows, columns)
_SMEM_CAP = 200 * 1024      # the kernel's dynamic shared memory limit
# The decoder's tables that the body compiles in (csrc/stencil_tc.cuh:
# kPatDense, kPatPhase, kPatRgb, kPatL2Up): every pair of each used chunk
# (K5's upsample kernel, K12's JAX tables), K5's L1 phase-space kernel,
# K12's L2 RGB kernel and K6's L2 up-conv kernel (bit 4 g + tap of a
# chunk's word), each with the read offsets of _known_offsets.
PATTERNS = ("", "_dense", "_phase", "_l2", "_l2up")
_PHASE_BITS = (0xfac8, 0x5f4c, 0x32fa, 0x135f)
_RGB_BITS = (
    0x8048000020128048, 0x0448000001120448, 0x4440000011104440,
    0x4404000011014404, 0x0000201220128048, 0x0000011201120448,
    0x0000111011104440, 0x0000110111014404, 0x2012201220120000,
    0x0112011201120000, 0x1110111011100000, 0x1101110111010000,
    0x2012201200002012, 0x0112011200000112, 0x1110111000001110,
    0x1101110100001101)
_L2UP_BITS = (0x8448211221128448, 0x4444111111114444, 0x2112211221122112,
              0x1111111111111111)


def _known_offsets(groups: int) -> Tuple[Tuple[int, int], ...]:
    """The read offsets of the compiled tables: (g // 2, g % 2) for 4
    groups, the align bases (0, 1, 1, 1) for 16."""
    if groups == 4:
        return tuple((g // 2, g % 2) for g in range(4))
    return tuple((min(g // 4, 1), min(g % 4, 1)) for g in range(16))


class StencilPlan(NamedTuple):
    """How the tensor-core stencil body tiles one call; built by
    ``stencil_plan`` and passed to the kernel as it is (``TilePlan``).

    A block owns a ``tile`` of coarse output pixels of one image and the
    same ``bn`` output channels of every group; blocks run channel slice
    fastest, then tiles row-major, then images (``blocks`` of them). For
    each chunk in ``used`` and each ``stage_k``-deep slice of it, the block
    stages the tile's halo window ((rows + 2) x (columns + 2) pixels) and
    the weight rows of the chunk's ``pairs`` (the (group, tap) of each
    weight slot, by group and then tap) in a ring of ``stages`` slices of
    ``smem_bytes``. ``pattern`` indexes PATTERNS: one of the decoder's
    tables, whose pairs the kernel has compiled in, or 0 for any other.
    ``kernel`` names the compiled instantiation. The output tile goes out
    in 16-byte pieces, and K6's padcols entry writes each piece of a pad
    slot's source column to the slot too (csrc/stencil_tc.cuh)."""
    kernel: str
    tile: Tuple[int, int]
    bn: int
    stage_k: int
    stages: int
    blocks: int
    smem_bytes: int
    max_pairs: int
    used: Tuple[int, ...]
    pairs: Tuple[Tuple[Tuple[int, int], ...], ...]
    pattern: int


def _smem_bytes(kind: str, groups: int, bn: int, stages: int, sk: int,
                max_pairs: int, c_out: int, esize: int) -> int:
    """The dynamic shared memory of one block (csrc/stencil_tc.cuh:
    tc_smem_bytes): the ring of halo and weight slices, each row padded by
    16 bytes where ldmatrix reads it (K12 rgb's weights, C' < 8 lanes a
    group, as the whole rows of up to four taps), or the output tile (padded
    rows of every group's slice; the fine tile for rgb) where larger."""
    th, tw = _TILE
    a_row = sk + 16 // esize
    b_row = bn + (8 if esize == 2 and bn >= 16 else 0)
    b_elems = (4 * sk * groups * c_out if c_out < bn
               else max_pairs * sk * b_row)
    ring = stages * ((th + 2) * (tw + 2) * a_row + b_elems) * esize
    if kind == "rgb":
        tile = 16 * th * tw * c_out * esize
    else:
        tile = th * tw * (groups * bn + 16 // esize) * esize
    return max(ring, tile)


@functools.lru_cache(maxsize=None)
def stencil_plan(table: GroupTable, kind: str, b: int, h: int, w: int,
                 cin: int, c_out: int, dtype: torch.dtype) -> StencilPlan:
    """The tensor-core body's tiling of one call: ``kind`` "stencil" (K5,
    and any table of C' % 32 == 0 channels per group), "phase2" (K6's two
    entries, 16 groups, slices of 16 (bfloat16) or 8 (float32, the FMA
    form) of C' % 32 == 0 channels), "rgb" or
    "rgb128" (K12, C' <= 8 channels per group in one 8-lane slot); pp (b,
    h + 2, w + 2, cin) of ``dtype``. Stages 32 channels deep where the ring
    fits in _SMEM_CAP, else 16; at bfloat16 names the compiled table the
    decoder's tables match (PATTERNS)."""
    groups, nchunks = len(table.offsets), table.nchunks
    esize = torch.finfo(dtype).bits // 8
    if kind == "stencil":
        bn = 64 if c_out % 64 == 0 else 32
        stages, kernel, nsplit = 3, f"stencil_tc{bn}", c_out // bn
    elif kind == "phase2":
        bn, stages = (16, 3) if dtype == torch.bfloat16 else (8, 4)
        kernel, nsplit = f"stencil2_tc{bn}", c_out // bn
    else:
        bn, stages, kernel, nsplit = 8, 4, kind, 1
    pairs = tuple(tuple((g, t) for g in range(groups) for t in range(4)
                        if (table.blocks[g] >> (t * nchunks + c)) & 1)
                  for c in range(nchunks))
    max_pairs = max(len(p) for p in pairs)
    chunk = cin // nchunks
    sk = 16
    if chunk % 32 == 0 and _smem_bytes(kind, groups, bn, stages, 32,
                                       max_pairs, c_out,
                                       esize) <= _SMEM_CAP:
        sk = 32
    smem = _smem_bytes(kind, groups, bn, stages, sk, max_pairs, c_out, esize)
    if smem > _SMEM_CAP:
        raise ValueError(f"{max_pairs} pairs per chunk need {smem} bytes of "
                         "shared memory")
    th, tw = _TILE
    blocks = b * -(-h // th) * -(-w // tw) * nsplit
    used = tuple(c for c in range(nchunks) if pairs[c])
    bits = tuple(sum(1 << (4 * g + t) for g, t in p) for p in pairs)
    pattern = 0
    if (dtype == torch.bfloat16 and groups == (4 if kind == "stencil" else 16)
            and table.offsets == _known_offsets(groups)):
        if kind == "phase2":
            pattern = 4 if bits == _L2UP_BITS else 0
        elif all(bits[c] == (1 << 4 * groups) - 1 for c in used):
            pattern = 1
        elif groups == 4 and bits == _PHASE_BITS:
            pattern = 2
        elif groups == 16 and bits == _RGB_BITS:
            pattern = 3
    return StencilPlan(kernel + PATTERNS[pattern], _TILE, bn, sk, stages,
                       blocks, smem, max_pairs, used, pairs, pattern)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_LL = ctypes.c_longlong
_UB = ctypes.c_ubyte


class TilePlan(ctypes.Structure):
    """The C struct ``TilePlan`` of csrc/stencil_tc.cuh, field for field."""
    _fields_ = ([(f, _LL) for f in ("tile_h", "tile_w", "bn", "stage_k",
                                    "stages", "blocks", "smem_bytes",
                                    "max_pairs", "nused", "pattern")]
                + [("used", _UB * 16), ("npairs", _UB * 16),
                   ("pairs", (_UB * 64) * 16)])


@functools.lru_cache(maxsize=None)
def tile_plan_struct(plan: StencilPlan) -> TilePlan:
    """``plan`` as the kernel reads it: per chunk, slot -> group | tap << 4
    (the kernel inverts it into each group's taps and their slots)."""
    t = TilePlan(tile_h=plan.tile[0], tile_w=plan.tile[1], bn=plan.bn,
                 stage_k=plan.stage_k, stages=plan.stages,
                 blocks=plan.blocks, smem_bytes=plan.smem_bytes,
                 max_pairs=plan.max_pairs, nused=len(plan.used),
                 pattern=plan.pattern)
    for i, c in enumerate(plan.used):
        t.used[i] = c
    for c, slots in enumerate(plan.pairs):
        t.npairs[c] = len(slots)
        for slot, (g, tap) in enumerate(slots):
            t.pairs[c][slot] = g | tap << 4
    return t


class StencilArgs(ctypes.Structure):
    """The C struct ``StencilArgs`` of csrc/phase_conv.cu, field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("pp", "w", "bias", "out")]
                + [(f, _LL) for f in ("dtype", "B", "H", "W", "Cin", "Cout",
                                      "groups", "nchunks", "relu",
                                      "padcols")]
                + [("off_y", _LL * 16), ("off_x", _LL * 16),
                   ("blocks", ctypes.c_ulonglong * 16)]
                + [(f, _LL * 4) for f in ("left_src", "left_ph", "right_src",
                                          "right_ph")]
                + [("plan", TilePlan)])


class RgbArgs(ctypes.Structure):
    """The C struct ``RgbArgs`` of csrc/phase_conv.cu, field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("pp", "w", "bias", "out")]
                + [(f, _LL) for f in ("dtype", "B", "H", "W", "Cin", "Cg",
                                      "nchunks", "relu")]
                + [("off_y", _LL * 16), ("off_x", _LL * 16),
                   ("blocks", ctypes.c_ulonglong * 16), ("plan", TilePlan)])


class AlignArgs(ctypes.Structure):
    """The C struct ``AlignArgs`` of csrc/phase_conv.cu."""
    _fields_ = ([("big", ctypes.c_void_p), ("out", ctypes.c_void_p)]
                + [(f, _LL) for f in ("tsize", "B", "H", "W", "Cout")])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("phase_conv")
    for entry in LAUNCHES:
        fn = getattr(lib, f"mmst_{entry}")
        args = (AlignArgs if entry == "phase_align" else
                RgbArgs if "rgb" in entry else StencilArgs)
        fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mmst_phase_conv_attributes.argtypes = [
        _LL, _LL, _LL, *[ctypes.POINTER(_LL)] * 3]
    lib.mmst_phase_conv_attributes.restype = ctypes.c_int
    return lib


_KERNELS = ("stencil", "align", "rgb", "rgb128", "stencil_tc64",
            "stencil_tc32", "stencil2_tc16", "stencil2_tc8")


def kernel_attributes(kernel: str, dtype: torch.dtype
                      ) -> Tuple[int, int, int]:
    """(static shared memory bytes per block, dynamic shared memory bytes,
    registers per thread) of a kernel at ``dtype``: "stencil" (the
    scalar-FMA body: K5 at float32), "align", or a StencilPlan's
    ``kernel`` of the tensor-core body ("rgb", "rgb128", K5's
    "stencil_tc64" and "stencil_tc32", K6's "stencil2_tc16" at bfloat16
    and "stencil2_tc8" at float32, each with the suffix of its compiled
    table, PATTERNS). Dynamic: the largest a launch of the kernel
    has used so far in this process (0 for the kernels that use none)."""
    base, pattern = kernel, 0
    for i, suffix in enumerate(PATTERNS[1:], 1):
        if kernel.endswith(suffix):
            base, pattern = kernel[:-len(suffix)], i
    smem, dyn, regs = _LL(), _LL(), _LL()
    err = _lib().mmst_phase_conv_attributes(
        _KERNELS.index(base), int(dtype == torch.bfloat16), pattern,
        ctypes.byref(smem), ctypes.byref(dyn), ctypes.byref(regs))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes: CUDA error {err}")
    return smem.value, dyn.value, regs.value


def _aligned(name: str, t: torch.Tensor) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _call(entry: str, args: ctypes.Structure, dev: torch.device) -> None:
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(_lib(), f"mmst_{entry}")(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    LAUNCHES[entry] += 1


def _stencil_launch(entry: str, pp: torch.Tensor, pk: torch.Tensor,
                    bias: torch.Tensor, table: GroupTable, relu: bool,
                    colmaps=None) -> torch.Tensor:
    """Check what the kernel takes and launch it."""
    if pp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pp is {pp.dtype}; the kernel takes float32 or "
                        "bfloat16")
    if pp.dim() != 4:
        raise ValueError(f"pp has shape {tuple(pp.shape)}, not (B, H+2, "
                         "W+2, Cin)")
    b, hp, wp, cin = pp.shape
    h, w = hp - 2, wp - 2
    groups = len(table.offsets)
    n = pk.shape[-1]
    c_out = n // groups
    if h < 1 or w < 1 or (colmaps is not None and w < 2):
        raise ValueError(f"pp of {hp}x{wp} is too small for the stencil")
    if n % groups or c_out % 32:
        raise ValueError(f"{n} output channels do not split into {groups} "
                         "groups of a multiple of 32")
    if (len(table.blocks) != groups or table.nchunks < 1
            or cin % (16 * table.nchunks)):
        raise ValueError(f"Cin={cin} does not split into {table.nchunks} "
                         "chunks of a multiple of 16, or the table has "
                         f"{len(table.blocks)} groups, not {groups}")
    if not all(o in (0, 1) for off in table.offsets for o in off):
        raise ValueError(f"read offsets {table.offsets} outside 0..1")
    dev = pp.device
    _need("pp", pp, pp.shape, pp.dtype, dev)
    _need("pk", pk, (2, 2, cin, n), pp.dtype, dev)
    _need("bias", bias, (n,), torch.float32, dev)
    padcols = int(colmaps is not None)
    out = torch.empty((b, h, w + 2 * padcols, n), dtype=pp.dtype, device=dev)
    for name, t in (("pp", pp), ("pk", pk), ("bias", bias), ("out", out)):
        _aligned(name, t)

    def table16(vals):
        vals = list(vals)
        return vals + [0] * (16 - len(vals))

    args = StencilArgs(
        pp=pp.data_ptr(), w=pk.data_ptr(), bias=bias.data_ptr(),
        out=out.data_ptr(), dtype=int(pp.dtype == torch.bfloat16), B=b, H=h,
        W=w, Cin=cin, Cout=c_out, groups=groups, nchunks=table.nchunks,
        relu=int(relu), padcols=padcols,
        off_y=(_LL * 16)(*table16(o[0] for o in table.offsets)),
        off_x=(_LL * 16)(*table16(o[1] for o in table.offsets)),
        blocks=(ctypes.c_ulonglong * 16)(*table16(table.blocks)))
    if colmaps is not None:
        (lsrc, lph), (rsrc, rph) = (zip(*m) for m in colmaps)
        args.left_src, args.left_ph = (_LL * 4)(*lsrc), (_LL * 4)(*lph)
        args.right_src, args.right_ph = (_LL * 4)(*rsrc), (_LL * 4)(*rph)
    if pp.dtype == torch.bfloat16 or entry != "stencil_phase_conv":
        args.plan = tile_plan_struct(stencil_plan(
            table, "stencil" if entry == "stencil_phase_conv" else "phase2",
            b, h, w, cin, c_out, pp.dtype))
    _call(entry, args, dev)
    return out


# ---------------------------------------------------------------------------
# Backward passes (plain: the JAX package's are plain XLA inside its
# custom_vjps, not Pallas kernels)
# ---------------------------------------------------------------------------

def stencil_conv_bwd_plain(g: torch.Tensor, pp: torch.Tensor,
                           pk: torch.Tensor, bias: torch.Tensor,
                           y: torch.Tensor, table: GroupTable, relu: bool):
    """The stencil conv's backward without recomputing the forward (JAX
    ops/pallas_conv.py:_stencil_bwd and _stencil2_bwd): the ReLU mask from
    the saved output y, the cotangent scattered back through the align (each
    group's read offset) onto the (H+1, W+1) grid of the conv, then the
    transposes of the VALID conv for pp and pk, in pp's type, and the bias
    grad as an f32 sum. Returns (d pp, d pk, d bias)."""
    if relu:
        g = g * (y > 0).to(g.dtype)
    b, hp, wp, _ = pp.shape
    h, w = hp - 2, wp - 2
    n = pk.shape[-1]
    c_out = n // len(table.offsets)
    d_big = g.new_zeros((b, h + 1, w + 1, n))
    for i, (oy, ox) in enumerate(table.offsets):
        cols = slice(i * c_out, (i + 1) * c_out)
        d_big[:, oy:oy + h, ox:ox + w, cols] = g[..., cols]
    d_nchw = d_big.to(pp.dtype).permute(0, 3, 1, 2)
    w_oihw = pk.to(pp.dtype).permute(3, 2, 0, 1)
    pp_nchw = pp.permute(0, 3, 1, 2)
    d_pp = torch.nn.grad.conv2d_input(pp_nchw.shape, w_oihw, d_nchw)
    d_pk = torch.nn.grad.conv2d_weight(pp_nchw, w_oihw.shape, d_nchw)
    d_bias = d_big.float().sum((0, 1, 2))
    return (d_pp.permute(0, 2, 3, 1), d_pk.permute(2, 3, 1, 0).to(pk.dtype),
            d_bias.to(bias.dtype))


def phase_align_bwd_plain(g: torch.Tensor, c_out: int) -> torch.Tensor:
    """K7's backward (JAX ops/pallas_conv.py:_phase_align_bwd): the align is
    a selection whose groups are disjoint, so each group's cotangent is
    padded back to its offset on the (H+1, W+1) grid."""
    parts = []
    for a in range(2):
        for b in range(2):
            gi = 2 * a + b
            parts.append(torch.nn.functional.pad(
                g[..., gi * c_out:(gi + 1) * c_out],
                (0, 0, b, 1 - b, a, 1 - a)))
    return torch.cat(parts, -1)


class _StencilConv(torch.autograd.Function):
    """K5 or K6's plain entry with the plain backward: the kernel forward
    for a CUDA tensor, the plain version for a CPU one. Saves pp, pk, the
    bias and the output, as the JAX package's custom_vjp does."""

    @staticmethod
    def forward(ctx, pp, pk, bias, table, relu, entry):
        if _on_cuda(pp):
            groups = 4 if entry == "stencil_phase_conv" else 16
            if len(table.offsets) != groups:
                raise ValueError(f"{entry} takes {groups} output groups")
            y = _stencil_launch(entry, pp, pk, bias, table, relu)
        else:
            y = _stencil_plain(pp, pk, bias, table.offsets, relu)
        ctx.save_for_backward(pp, pk, bias, y)
        ctx.table, ctx.relu = table, relu
        return y

    @staticmethod
    def backward(ctx, g):
        pp, pk, bias, y = ctx.saved_tensors
        return (*stencil_conv_bwd_plain(g, pp, pk, bias, y, ctx.table,
                                        ctx.relu), None, None, None)


class _PhaseAlign(torch.autograd.Function):
    """K7 with its plain backward."""

    @staticmethod
    def forward(ctx, big, c_out):
        ctx.c_out = c_out
        if _on_cuda(big):
            return _align_launch(big, c_out)
        return phase_align_plain(big, c_out)

    @staticmethod
    def backward(ctx, g):
        return phase_align_bwd_plain(g, ctx.c_out), None


def stencil_phase_conv(pp: torch.Tensor, pk: torch.Tensor,
                       bias4: torch.Tensor, table: GroupTable,
                       relu: bool = True) -> torch.Tensor:
    """K5: pp (B, H+2, W+2, Cin) edge-padded (phase or coarse) tensor, pk
    (2, 2, Cin, 4 C') composed kernel in pp's type, bias4 (4 C',) float32,
    ``table`` its 4 groups -> the aligned phase tensor (B, H, W, 4 C').
    Differentiable (a plain backward)."""
    return _StencilConv.apply(pp, pk, bias4, table, relu,
                              "stencil_phase_conv")


def stencil_phase2_conv(pp: torch.Tensor, pk: torch.Tensor,
                        bias16: torch.Tensor, table: GroupTable,
                        relu: bool = True) -> torch.Tensor:
    """K6: pp (B, H+2, W+2, Cin) phase-padded (ops/conv.py:_phase2_pad),
    pk (2, 2, Cin, 16 C'), ``table`` its 16 groups -> the aligned L2 phase
    tensor (B, H, W, 16 C'). Differentiable (a plain backward)."""
    return _StencilConv.apply(pp, pk, bias16, table, relu,
                              "stencil_phase2_conv")


def stencil_phase2_conv_padcols(pp: torch.Tensor, pk: torch.Tensor,
                                bias16: torch.Tensor, table: GroupTable,
                                colmaps: Tuple[PadMaps, PadMaps],
                                relu: bool = True) -> torch.Tensor:
    """K6 with the next conv's pad columns: (B, H, W+2, 16 C'); the caller
    adds the pad rows (ops/conv.py:_phase2_pad_rows). Evaluation only (the
    JAX entry has no backward): under autograd the CUDA branch raises."""
    if not _on_cuda(pp):
        return stencil_phase2_conv_padcols_plain(pp, pk, bias16, table,
                                                 colmaps, relu)
    refuse_grad("stencil_phase2_conv_padcols", pp, pk, bias16)
    if len(table.offsets) != 16:
        raise ValueError("K6 takes 16 output groups")
    w = pp.shape[2] - 2
    if any(len(m) != 4 or not all(0 <= s < w and 0 <= p < 4 for s, p in m)
           for m in colmaps):
        raise ValueError(f"column maps {colmaps} do not fit W={w}")
    return _stencil_launch("stencil_phase2_conv_padcols", pp, pk, bias16,
                           table, relu, colmaps)


def _align_launch(big: torch.Tensor, c_out: int) -> torch.Tensor:
    if big.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"big is {big.dtype}; the kernel takes float32 or "
                        "bfloat16")
    if big.dim() != 4 or big.shape[-1] != 4 * c_out or c_out % 32:
        raise ValueError(f"big has shape {tuple(big.shape)}; the kernel "
                         "takes (B, H+1, W+1, 4 C') with C' % 32 == 0")
    b, hp, wp, _ = big.shape
    if hp < 2 or wp < 2:
        raise ValueError(f"big of {hp}x{wp} is too small to align")
    _need("big", big, big.shape, big.dtype, big.device)
    out = torch.empty((b, hp - 1, wp - 1, 4 * c_out), dtype=big.dtype,
                      device=big.device)
    _aligned("big", big)
    _aligned("out", out)
    _call("phase_align", AlignArgs(
        big=big.data_ptr(), out=out.data_ptr(), tsize=big.element_size(),
        B=b, H=hp - 1, W=wp - 1, Cout=c_out), big.device)
    return out


def phase_align(big: torch.Tensor, c_out: int) -> torch.Tensor:
    """K7: (B, H+1, W+1, 4 C') -> (B, H, W, 4 C'), exact; differentiable
    (a plain backward)."""
    return _PhaseAlign.apply(big, c_out)


def _rgb_launch(entry: str, pp: torch.Tensor, pk: torch.Tensor,
                bias: torch.Tensor, table: GroupTable,
                relu: bool) -> torch.Tensor:
    """Check what K12's kernel takes and launch it."""
    if pp.dtype not in (torch.float32, torch.bfloat16) or pp.dim() != 4:
        raise TypeError(f"pp is {pp.dtype} of shape {tuple(pp.shape)}; the "
                        "kernel takes a (B, H+2, W+2, Cin) float32 or "
                        "bfloat16 tensor")
    b, hp, wp, cin = pp.shape
    h, w = hp - 2, wp - 2
    n = pk.shape[-1]
    cg = n // 16
    fine = entry == "stencil_phase2_rgb"
    if h < 1 or w < 1:
        raise ValueError(f"pp of {hp}x{wp} is too small for the stencil")
    if n % 16 or not (1 <= cg <= 8) or (not fine and cg != 8):
        raise ValueError(f"{n} output lanes: {entry} takes 16 groups of "
                         + ("1 to 8 channels" if fine else "8 slots"))
    if (len(table.offsets) != 16 or len(table.blocks) != 16
            or table.nchunks < 1 or cin % (16 * table.nchunks)):
        raise ValueError(f"Cin={cin} does not split into {table.nchunks} "
                         "chunks of a multiple of 16, or the table has not "
                         "16 groups")
    dev = pp.device
    _need("pp", pp, pp.shape, pp.dtype, dev)
    _need("pk", pk, (2, 2, cin, n), pp.dtype, dev)
    _need("bias", bias, (n,), torch.float32, dev)
    shape = (b, 4 * h, 4 * w, cg) if fine else (b, h, w, n)
    out = torch.empty(shape, dtype=pp.dtype, device=dev)
    for name, t in (("pp", pp), ("pk", pk), ("out", out)):
        _aligned(name, t)
    args = RgbArgs(
        pp=pp.data_ptr(), w=pk.data_ptr(), bias=bias.data_ptr(),
        out=out.data_ptr(), dtype=int(pp.dtype == torch.bfloat16), B=b, H=h,
        W=w, Cin=cin, Cg=cg, nchunks=table.nchunks, relu=int(relu),
        off_y=(_LL * 16)(*(o[0] for o in table.offsets)),
        off_x=(_LL * 16)(*(o[1] for o in table.offsets)),
        blocks=(ctypes.c_ulonglong * 16)(*table.blocks),
        plan=tile_plan_struct(stencil_plan(
            table, "rgb" if fine else "rgb128", b, h, w, cin, cg,
            pp.dtype)))
    _call(entry, args, dev)
    return out


class _RgbTail(torch.autograd.Function):
    """A K12 entry with the plain backward of the JAX package's custom_vjps
    (``_rgb_bwd``, ``_rgb128_bwd``: plain XLA there): the cotangent
    (un-interleaved for ``rgb``) scattered back through the align onto the
    conv's (H+1, W+1) grid, then the VALID conv's transposes. Saves pp, the
    kernel, the bias and the output."""

    @staticmethod
    def forward(ctx, pp, pk, bias, bases, relu, table, entry):
        fine = entry == "stencil_phase2_rgb"
        if _on_cuda(pp):
            y = _rgb_launch(entry, pp, pk, bias, table, relu)
        elif fine:
            y = stencil_phase2_rgb_plain(pp, pk, bias, bases, relu)
        else:
            y = stencil_phase2_rgb128_plain(pp, pk, bias, bases, relu)
        ctx.save_for_backward(pp, pk, bias, y)
        ctx.bases, ctx.relu, ctx.fine = bases, relu, fine
        return y

    @staticmethod
    def backward(ctx, g):
        pp, pk, bias, y = ctx.saved_tensors
        if ctx.fine:
            g, y = _deinterleave(g), _deinterleave(y)
        grads = stencil_conv_bwd_plain(g, pp, pk, bias, y,
                                       rgb_table(ctx.bases), ctx.relu)
        return (*grads, None, None, None, None)


def _rgb_entry(entry: str, pp, pk, bias, bases, relu, table):
    bases = tuple(int(v) for v in bases)
    dense = rgb_table(bases)
    table = dense if table is None else table
    if table.offsets != dense.offsets:
        raise ValueError(f"table offsets {table.offsets} are not the align "
                         f"of bases {bases}")
    return _RgbTail.apply(pp, pk, bias, bases, relu, table, entry)


def stencil_phase2_rgb(pp: torch.Tensor, pk: torch.Tensor,
                       bias16: torch.Tensor, bases, relu: bool = False,
                       table: Optional[GroupTable] = None) -> torch.Tensor:
    """K12 ``rgb``: pp (B, H+2, W+2, Cin) custom-padded L2 input, pk (2, 2,
    Cin, 16 C') composed kernel in pp's type (C' <= 8), bias16 (16 C',)
    float32, ``bases`` the align bases -> the fine grid (B, 4H, 4W, C').
    ``table``: the kernel's nonzero blocks (ops/conv.py:_phase2_table),
    whose zero blocks the CUDA kernel skips; None, every block.
    Differentiable (a plain backward)."""
    return _rgb_entry("stencil_phase2_rgb", pp, pk, bias16, bases, relu,
                      table)


def stencil_phase2_rgb128(pp: torch.Tensor, pk128: torch.Tensor,
                          bias128: torch.Tensor, bases, relu: bool = False,
                          table: Optional[GroupTable] = None
                          ) -> torch.Tensor:
    """K12 ``rgb128``: pk128 (2, 2, Cin, 128) with group g's C' output
    lanes at [8g, 8g + C') and zeros elsewhere, bias128 (128,) float32 the
    same way -> the aligned L2 tensor (B, H, W, 128); the caller interleaves
    and slices. ``table`` as for ``stencil_phase2_rgb``. Differentiable (a
    plain backward)."""
    return _rgb_entry("stencil_phase2_rgb128", pp, pk128, bias128, bases,
                      relu, table)
