"""NHWC convolution and upsampling of the CNN decoder (JAX counterpart:
ops/conv.py; reference: codes/decoder.py:23-55). Kernels are HWIO, as in
the JAX package.

Besides the plain forms, the phase-space forms: exact rewrites of an
upsample -> reflect pad -> 3x3 conv, or of a 3x3 conv on an upsampled grid,
as 2x2-tap convs on the coarse grid with the fine grid's phases packed into
the channels. One phase level (L1) packs 2x2 phases (4 C channels), the
double level (L2) 4x4 (16 C). With ``use_pallas`` the convs that pass the
stencil gate run the stencil kernels K5 (L1) and K6 (L2), and the L1
realign runs K7 (ops/phase_conv.py); the RGB conv of the L2 tail runs the
RGB-tail kernel K12 where the JAX package runs its RGB kernels; otherwise
a plain conv of the composed kernel, the bias and ReLU in the working type,
and a slice realign, as the JAX package's XLA route computes them.

The composed kernels and repeated biases depend on the weights alone, so
they are built once per weight tensor and type (``_derived``), and the
gather indices once per shape and device: a served decoder runs no
per-call weight algebra and no host-to-device index copy.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc
from mastermetastyletransfer_tpu_torch.ops.mlp import uniform


def init_conv(g: torch.Generator, c_in: int, c_out: int,
              initializer: str = "kaiming_normal_") -> dict:
    """3x3 HWIO conv with the reference's initializers, fan_out mode and
    ReLU gain (reference: codes/decoder.py:58-73)."""
    shape = (3, 3, c_in, c_out)
    fan_out, fan_in = 9 * c_out, 9 * c_in
    gain = 2.0 ** 0.5
    if initializer == "kaiming_normal_":
        kernel = torch.randn(shape, generator=g) * (gain / fan_out ** 0.5)
    elif initializer == "kaiming_uniform_":
        kernel = uniform(g, shape, gain * (3.0 / fan_out) ** 0.5)
    elif initializer == "xavier_normal_":
        kernel = torch.randn(shape, generator=g) * (
            (2.0 / (fan_in + fan_out)) ** 0.5)
    elif initializer == "xavier_uniform_":
        kernel = uniform(g, shape, (6.0 / (fan_in + fan_out)) ** 0.5)
    elif initializer == "default":
        kernel = uniform(g, shape, (1.0 / fan_in) ** 0.5)
    else:
        raise ValueError(f"unknown initializer {initializer!r}")
    return {"kernel": kernel, "bias": torch.zeros(c_out)}


def reflect_conv(params: dict, x: torch.Tensor, *,
                 relu: bool = True) -> torch.Tensor:
    """1-pixel reflect pad -> 3x3 conv + bias -> optional ReLU."""
    xc = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    w = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)   # HWIO -> OIHW
    y = F.conv2d(xc, w, params["bias"].to(x.dtype))
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an NHWC tensor."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


# What ``_derived`` built: weight tensor -> {key: (version, tensor)}. The
# services of several k share one params tree from their own threads.
_DERIVED: WeakIdKeyDictionary = WeakIdKeyDictionary()
_DERIVED_LOCK = threading.Lock()


def _derived(t: torch.Tensor, key, build: Callable[[], torch.Tensor]
             ) -> torch.Tensor:
    """build(), a function of the weight tensor t alone, kept for as long as
    t lives and is not changed in place. Built afresh, never kept, while t
    takes part in autograd. A kept tensor is built outside inference mode,
    so that a training step (a frozen decoder's weights among its inputs)
    can use what a served call kept."""
    if t.requires_grad and torch.is_grad_enabled():
        return build()
    version = 0 if t.is_inference() else t._version
    with _DERIVED_LOCK:
        per_t = _DERIVED.setdefault(t, {})
        hit = per_t.get(key)
        if hit is None or hit[0] != version:
            with torch.inference_mode(False):
                hit = per_t[key] = (version, build())
        return hit[1]


def _bias(params: dict, n: int, dtype: torch.dtype) -> torch.Tensor:
    """The conv's bias repeated over n phase groups, in dtype."""
    b = params["bias"]
    return _derived(b, ("bias", n, dtype), lambda: b.repeat(n).to(dtype))


# ---------------------------------------------------------------------------
# Single phase level (L1)
# ---------------------------------------------------------------------------

def _phase_kernel(w: torch.Tensor) -> torch.Tensor:
    """A (3, 3, C, C') kernel applied to a nearest-2x-upsampled map, as four
    phase-dependent 2x2 kernels on the coarse grid: fine output (2i+a, 2j+b)
    reads coarse rows {W0 | W1+W2} for a=0 and {W0+W1 | W2} for a=1, the
    same along x. Returns (2, 2, C, 4 C'), phase p = 2a+b per C' block."""
    ry = [[w[0], w[1] + w[2]], [w[0] + w[1], w[2]]]
    phases = []
    for a in range(2):
        for b in range(2):
            taps = []
            for dy in range(2):
                row = ry[a][dy]                      # (3, C, C') along kx
                rx = [[row[0], row[1] + row[2]], [row[0] + row[1], row[2]]]
                taps.append(torch.stack(rx[b]))      # (2, C, C')
            phases.append(torch.stack(taps))         # (2, 2, C, C')
    return torch.cat(phases, -1)


def phase_interleave(p: torch.Tensor) -> torch.Tensor:
    """Phase tensor (B, H, W, 4 C), channel order (2a+b) C -> fine grid
    (B, 2H, 2W, C)."""
    b, h, w, c4 = p.shape
    c = c4 // 4
    x = p.reshape(b, h, w, 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)


# For output phase a' and coarse window row dy of an edge-padded phase
# input: the (input phase, original kernel tap) pairs that contribute.
_PHASE_TAPS = {
    (0, 0): [(1, 0)],
    (0, 1): [(0, 1), (1, 2)],
    (1, 0): [(0, 0), (1, 1)],
    (1, 1): [(0, 2)],
}


def _phase_space_kernel(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, C') fine-grid kernel -> (2, 2, 4C, 4C') phase-space kernel:
    output phase (a', b') at coarse (i, j) reads fine (2i+a'+d, 2j+b'+e),
    i.e. coarse i+(a'+d)//2, phase (a'+d)%2, a 2x2 window over the
    edge-padded phase tensor (fine reflect pad == coarse edge pad on the
    phases it touches)."""
    _, _, c, c_out = w.shape
    k = torch.zeros((2, 2, 4 * c, 4 * c_out), dtype=w.dtype, device=w.device)
    for ap in range(2):
        for bp in range(2):
            out_sl = slice((2 * ap + bp) * c_out, (2 * ap + bp + 1) * c_out)
            for dy in range(2):
                for dx in range(2):
                    for pa, ty in _PHASE_TAPS[(ap, dy)]:
                        for pb, tx in _PHASE_TAPS[(bp, dx)]:
                            in_sl = slice((2 * pa + pb) * c,
                                          (2 * pa + pb + 1) * c)
                            k[dy, dx, in_sl, out_sl] += w[ty, tx]
    return k


_L1_OFFSETS = ((0, 0), (0, 1), (1, 0), (1, 1))
# The upsample kernel is dense over its one input chunk.
_UPSAMPLE_TABLE = pc.GroupTable(_L1_OFFSETS, (0b1111,) * 4, 1)


@functools.lru_cache(maxsize=None)
def _phase_space_table() -> pc.GroupTable:
    """The stencil table of ``_phase_space_kernel``: output group 2a'+b'
    reads at offset (a', b'); tap (dy, dx) holds the input phases
    _PHASE_TAPS gives (9 of 16 blocks per group)."""
    blocks = []
    for ap in range(2):
        for bp in range(2):
            mask = 0
            for dy in range(2):
                for dx in range(2):
                    for pa, _ in _PHASE_TAPS[(ap, dy)]:
                        for pb, _ in _PHASE_TAPS[(bp, dx)]:
                            mask |= 1 << ((2 * dy + dx) * 4 + 2 * pa + pb)
            blocks.append(mask)
    return pc.GroupTable(_L1_OFFSETS, tuple(blocks), 4)


@functools.lru_cache(maxsize=None)
def _edge_index(n: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):   # cached: usable under autograd too
        return torch.arange(-1, n + 1, device=device).clamp(0, n - 1)


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """Replicate one row and column on each side of an NHWC tensor."""
    _, h, w, _ = x.shape
    return (x.index_select(1, _edge_index(h, x.device))
            .index_select(2, _edge_index(w, x.device)))


def _conv_valid(pp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """VALID conv of NHWC pp with an HWIO kernel in pp's type, no bias."""
    y = F.conv2d(pp.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def _align(big: torch.Tensor, c_out: int, use_pallas: bool) -> torch.Tensor:
    """big (B, H+1, W+1, 4C') -> (B, H, W, 4C'), group 2a+b at offset
    (a, b): K7 under use_pallas for C' % 32 == 0, the slices otherwise."""
    if use_pallas and c_out % 32 == 0:
        return pc.phase_align(big, c_out)
    return pc.phase_align_plain(big, c_out)


def _stencil_ok(cin: int, c_out: int, stencil: bool,
                use_pallas: bool) -> bool:
    """The JAX package's gate for the stencil kernels: Cin % 128 == 0 and
    C' % 32 == 0, with both switches on."""
    return stencil and use_pallas and cin % 128 == 0 and c_out % 32 == 0


def _phase_conv(params: dict, pp: torch.Tensor, pk: torch.Tensor,
                table: pc.GroupTable, *, relu: bool, use_pallas: bool,
                stencil: bool) -> torch.Tensor:
    """The L1 phase tensor (B, H, W, 4C') of a composed 2x2 kernel over the
    edge-padded pp: K5, or the conv route (conv, bias and ReLU in the
    working type, then the align)."""
    c_out = pk.shape[-1] // 4
    if _stencil_ok(pp.shape[-1], c_out, stencil, use_pallas):
        return pc.stencil_phase_conv(pp, pk, _bias(params, 4, torch.float32),
                                     table, relu)
    big = _conv_valid(pp, pk) + _bias(params, 4, pp.dtype)
    if relu:
        big = torch.relu(big)
    return _align(big, c_out, use_pallas)


def phase_conv3x3(params: dict, p: torch.Tensor, *, relu: bool = True,
                  interleave: bool = False, use_pallas: bool = False,
                  stencil: bool = False) -> torch.Tensor:
    """Fine-grid reflect-pad 3x3 conv on an L1 phase tensor (B, H, W, 4C),
    exact, without building the fine grid. Returns (B, H, W, 4C'), or the
    fine grid (B, 2H, 2W, C') with ``interleave``."""
    w = params["kernel"]
    pk = _derived(w, ("l1", p.dtype),
                  lambda: _phase_space_kernel(w.float()).to(p.dtype))
    out = _phase_conv(params, _edge_pad(p), pk, _phase_space_table(),
                      relu=relu, use_pallas=use_pallas, stencil=stencil)
    return phase_interleave(out) if interleave else out


def upsample_conv_fused(params: dict, x: torch.Tensor, *, relu: bool = True,
                        keep_phase: bool = False, use_pallas: bool = False,
                        stencil: bool = False) -> torch.Tensor:
    """upsample_nearest(2) -> 1px reflect pad -> 3x3 conv [-> ReLU] as one
    2x2 conv on the coarse grid (reflect pad of the upsampled map ==
    replicate pad of the coarse one). Returns the L1 phase tensor with
    ``keep_phase``, else the fine grid."""
    w = params["kernel"]
    pk = _derived(w, ("up", x.dtype),
                  lambda: _phase_kernel(w.float()).to(x.dtype))
    out = _phase_conv(params, _edge_pad(x), pk, _UPSAMPLE_TABLE,
                      relu=relu, use_pallas=use_pallas, stencil=stencil)
    return out if keep_phase else phase_interleave(out)


# ---------------------------------------------------------------------------
# Double phase level (L2): the last upsample and the convs after it run at
# the pre-upsample grid with 16x the channels.
# ---------------------------------------------------------------------------

def _phase2_axis_slots(a: int, up: bool):
    """Tap structure along one axis for output L2 phase a (fine row 4i+a):
    (base, slots), slots mapping (dy in {0, 1}, input phase) -> original
    tap indices; output (i, a) reads padded rows i + base + dy. up: the
    input is the L1 phase tensor of the pre-upsample grid (fine tap
    t = 4i+a+d is half-grid row 2i+(a+d)//2); else L2 of the fine grid
    (coarse (a+d)//4, phase (a+d)%4)."""
    slots: dict = {}
    deltas = []
    for d in (-1, 0, 1):
        t = a + d
        if up:
            u = t // 2
            delta, ph = u // 2, u % 2
        else:
            delta, ph = t // 4, t % 4
        deltas.append(delta)
        slots.setdefault((delta, ph), []).append(1 + d)
    base = min(deltas)
    assert max(deltas) - base <= 1, (a, up, deltas)
    return base + 1, {(delta - base, ph): taps
                      for (delta, ph), taps in slots.items()}


def _phase2_kernel(w: torch.Tensor, up: bool):
    """(3, 3, C, C') fine kernel -> the L2 2x2-tap kernel (2, 2, nin^2 C,
    16 C'), nin = 2 (up) or 4, and the per-phase align bases (the same for
    rows and columns)."""
    c, c_out = w.shape[2], w.shape[3]
    nin = 2 if up else 4
    k = torch.zeros((2, 2, nin * nin * c, 16 * c_out), dtype=w.dtype,
                    device=w.device)
    ax = [_phase2_axis_slots(a, up) for a in range(4)]
    for a in range(4):
        for b in range(4):
            out_sl = slice((4 * a + b) * c_out, (4 * a + b + 1) * c_out)
            for (dy, pr), taps_r in ax[a][1].items():
                for (dx, pc_), taps_c in ax[b][1].items():
                    in_sl = slice((nin * pr + pc_) * c,
                                  (nin * pr + pc_ + 1) * c)
                    acc = None
                    for ty in taps_r:
                        for tx in taps_c:
                            t = w[ty, tx]
                            acc = t if acc is None else acc + t
                    k[dy, dx, in_sl, out_sl] += acc
    return k, [ax[a][0] for a in range(4)]


def _phase2_bases(up: bool) -> Tuple[int, ...]:
    """The per-phase align bases of ``_phase2_kernel``."""
    return tuple(_phase2_axis_slots(a, up)[0] for a in range(4))


@functools.lru_cache(maxsize=None)
def _phase2_table(up: bool) -> pc.GroupTable:
    """The stencil table of ``_phase2_kernel``: group 4a+b reads at
    (bases[a], bases[b]); along each axis an output phase reads two (tap
    row, input phase) slots, so each group has 4 nonzero (tap, input
    phase) blocks, which fall in 36 of the 64 (group, tap) pairs."""
    nin = 2 if up else 4
    ax = [_phase2_axis_slots(a, up) for a in range(4)]
    offsets, blocks = [], []
    for a in range(4):
        for b in range(4):
            offsets.append((ax[a][0], ax[b][0]))
            mask = 0
            for dy, pr in ax[a][1]:
                for dx, pc_ in ax[b][1]:
                    mask |= 1 << ((2 * dy + dx) * nin * nin + nin * pr + pc_)
            blocks.append(mask)
    return pc.GroupTable(tuple(offsets), tuple(blocks), nin * nin)


def _phase2_pad_maps(n: int, nph: int, up: bool):
    """Per pad slot phase g: (source index along the n-long axis, source
    phase), for the leading and the trailing border."""
    if up:
        return [(0, 0)] * nph, [(n - 1, 1)] * nph
    top = [((4 - g) // 4, (4 - g) % 4) for g in range(4)]
    bot = [(n - 1 - (1 if g == 3 else 0), (2 - g) % 4) for g in range(4)]
    return top, bot


def _phase2_pad(x: torch.Tensor, nph: int, c: int, up: bool) -> torch.Tensor:
    """One coarse row and column of phase padding on each side of a phase
    tensor (B, H, W, nph^2 C), equal to the fine grid's reflect padding;
    each border an index gather of one or two source rows or columns
    (ops/phase_conv.pad_border), rows first."""
    _, h, w, _ = x.shape

    def rows(m):
        return pc.pad_border(lambda s: x[:, s], m, nph, c, True)[:, None]

    def cols(m):
        return pc.pad_border(lambda s: x[:, :, s], m, nph, c, False)[:, :, None]

    top, bot = _phase2_pad_maps(h, nph, up)
    x = torch.cat([rows(top), x, rows(bot)], 1)
    left, right = _phase2_pad_maps(w, nph, up)
    return torch.cat([cols(left), x, cols(right)], 2)


def _phase2_pad_ref(x: torch.Tensor, nph: int, c: int,
                    up: bool) -> torch.Tensor:
    """The same padding built the plain way, by taking each slot's source
    row and phase and stacking: up (L1 phase of a pre-upsample grid) pads
    with half-grid rows {-2, -1} -> (0, phase 0) and {2H, 2H+1} -> (H-1,
    phase 1); else (L2 of the fine grid) slot g before row 0 is fine row
    4-g -> (coarse (4-g)//4, phase (4-g)%4), after row H-1 fine 4H-2-g ->
    (coarse H-1-(g==3), phase (2-g)%4)."""
    b, h, w, _ = x.shape
    x6 = x.reshape(b, h, w, nph, nph, c)

    def pad_axis(x6, axis):
        n = x6.shape[axis]
        top, bot = _phase2_pad_maps(n, nph, up)
        ph_axis = axis + 2                      # this axis' phase dim

        def border(maps):
            return torch.stack(
                [x6.select(axis, s).select(ph_axis - 1, p)
                 for s, p in maps], ph_axis - 1).unsqueeze(axis)

        return torch.cat([border(top), x6, border(bot)], axis)

    x6 = pad_axis(pad_axis(x6, 1), 2)
    return x6.reshape(b, h + 2, w + 2, nph * nph * c)


def _phase2_pad_rows(y: torch.Tensor, nph: int, c: int) -> torch.Tensor:
    """Add the two pad rows to a column-padded L2 tensor (B, H, W+2, C16)
    -> (B, H+2, W+2, C16): row slots relabel the row phase, column slots
    the column phase, so the two commute and the corners equal
    ``_phase2_pad``'s rows-then-columns order."""
    top, bot = _phase2_pad_maps(y.shape[1], nph, False)
    rows = [pc.pad_border(lambda s: y[:, s], m, nph, c, True)[:, None]
            for m in (top, bot)]
    return torch.cat([rows[0], y, rows[1]], 1)


def _align2(big: torch.Tensor, h: int, w: int, c_out: int,
            bases) -> torch.Tensor:
    """big (B, H+1, W+1, 16 C') -> (B, H, W, 16 C'), group (a, b) at
    (bases[a], bases[b])."""
    return torch.cat([big[:, bases[a]:bases[a] + h, bases[b]:bases[b] + w,
                          (4 * a + b) * c_out:(4 * a + b + 1) * c_out]
                      for a in range(4) for b in range(4)], -1)


def phase_interleave2(p: torch.Tensor) -> torch.Tensor:
    """L2 phase tensor (B, H, W, 16 C), group order (4a+b) C -> fine grid
    (B, 4H, 4W, C)."""
    b, h, w, c16 = p.shape
    c = c16 // 16
    x = p.reshape(b, h, w, 4, 4, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, 4 * h, 4 * w, c)


# The JAX package's switch for its first RGB-tail kernel (K12's ``rgb``
# entry), off there since a TPU measurement; the same constant and route
# here (``phase2_conv3x3``).
_RGB_KERNEL_ON = False


def _slots128(k2: torch.Tensor, c_out: int) -> torch.Tensor:
    """An L2 kernel (..., 16 C') with its 16 groups' C' <= 8 lanes moved to
    8-lane slots, zeros elsewhere: (..., 128)."""
    out = k2.new_zeros((*k2.shape[:-1], 16, 8))
    out[..., :c_out] = k2.reshape(*k2.shape[:-1], 16, c_out)
    return out.reshape(*k2.shape[:-1], 128)


def l2_to_l1(p: torch.Tensor) -> torch.Tensor:
    """L2 phase tensor (B, H, W, 16 C) -> the L1 phase tensor of the same
    fine grid (B, 2H, 2W, 4 C): fine row 4i + 2a1 + a0 = 2(2i+a1) + a0."""
    b, h, w, c16 = p.shape
    c = c16 // 16
    x8 = p.reshape(b, h, w, 2, 2, 2, 2, c)      # (a1, a0, b1, b0)
    x8 = x8.permute(0, 1, 3, 2, 5, 4, 6, 7)     # b, h, a1, w, b1, a0, b0, c
    return x8.reshape(b, 2 * h, 2 * w, 4 * c)


def phase2_conv3x3(params: dict, p: torch.Tensor, *, up: bool,
                   relu: bool = True, interleave: bool = False,
                   use_pallas: bool = False, k128: bool = False,
                   in_padded: bool = False,
                   emit_padded: bool = False) -> torch.Tensor:
    """Fine-grid [upsample 2x ->] reflect pad -> 3x3 conv in double phase
    space, exact. p: the L1 phase tensor (B, H, W, 4C) when ``up``, else
    L2 (B, H, W, 16C). Returns L2 (B, H, W, 16C'), or the fine grid
    (B, 4H, 4W, C') with ``interleave``.

    in_padded: p already carries its pad border (an earlier conv emitted
    it). emit_padded: return the output with its own pad border,
    (B, H+2, W+2, 16C'): the stencil kernel writes the columns (K6 padcols)
    and ``_phase2_pad_rows`` the rows; the conv route pads the finished
    output.

    The RGB conv (``interleave``, C' <= 8) runs the RGB-tail kernel K12 as
    the JAX package routes it: its ``rgb`` entry under ``use_pallas`` and
    ``_RGB_KERNEL_ON``; else, with ``k128`` (``rgb_tail="l2k128"``, whether
    or not ``use_pallas``), its ``rgb128`` entry on the kernel and bias
    moved to 8-lane slots, the fine grid then interleaved and sliced here."""
    assert not (emit_padded and interleave)
    b, h, w, _ = p.shape
    if in_padded:
        h, w = h - 2, w - 2
    wk = params["kernel"]
    c_in, c_out = wk.shape[2], wk.shape[3]
    k2 = _derived(wk, ("l2up" if up else "l2", p.dtype),
                  lambda: _phase2_kernel(wk.float(), up)[0].to(p.dtype))
    pp = p if in_padded else _phase2_pad(p, 2 if up else 4, c_in, up)
    if (use_pallas and not up and interleave and c_out < 32
            and pp.shape[-1] % 128 == 0 and _RGB_KERNEL_ON):
        return pc.stencil_phase2_rgb(pp, k2, _bias(params, 16, torch.float32),
                                     _phase2_bases(False), relu,
                                     table=_phase2_table(False))
    if (k128 and not up and interleave and c_out <= 8
            and pp.shape[-1] % 128 == 0):
        bias = params["bias"]
        pk128 = _derived(wk, ("l2k128", p.dtype),
                         lambda: _slots128(k2, c_out))
        # the JAX route rounds the slot bias to the working type
        b128 = _derived(bias, ("bias128", p.dtype), lambda: _slots128(
            bias.float().repeat(16), c_out).to(p.dtype).float())
        out = pc.stencil_phase2_rgb128(pp, pk128, b128, _phase2_bases(False),
                                       relu, table=_phase2_table(False))
        fine = (out.reshape(b, h, w, 4, 4, 8).permute(0, 1, 3, 2, 4, 5)
                .reshape(b, 4 * h, 4 * w, 8))
        return fine[..., :c_out]
    if use_pallas and c_out % 32 == 0 and pp.shape[-1] % 128 == 0:
        table = _phase2_table(up)
        bias16 = _bias(params, 16, torch.float32)
        if emit_padded:
            out = pc.stencil_phase2_conv_padcols(
                pp, k2, bias16, table, _phase2_pad_maps(w, 4, False), relu)
            return _phase2_pad_rows(out, 4, c_out)
        out = pc.stencil_phase2_conv(pp, k2, bias16, table, relu)
    else:
        big = _conv_valid(pp, k2) + _bias(params, 16, p.dtype)
        if relu:
            big = torch.relu(big)
        out = _align2(big, h, w, c_out, _phase2_bases(up))
    if emit_padded:
        return _phase2_pad(out, 4, c_out, False)
    return phase_interleave2(out) if interleave else out
