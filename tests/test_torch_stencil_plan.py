"""The tensor-core stencil body's tiling (ops/phase_conv.py:stencil_plan,
tile_plan_struct; csrc/stencil_tc.cuh) replayed in torch on the CPU.

The replay runs the kernel's algorithm from the plan and from the plan's C
struct exactly as the kernel reads them: blocks by channel slice, tile and
image (a slice's tiles side by side); for each used chunk and each stage_k-deep slice of it, the tile's
halo window (zero past the input's edge) and the weight rows of each slot
(for K12 rgb, the raw rows of the chunk's taps); group by group, each of
its taps' A rows (the halo shifted by the group's read offset plus the
tap) against the slot the kernel finds for (group, tap); every group's sum
in f32; the bias, ReLU and one rounding per block; K6's pad columns
written by the block that writes their source column (each slot a copy of
the rounded value); the fine interleave for K12 rgb. It must agree with
the plain versions (the kernels' yardstick) within 1e-5 at f32, for the
five tables the wrappers take -- dense (K12's, nchunks 1), upsample, L1
phase, L2 (K6's, 16 groups of 32, as "stencil" and as K6's own "phase2"
plan, with and without pad columns) and L2-RGB -- at B of 1 and 2 and odd
H, W that cross the 8 x 16 tile's edges.
"""

import pytest
import torch

from mastermetastyletransfer_tpu_torch.ops import conv as tconv
from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _replay(pp, pk, bias, table, kind, relu, plan_dtype, colmaps=None):
    """The kernel's computation, block by block, from the plan it gets;
    ``colmaps`` (K6 padcols) the (left, right) pad-slot maps of the
    columns."""
    b, hp, wp, cin = pp.shape
    h, w = hp - 2, wp - 2
    groups = len(table.offsets)
    cg = pk.shape[-1] // groups
    plan = pc.stencil_plan(table, kind, b, h, w, cin, cg, plan_dtype)
    st = pc.tile_plan_struct(plan)
    th, tw = plan.tile
    bn, sk = plan.bn, plan.stage_k
    nsplit = -(-cg // bn)
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    assert plan.blocks == b * tiles_y * tiles_x * nsplit
    chunk = cin // table.nchunks
    assert chunk % sk == 0
    ppf, pkf = pp.float(), pk.float()
    pad = int(colmaps is not None)
    out = torch.full((b, h, w + 2 * pad, groups * cg), float("nan"),
                     dtype=pp.dtype)
    # The blocks by channel slice, decoded from the block index as the
    # kernel decodes it; a slice's tiles run side by side, each tile's
    # arithmetic its block's.
    slices = {}
    for blk in range(plan.blocks):
        n0 = (blk % nsplit) * bn
        t = blk // nsplit
        j0 = (t % tiles_x) * tw
        t //= tiles_x
        i0, bi = (t % tiles_y) * th, t // tiles_y
        slices.setdefault(n0, []).append((bi, i0, j0))
    for n0, origins in slices.items():
        halo = torch.zeros((len(origins), th + 2, tw + 2, cin))
        for k, (bi, i0, j0) in enumerate(origins):
            src = ppf[bi, i0:i0 + th + 2, j0:j0 + tw + 2]
            halo[k, :src.shape[0], :src.shape[1]] = src
        acc = torch.zeros((groups, len(origins), th, tw, bn))
        lanes = min(bn, cg - n0)
        for u in range(st.nused):
            c = st.used[u]
            assert st.npairs[c] <= plan.max_pairs
            # the kernel's inversion of the slot list: each group's taps,
            # the slot of (group, tap), the taps of any group
            slotof, tapmask, ctaps = {}, [0] * groups, 0
            for slot in range(st.npairs[c]):
                g, tap = st.pairs[c][slot] & 15, st.pairs[c][slot] >> 4
                slotof[g, tap] = slot
                tapmask[g] |= 1 << tap
                ctaps |= 1 << tap
            for k0 in range(c * chunk, (c + 1) * chunk, sk):
                ks = slice(k0, k0 + sk)
                if cg < bn:
                    # K12 rgb: the raw rows of the chunk's taps, in order
                    raw = [pkf[t // 2, t % 2, ks] for t in range(4)
                           if (ctaps >> t) & 1]
                else:
                    slots = []
                    for pr in st.pairs[c][:st.npairs[c]]:
                        g, t = pr & 15, pr >> 4
                        slots.append(pkf[t // 2, t % 2, ks,
                                         g * cg + n0:g * cg + n0 + bn])
                for g in range(groups):
                    oy, ox = table.offsets[g]
                    for tap in range(4):
                        if not (tapmask[g] >> tap) & 1:
                            continue
                        if cg < bn:
                            ti = bin(ctaps & ((1 << tap) - 1)).count("1")
                            rows = torch.zeros((sk, bn))
                            rows[:, :cg] = raw[ti][:, g * cg:(g + 1) * cg]
                        else:
                            rows = slots[slotof[g, tap]]
                        sy, sx = oy + tap // 2, ox + tap % 2
                        a = halo[:, sy:sy + th, sx:sx + tw, ks]
                        acc[g] += a @ rows
        for k, (bi, i0, j0) in enumerate(origins):
            hv, wv = min(th, h - i0), min(tw, w - j0)
            for g in range(groups):
                cols = slice(g * cg + n0, g * cg + n0 + lanes)
                y = acc[g, k, :hv, :wv, :lanes] + bias[cols].float()
                if relu:
                    y = torch.relu(y)
                y = y.to(pp.dtype)
                out[bi, i0:i0 + hv, j0 + pad:j0 + pad + wv, cols] = y
                if not pad:
                    continue
                # the writer of a source column writes the pad slots it
                # feeds
                for col, maps in ((0, colmaps[0]), (w + 1, colmaps[1])):
                    for slot, (src, ph) in enumerate(maps):
                        if ph == g % 4 and j0 <= src < j0 + wv:
                            dst = (4 * (g // 4) + slot) * cg + n0
                            out[bi, i0:i0 + hv, col, dst:dst + lanes] = \
                                y[:, src - j0]
    assert not out.isnan().any()    # every output written
    return pc._interleave(out) if kind == "rgb" else out


def _block_sparse(pk, table):
    """pk with the table's zero (tap, chunk) blocks of each group zeroed, as
    the composed phase kernels have them (the kernel never reads them)."""
    cin, n = pk.shape[2:]
    groups, nchunks = len(table.offsets), table.nchunks
    chunk, cg = cin // nchunks, n // groups
    pk = pk.clone()
    for g, mask in enumerate(table.blocks):
        for t in range(4):
            for c in range(nchunks):
                if not (mask >> (t * nchunks + c)) & 1:
                    pk[t // 2, t % 2, c * chunk:(c + 1) * chunk,
                       g * cg:(g + 1) * cg] = 0
    return pk


def _table(name):
    bases = tconv._phase2_bases(False)
    return {"dense": pc.rgb_table(bases),
            "upsample": tconv._UPSAMPLE_TABLE,
            "l1": tconv._phase_space_table(),
            "l2": tconv._phase2_table(True),
            "l2rgb": tconv._phase2_table(False)}[name]


# (kind, table, Cin, C' per group)
CASES = [("phase2", "l2", 128, 32),
         ("phase2", "l2", 64, 64),
         ("stencil", "upsample", 32, 64),
         ("stencil", "upsample", 48, 96),
         ("stencil", "l1", 64, 32),
         ("stencil", "l1", 128, 128),
         ("stencil", "l2", 64, 32),
         ("rgb", "l2rgb", 256, 3),
         ("rgb128", "l2rgb", 256, 8),
         ("rgb", "dense", 64, 3),
         ("rgb128", "dense", 64, 8)]


@pytest.mark.parametrize("bhw", [(1, 7, 13), (2, 9, 17), (1, 1, 1)])
@pytest.mark.parametrize("kind,name,cin,cg", CASES)
def test_plan_replay_matches_plain(kind, name, cin, cg, bhw):
    table = _table(name)
    groups = len(table.offsets)
    b, h, w = bhw
    g = torch.Generator().manual_seed(cin + cg + h)
    pp = torch.randn((b, h + 2, w + 2, cin), generator=g)
    pk = _block_sparse(torch.randn((2, 2, cin, groups * cg), generator=g)
                       * cin ** -0.5, table)
    bias = torch.randn(groups * cg, generator=g) * 0.1
    relu = kind in ("stencil", "phase2")
    bases = tconv._phase2_bases(False)
    if kind == "rgb":
        ref = pc.stencil_phase2_rgb_plain(pp, pk, bias, bases, relu)
    elif kind == "rgb128":
        ref = pc.stencil_phase2_rgb128_plain(pp, pk, bias, bases, relu)
    else:
        ref = pc._stencil_plain(pp, pk, bias, table.offsets, relu)
    # K5 runs its plan at bf16 only; K6 and K12 at both types, whose plans
    # differ.
    dtypes = ((torch.bfloat16,) if kind == "stencil"
              else (torch.bfloat16, torch.float32))
    for plan_dtype in dtypes:
        got = _replay(pp, pk, bias, table, kind, relu, plan_dtype)
        assert got.shape == ref.shape
        err = (got - ref).abs().max().item()
        assert err <= TOL, (plan_dtype, err)


# (H, W) around the 8 x 16 tile at B = 1, and B = 2 at odd sizes; W >= 2
# for the pad columns.
PHASE2_SHAPES = [(1, 1, 2), (1, 7, 15), (1, 9, 17), (1, 1, 17), (1, 9, 2),
                 (2, 7, 13)]


@pytest.mark.parametrize("bhw", PHASE2_SHAPES)
def test_phase2_plan_replay_writes_the_pad_columns(bhw):
    """K6's padcols entry: the "phase2" plan's blocks, each writing its own
    interior and the pad slots whose source column it writes, against
    stencil_phase2_conv_padcols_plain within 1e-5 at f32; every pad slot
    is written (none left over) and equals its source exactly."""
    table = _table("l2")
    b, h, w = bhw
    g = torch.Generator().manual_seed(h * 31 + w)
    pp = torch.randn((b, h + 2, w + 2, 128), generator=g)
    pk = _block_sparse(torch.randn((2, 2, 128, 512), generator=g)
                       * 128 ** -0.5, table)
    bias = torch.randn(512, generator=g) * 0.1
    colmaps = tconv._phase2_pad_maps(w, 4, False)
    ref = pc.stencil_phase2_conv_padcols_plain(pp, pk, bias, table, colmaps)
    for plan_dtype in (torch.bfloat16, torch.float32):
        got = _replay(pp, pk, bias, table, "phase2", True, plan_dtype,
                      colmaps)
        assert got.shape == ref.shape == (b, h, w + 2, 512)
        assert (got - ref).abs().max().item() <= TOL
        if h >= 2:  # the pad rows' maps need two rows
            assert torch.equal(
                tconv._phase2_pad_rows(got, 4, 32),
                tconv._phase2_pad(got[:, :, 1:-1], 4, 32, False))


def test_plan_slots_are_the_tables_nonzero_blocks():
    """One slot per nonzero (tap, chunk) block of each group, by group and
    then tap, and no chunk listed that has none."""
    for name in ("dense", "upsample", "l1", "l2", "l2rgb"):
        table = _table(name)
        k12 = name in ("dense", "l2rgb")
        plan = pc.stencil_plan(table, "rgb128" if k12 else "stencil", 2, 64,
                               64, 512, 8 if k12 else 32, torch.bfloat16)
        for c, slots in enumerate(plan.pairs):
            assert slots == tuple(sorted(set(slots)))
            assert all((table.blocks[g] >> (t * table.nchunks + c)) & 1
                       for g, t in slots)
        nblocks = sum(bin(m).count("1") for m in table.blocks)
        assert sum(len(p) for p in plan.pairs) == nblocks
        assert plan.max_pairs == max(len(p) for p in plan.pairs)
        assert plan.used == tuple(c for c, p in enumerate(plan.pairs) if p)


def test_plan_fits_shared_memory_and_picks_the_deeper_stage():
    """Deeper stages (32 channels) where the ring fits, else 16: the K12
    dense table in 8-lane slots at f32 needs the shallower one."""
    l1, dense = tconv._phase_space_table(), _table("dense")
    p = pc.stencil_plan(l1, "stencil", 8, 64, 64, 512, 128, torch.bfloat16)
    assert (p.kernel, p.bn, p.stage_k, p.max_pairs) == (
        "stencil_tc64_phase", 64, 32, 9)
    assert p.blocks == 8 * 8 * 4 * 2
    p = pc.stencil_plan(tconv._UPSAMPLE_TABLE, "stencil", 8, 64, 64, 128,
                        128, torch.bfloat16)
    assert (p.stage_k, p.max_pairs) == (16, 16)
    for dtype, sk in ((torch.bfloat16, 32), (torch.float32, 16)):
        p = pc.stencil_plan(dense, "rgb128", 8, 128, 128, 512, 8, dtype)
        assert (p.stage_k, p.max_pairs) == (sk, 64)
        assert p.smem_bytes <= pc._SMEM_CAP


def test_plan_names_the_compiled_tables():
    """The decoder's tables run the body's compiled-in forms at bf16
    (csrc/stencil_tc.cuh kPatDense, kPhaseBits, kRgbBits): their per-chunk
    pair bits and read offsets are the constants the kernel holds; any
    other table, and K12 at f32, runs the general form."""
    def chunk_bits(table):
        return tuple(sum(1 << (4 * g + t) for g in range(len(table.offsets))
                         for t in range(4)
                         if (table.blocks[g] >> (t * table.nchunks + c)) & 1)
                     for c in range(table.nchunks))

    phase, rgb = tconv._phase_space_table(), _table("l2rgb")
    assert chunk_bits(phase) == pc._PHASE_BITS
    assert chunk_bits(rgb) == pc._RGB_BITS
    assert chunk_bits(tconv._UPSAMPLE_TABLE) == (0xffff,)
    assert chunk_bits(_table("dense")) == ((1 << 64) - 1,)
    assert phase.offsets == tconv._UPSAMPLE_TABLE.offsets \
        == pc._known_offsets(4)
    assert rgb.offsets == _table("dense").offsets == pc._known_offsets(16)
    assert chunk_bits(_table("l2")) == pc._L2UP_BITS
    assert _table("l2").offsets == pc._known_offsets(16)
    bf16 = torch.bfloat16
    for table, kind, cin, c_out, dtype, kernel in (
            (tconv._UPSAMPLE_TABLE, "stencil", 128, 128, bf16,
             "stencil_tc64_dense"),
            (tconv._UPSAMPLE_TABLE, "stencil", 128, 32, bf16,
             "stencil_tc32_dense"),
            (phase, "stencil", 512, 128, bf16, "stencil_tc64_phase"),
            (phase, "stencil", 512, 32, bf16, "stencil_tc32_phase"),
            (_table("l2"), "stencil", 128, 32, bf16, "stencil_tc32"),
            (_table("l2"), "phase2", 128, 32, bf16, "stencil2_tc16_l2up"),
            (_table("l2rgb"), "phase2", 512, 32, bf16, "stencil2_tc16"),
            (_table("l2"), "phase2", 128, 32, torch.float32, "stencil2_tc8"),
            (rgb, "rgb", 512, 3, bf16, "rgb_l2"),
            (rgb, "rgb128", 512, 8, bf16, "rgb128_l2"),
            (_table("dense"), "rgb", 512, 3, bf16, "rgb_dense"),
            (rgb, "rgb", 512, 3, torch.float32, "rgb"),
            (_table("dense"), "rgb128", 512, 8, torch.float32, "rgb128")):
        plan = pc.stencil_plan(table, kind, 8, 64, 64, cin, c_out, dtype)
        assert plan.kernel == kernel
        assert plan.kernel.endswith(pc.PATTERNS[plan.pattern])
