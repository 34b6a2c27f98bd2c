"""K11's plan and launch arithmetic (ops/block_pair.py, csrc/block_pair.cu)
on the CPU, and its tensor-core design replayed in torch.

* The pair plan is K1's plan for the rows entry (ops/window_block.py:
  block_plan) at swin_B's two stage widths and at swin_S's stage 2 (C =
  192, 6 heads), so each stage takes K1's form; its shared memory is the
  tensor-core layout's (tc_layout); f32 keeps the scalar body.
* The tickets (block_pair.cu:work_of, mirrored here) cover every window of
  both blocks once, and every block-0 window a block-1 ticket waits on
  was handed out before it: the no-deadlock argument's premise.
* The replay runs the tickets in order, each window through K1's
  tensor-core replay (tests/test_torch_window_tc_plan.py's ``_block_tc``):
  block 0 writes y0 rounded to bf16 and marks the window ready; block 1
  checks that its (at most four) windows are ready, reads its shifted
  tokens of y0 and writes the output in the plain frame. The result must
  equal K1's tensor-core replay applied twice, and K11's plain version
  within the card's tolerance.
"""

import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu_torch.config import AttentionConfig
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    init_style_swin_block,
)
from mastermetastyletransfer_tpu_torch.ops import block_pair as bpr
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from mastermetastyletransfer_tpu_torch.ops import windows as twin
from tests.test_torch_window_tc_plan import _block_tc, _replay, _rounder
from tests.torch_threads import one_torch_thread  # noqa: F401


def _work_of(ticket, b, nwh, nww):
    """(block, image, window row, window column) of a ticket, as
    block_pair.cu's work_of: block 0's row 0 of every image, then for each
    row r >= 1 block 0's row r and block 1's row r - 1, then block 1's last
    row."""
    p = b * nww
    if ticket < p:
        blk, row, idx = 0, 0, ticket
    else:
        r, v = divmod(ticket - p, 2 * p)
        r += 1
        if r >= nwh:
            blk, row, idx = 1, nwh - 1, v
        elif v < p:
            blk, row, idx = 0, r, v
        else:
            blk, row, idx = 1, r - 1, v - p
    return blk, idx // nww, row, idx % nww


def _waits(row, col, nwh, nww, shift):
    """The block-0 windows (row, column) a block-1 ticket waits on."""
    r1 = (row + 1) % nwh if shift[0] else row
    c1 = (col + 1) % nww if shift[1] else col
    return {(row, col), (row, c1), (r1, col), (r1, c1)}


@pytest.mark.parametrize("c,heads,per_sm,smem", [(128, 4, 2, 113936),
                                                 (256, 8, 1, 224016),
                                                 (192, 6, 1, None)])
def test_pair_plan_is_k1s(c, heads, per_sm, smem):
    """At bf16 the pair plan is K1's rows-entry plan (two blocks of 8 warps
    an SM at stage 1, one of 16 at stage 2 and at swin_S's C = 192), its
    shared memory the tensor-core layout's; at f32 the scalar body."""
    plan = bpr.pair_plan(49, c, heads, 4 * c, torch.bfloat16)
    assert plan == wb.block_plan("window_block_rows", 49, c, heads, 4 * c,
                                 torch.bfloat16)
    assert (plan.body, plan.blocks_per_sm) == ("tc", per_sm)
    want = wb.tc_layout(49, c, plan.kp, plan.stages, per_sm == 2)["total"]
    assert bpr.smem_bytes(plan, 49, c, heads, torch.bfloat16) == want
    assert want == plan.smem_bytes <= wb.SMEM_PER_SM // per_sm - 1024
    if smem is not None:
        assert want == smem
    assert bpr.pair_plan(49, c, heads, 4 * c, torch.float32).body == "scalar"


@pytest.mark.parametrize("b,hp,wp,shift", [(2, 14, 14, (3, 3)),
                                           (1, 21, 35, (3, 3)),
                                           (16, 133, 133, (3, 3)),
                                           (2, 21, 14, (3, 0)),
                                           (1, 7, 14, (0, 3))])
def test_tickets_cover_every_window_and_wait_only_on_earlier_ones(
        b, hp, wp, shift):
    nwh, nww = hp // 7, wp // 7
    issued = {}
    for ticket in range(2 * b * nwh * nww):
        blk, img, row, col = _work_of(ticket, b, nwh, nww)
        assert (blk, img, row, col) not in issued
        issued[(blk, img, row, col)] = ticket
        if blk == 1:
            for r, q in _waits(row, col, nwh, nww, shift):
                assert issued[(0, img, r, q)] < ticket
    assert len(issued) == 2 * b * nwh * nww


def _pair_case(c, heads, hp, wp, vh, vw, dtype, seed=0):
    """Two blocks' params (non-trivial norms) as block weights, a (2, hp,
    wp, c) image of which vh x vw tokens are valid (the pad tokens hold
    garbage), and K11's keywords at shift 3."""
    g = torch.Generator().manual_seed(seed + c + hp)
    acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                           shift_size=(3, 3))
    ws = []
    for _ in range(2):
        p = init_style_swin_block(g, acfg, use_norm=True, exclude_mlp=False,
                                  mlp_ratio=4.0)
        for name in ("norm1", "norm2"):
            p[name] = {"scale": 1 + 0.3 * torch.randn(c, generator=g),
                       "bias": 0.3 * torch.randn(c, generator=g)}
        ws.append(wb.block_weights(p, (7, 7), dtype, True))
    x = torch.randn((2, hp, wp, c), generator=g)
    x[:, vh:] = 5.0
    x[:, :, vw:] = -5.0
    sh, sw = twin.effective_shift(hp, wp, (7, 7), (3, 3))
    kw = dict(heads=heads, window=(7, 7), shift=(sh, sw),
              mask1=torch.from_numpy(twin.shift_attention_mask(
                  hp, wp, 7, 7, sh, sw)),
              padmask0=torch.from_numpy(twin.valid_token_mask(
                  vh, vw, hp, wp, 7, 7, 0, 0)),
              padmask1=torch.from_numpy(twin.valid_token_mask(
                  vh, vw, hp, wp, 7, 7, sh, sw)))
    return ws, x.to(dtype), kw


def _replay_pair(x, w0, w1, *, heads, window, shift, mask1, padmask0,
                 padmask1):
    """K11 as its tickets run on the tensor-core body, one window at a
    time in ticket order."""
    b, hp, wp, c = x.shape
    (wh, ww), (sh, sw) = window, shift
    n, nwh, nww = wh * ww, hp // wh, wp // ww
    plan = bpr.pair_plan(n, c, heads, w0.w1.shape[1], torch.bfloat16)
    assert plan.body == "tc"
    rnd = _rounder(x.dtype)
    y0 = torch.full_like(x, float("nan"))
    out = torch.full_like(x, float("nan"))
    ready = set()
    for ticket in range(2 * b * nwh * nww):
        blk, img, row, col = _work_of(ticket, b, nwh, nww)
        wi = row * nww + col
        dr, dc = (sh, sw) if blk else (0, 0)
        rr = torch.tensor([(row * wh + i + dr) % hp for i in range(wh)
                           for _ in range(ww)])
        cc = torch.tensor([(col * ww + j + dc) % wp for _ in range(wh)
                           for j in range(ww)])
        if blk == 0:
            y = _block_tc(x[img, rr, cc].float()[None], w0, plan,
                          heads=heads, mask=None,
                          padmask=padmask0[wi:wi + 1], rnd=rnd)
            y0[img, rr, cc] = y[0].to(x.dtype)   # y0 rounded to bf16
            ready.add((img, row, col))
            continue
        assert {(img, r, q) for r, q in _waits(row, col, nwh, nww,
                                               (sh, sw))} <= ready
        src = y0[img, rr, cc]
        assert not src.isnan().any()    # every token it reads is written
        y = _block_tc(src.float()[None], w1, plan, heads=heads,
                      mask=mask1[wi:wi + 1], padmask=padmask1[wi:wi + 1],
                      rnd=rnd)
        out[img, rr, cc] = y[0].to(x.dtype)
    assert not out.isnan().any()    # every token written once
    return out


@pytest.mark.parametrize("c,heads,grid", [(32, 2, (14, 14, 12, 12)),
                                          (64, 4, (14, 21, 10, 19))])
def test_pair_replay_is_k1_replay_twice(c, heads, grid):
    """At bf16, K11's ticket-by-ticket replay (block 1 reading y0 rounded
    to bf16, its last window row and column reading row and column 0)
    equals K1's tensor-core replay applied twice, and agrees with K11's
    plain version within the card's tolerance."""
    (w0, w1), x, kw = _pair_case(c, heads, *grid, torch.bfloat16)
    got = _replay_pair(x, w0, w1, **kw)
    y0 = _replay(x, w0, heads=heads, window=(7, 7), shift=(0, 0),
                 mask=None, padmask=kw["padmask0"])
    want = _replay(y0, w1, heads=heads, window=(7, 7), shift=kw["shift"],
                   mask=kw["mask1"], padmask=kw["padmask1"])
    assert torch.equal(got, want)
    ref = bpr.window_block_pair_rows_plain(x, w0, w1, **kw).float()
    ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
    tol = (2 * torch.where(ref == 0, 0.0, ulp)
           + 2.0 ** -6 * (ref - x.float()).abs().max())
    assert ((got.float() - ref).abs() <= tol).all()
    assert np.isfinite(got.float().numpy()).all()
