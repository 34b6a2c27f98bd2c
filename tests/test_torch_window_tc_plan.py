"""The tensor-core block body (csrc/window_tc.cuh) of K1 and K2 replayed in
torch on the CPU from its plan (ops/window_block.py:block_plan,
tile_schedule), and the block weights' cache.

The replay runs the kernel's algorithm on every window as its block reads
the plan (the windows side by side): the tokens at the entry's offsets
(for K1 the cyclic shift in the index arithmetic); LN1 (K2's Key block:
none, the raw tokens) into a 64-row tile whose pad rows are zero
and whose pad tokens the validity mask zeroes; per head group (a panel of
C), its q, k and v panels from weight tiles taken one by one from the
schedule, in the kernel's order, each product summed in f32; per (head,
m16 tile) the 16 x 64 scores with the pad keys at -inf, the softmax in f32
with the rounded numerators for p.v and the unrounded sum; proj into the
residual stream; LN2; the MLP by 128-wide hidden chunks, fc1 and GELU then
fc2's panels into the residual stream; pad query rows never stored; every
tile used once, in order. It rounds to the input type where the kernel
does (after LN1, after QKV, after q * scale, the numerators, the head
outputs, LN2 -- K2's Key block: none, the MLP input round(y) with y kept
in f32 for the residual --, GELU, the output).

At float32 it must agree within 1e-5 with the plain version (the kernel's
yardstick) and with the JAX package's kernel in Pallas interpret mode: K1
(``fused_window_block_rows``, its rolled frame rolled back), K2
(``fused_window_block``) in both of the style transformer's forms, no
norms and both; at bfloat16 with the plain version within the card's
tolerance (tests/test_torch_cuda_kernels.py): two units in the last place
plus 2^-6 of the largest update, the two sides rounding the same f32
values after sums in another order. Cases: C = 32 with 2 heads and C = 64
with 4 (head dim 16), with and without the shift, a 9 x 12 grid padded to
14 x 14 (a pad mask), B = 1 and 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.models.style_transformer import (
    init_style_swin_block,
)
from mastermetastyletransfer_tpu.ops import pallas_attention as jpallas
from mastermetastyletransfer_tpu.ops import windows as jwin
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from mastermetastyletransfer_tpu_torch.ops import windows as twin
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
VALID, PADDED = (9, 12), (14, 14)


def _ln(x, s, b):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * s + b


def _block_tc(xs, w, plan, *, heads, mask, padmask, rnd):
    """The tensor-core body on a batch of windows, as each window's block
    computes it from its plan: xs (W, n, C) f32 tokens, mask (W, n, n) and
    padmask (W, n) or None; the (W, n, C) f32 result before the output's
    rounding. The windows run side by side; each one's arithmetic is its
    block's."""
    nwin, n, c = xs.shape
    hidden, dh = w.w1.shape[1], c // heads
    rows, panel, kp = plan.rows, plan.panel, plan.kp
    tiles = iter(wb.tile_schedule(plan, c, hidden))
    mats = {k: getattr(w, k).float() for k in ("wqkv", "wp", "w1", "w2")}

    def gemm(a, k, width):
        acc = torch.zeros(nwin, rows, width)
        for k0 in range(0, k, kp):
            name, r0, c0, nr, wd = next(tiles)
            assert (nr, wd) == (kp, width)
            acc += a[:, :, k0:k0 + kp] @ mats[name][r0:r0 + kp, c0:c0 + wd]
        return acc

    ln = torch.zeros(nwin, rows, c)
    v = rnd(_ln(xs, w.n1s, w.n1b)) if w.n1s is not None else xs
    if padmask is not None:
        v = torch.where(padmask[:, :, None] == 0, 0.0, v)
    ln[:, :n] = rnd(v)
    ob = torch.zeros(nwin, rows, c)
    scale = dh ** -0.5
    for c0, wg in plan.head_groups:
        q = rnd(rnd(gemm(ln, c, wg) + w.bqkv[c0:c0 + wg]) * scale)
        k = rnd(gemm(ln, c, wg) + w.bqkv[c + c0:c + c0 + wg])
        vv = rnd(gemm(ln, c, wg) + w.bqkv[2 * c + c0:2 * c + c0 + wg])
        _attend_group(q, k, vv, ob, c0, wg, n, dh, w.rel_bias, mask, rnd)
    y = xs.clone()
    for p0, width in plan.head_groups:
        y[..., p0:p0 + width] = (y[..., p0:p0 + width]
                                 + gemm(ob, c, width)[:, :n]
                                 + w.bp[p0:p0 + width])
    h2 = _ln(y, w.n2s, w.n2b) if w.n2s is not None else y
    ln2 = torch.zeros(nwin, rows, c)
    ln2[:, :n] = rnd(h2)
    y = y + w.b2
    for j in range(hidden // panel):
        hid = rnd(F.gelu(gemm(ln2, c, panel)
                         + w.b1[j * panel:(j + 1) * panel]))
        for p0, width in plan.head_groups:
            y[..., p0:p0 + width] += gemm(hid, panel, width)[:, :n]
    assert next(tiles, None) is None  # every tile used, in order
    return y


def _attend_group(q, k, v, ob, c0, wg, n, dh, rel_bias, mask, rnd):
    """One head group's attention as its warps run it: per (head, m16
    tile), the 16 x 64 scores with (mask + bias) on the real keys and -inf
    on the pad keys, the softmax in f32, the rounded numerators against v,
    the unrounded sum; each head's output rounded into ob's columns."""
    nwin, rows = q.shape[:2]
    for hl in range(wg // dh):
        h, cols = c0 // dh + hl, slice(hl * dh, (hl + 1) * dh)
        comb = torch.zeros(nwin, rows, rows)
        comb[:, :n, :n] = rel_bias[h] + (mask if mask is not None else 0.0)
        comb[:, :, n:] = float("-inf")
        for mt in range(rows // 16):
            r = slice(16 * mt, 16 * mt + 16)
            s = q[:, r, cols] @ k[:, :, cols].transpose(1, 2) + comb[:, r]
            e = torch.exp(s - s.amax(-1, keepdim=True))
            o = (rnd(e) @ v[:, :, cols]) * (1.0 / e.sum(-1))[..., None]
            ob[:, r, c0 + hl * dh:c0 + (hl + 1) * dh] = rnd(o)


def _rounder(dtype):
    return lambda v: v.to(dtype).float()


def _replay(x, w, *, heads, window, shift, mask, padmask):
    """The tensor-core body's computation from its plan, on the rows
    entry's windows: each window's tokens at the rows entry's offsets (the
    cyclic shift in the index arithmetic), its result written back where
    each token was read."""
    b, hp, wp, c = x.shape
    (wh, ww), (sh, sw) = window, shift
    n, hidden = wh * ww, w.w1.shape[1]
    plan = wb.block_plan("window_block_rows", n, c, heads, hidden,
                         torch.bfloat16)
    assert plan.body == "tc"
    nww, nw = wp // ww, (hp // wh) * (wp // ww)
    toks = []
    for wi in range(nw):
        wr, wc = divmod(wi, nww)
        toks.append([((wr * wh + i + sh) % hp, (wc * ww + j + sw) % wp)
                     for i in range(wh) for j in range(ww)])
    rr = torch.tensor([[r for r, _ in t] for t in toks])
    cc = torch.tensor([[q for _, q in t] for t in toks])
    xs = x[:, rr, cc].float().reshape(b * nw, n, c)
    y = _block_tc(xs, w, plan, heads=heads,
                  mask=None if mask is None else mask.repeat(b, 1, 1),
                  padmask=None if padmask is None else padmask.repeat(b, 1),
                  rnd=_rounder(x.dtype))
    out = torch.full_like(x, float("nan"))
    out[:, rr, cc] = y.reshape(b, nw, n, c).to(x.dtype)
    assert not out.isnan().any()  # every token written once
    return out


def _replay_windows(x, w, *, heads, mask, padmask):
    """The same body on the windows entry's (B, nW, N, C) tensor: window
    w's token t at ((b nW + w) N + t) C."""
    b, nw, n, c = x.shape
    plan = wb.block_plan("window_block_windows", n, c, heads, w.w1.shape[1],
                         torch.bfloat16)
    assert plan.body == "tc"
    y = _block_tc(x.float().reshape(b * nw, n, c), w, plan, heads=heads,
                  mask=None if mask is None else mask.repeat(b, 1, 1),
                  padmask=None if padmask is None else padmask.repeat(b, 1),
                  rnd=_rounder(x.dtype))
    return y.reshape(x.shape).to(x.dtype)


def _case(c, heads, shift, b, seed=0):
    """JAX and torch params of one block (non-trivial norms), the padded
    input, the masks (numpy and torch) and the effective shift."""
    rng = np.random.default_rng(seed + c + b)
    cj = jcfg.AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                              shift_size=shift, use_pallas=True)
    p = jax.device_get(init_style_swin_block(
        jax.random.PRNGKey(seed), cj, use_norm=True, exclude_mlp=False,
        mlp_ratio=4.0))
    for norm in ("norm1", "norm2"):
        p[norm] = {"scale": 1.0 + 0.3 * rng.standard_normal(c).astype(
                       np.float32),
                   "bias": 0.3 * rng.standard_normal(c).astype(np.float32)}
    x = np.zeros((b, *PADDED, c), np.float32)
    x[:, :VALID[0], :VALID[1]] = rng.standard_normal(
        (b, *VALID, c)).astype(np.float32)
    # garbage in the pad tokens must stay inert
    x[:, VALID[0]:] = 7.0
    sh, sw = twin.effective_shift(*PADDED, (7, 7), shift)
    mask = (jwin.shift_attention_mask(*PADDED, 7, 7, sh, sw)
            if sh or sw else None)
    padmask = jwin.valid_token_mask(*VALID, *PADDED, 7, 7, sh, sw)
    return p, x, mask, padmask, (sh, sw)


CASES = [(c, heads, shift, b) for c, heads in ((32, 2), (64, 4))
         for shift in ((0, 0), (3, 3)) for b in (1, 2)]


@pytest.mark.parametrize("c,heads,shift,b", CASES)
def test_replay_matches_plain_and_jax(c, heads, shift, b):
    p, x, mask, padmask, eff = _case(c, heads, shift, b)
    pt = params_from_jax(p)
    w = wb.block_weights(pt, (7, 7), torch.float32, True)
    kw = dict(heads=heads, window=(7, 7), shift=eff,
              mask=None if mask is None else torch.from_numpy(mask),
              padmask=torch.from_numpy(padmask))
    xt = torch.from_numpy(x)
    got = _replay(xt, w, **kw)
    plain = wb.window_block_rows_plain(xt, w, **kw)
    valid = (slice(None), slice(0, VALID[0]), slice(0, VALID[1]))
    # the real tokens within 1e-5; every token, the pad tokens' garbage
    # (outputs near 7) too, within 1e-5 of the largest magnitude (f32 sums
    # in another order)
    assert (got - plain)[valid].abs().max().item() <= TOL
    scale = max(1.0, plain.abs().max().item())
    assert (got - plain).abs().max().item() <= TOL * scale

    pj = jax.tree_util.tree_map(jnp.asarray, p)
    bias = jwin.relative_position_bias(pj["attn"]["rel_bias_table"], 7, 7)
    ref = np.asarray(jpallas.fused_window_block_rows(
        pj["attn"], jnp.asarray(x), bias, mask, heads, pj["mlp"],
        pj["norm2"], pj["norm1"], padmask, window=(7, 7), shift=eff,
        interpret=True))
    ref = np.roll(ref, eff, (1, 2))
    err = np.abs(got.numpy()[valid] - ref[valid]).max()
    assert err <= TOL, err


@pytest.mark.parametrize("shift", [(0, 0), (3, 3)])
def test_replay_rounds_where_the_plain_version_rounds(shift):
    """At bfloat16 the replay's rounding points are the plain version's:
    the two agree within the card's bf16 tolerance."""
    p, x, mask, padmask, eff = _case(64, 4, shift, 2, seed=1)
    w = wb.block_weights(params_from_jax(p), (7, 7), torch.bfloat16, True)
    kw = dict(heads=4, window=(7, 7), shift=eff,
              mask=None if mask is None else torch.from_numpy(mask),
              padmask=torch.from_numpy(padmask))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = _replay(xt, w, **kw).float()
    ref = wb.window_block_rows_plain(xt, w, **kw).float()
    ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
    tol = (2 * torch.where(ref == 0, 0.0, ulp)
           + 2.0 ** -6 * (ref - xt.float()).abs().max())
    assert ((got - ref).abs() <= tol).all()


def test_plan_takes_the_swin_stages_and_leaves_the_rest_scalar():
    """Both entries at bf16 run the tensor-core body at swin_T/S/B's
    widths (head dim 32), the style transformer's (K2 at C = 256, 8 heads)
    and the test widths (16): two blocks an SM (2 tiles of 32 weight rows,
    the head outputs in the normed tile's place) where C <= 128, one (3
    tiles of 64) above, the same plan for both entries; f32 and a head dim
    outside 16/32/64 or a window over 64 tokens run the scalar body. Every
    plan fits its blocks' share of an SM's shared memory."""
    bf16 = torch.bfloat16
    for entry in ("window_block_rows", "window_block_windows"):
        for c, heads, per_sm in ((96, 3, 2), (128, 4, 2), (192, 6, 1),
                                 (256, 8, 1), (32, 2, 2), (64, 4, 2)):
            plan = wb.block_plan(entry, 49, c, heads, 4 * c, bf16)
            kp, stages = (32, 2) if per_sm == 2 else (64, 3)
            assert (plan.body, plan.blocks_per_sm, plan.kp,
                    plan.stages) == ("tc", per_sm, kp, stages)
            assert plan.smem_bytes == wb.tc_layout(49, c, kp, stages,
                                                   per_sm == 2)["total"]
            assert plan.smem_bytes <= min(wb.MAX_SMEM_BYTES,
                                          wb.SMEM_PER_SM // per_sm - 1024)
            assert sum(wd for _, wd in plan.head_groups) == c
            assert plan == wb.block_plan("window_block_rows", 49, c, heads,
                                         4 * c, bf16)
    for args in (("window_block_rows", 49, 128, 4, 512, torch.float32),
                 ("window_block_windows", 49, 256, 8, 1024, torch.float32),
                 ("window_block_rows", 49, 96, 12, 384, bf16),
                 ("window_block_windows", 49, 96, 12, 384, bf16),
                 ("window_block_rows", 81, 128, 4, 512, bf16),
                 ("window_block_windows", 81, 128, 4, 512, bf16)):
        assert wb.block_plan(*args).body == "scalar"


# K2 as the style transformer runs it: the encoder Key block (no LN1, no
# LN2) and the decoder self block (both norms), on (B, nW, N, C) windows of
# the 9 x 12 grid padded to 14 x 14, with the shift (3, 3) and pad masks
# or with neither.
K2_FORMS = {"key": dict(use_norm=False, norm2=False),
            "self": dict(use_norm=True, norm2=None)}


def _k2_case(c, heads, form, masked, b, seed=0):
    """JAX params, (b, 4, 49, c) windows and the masks (None unmasked,
    where every token is real: no garbage in the grid's pad)."""
    p, x, mask, padmask, eff = _case(c, heads, (3, 3) if masked else (0, 0),
                                     b, seed)
    if not masked:
        x = np.random.default_rng(seed + 7).standard_normal(
            x.shape).astype(np.float32)
    sh, sw = eff
    xr = np.roll(x, (-sh, -sw), (1, 2))
    xw = np.ascontiguousarray(
        xr.reshape(b, 2, 7, 2, 7, c).transpose(0, 1, 3, 2, 4, 5)
        .reshape(b, 4, 49, c))
    return p, xw, (mask if masked else None), (padmask if masked else None)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("form", list(K2_FORMS))
@pytest.mark.parametrize("c,heads,b", [(32, 2, 2), (64, 4, 1)])
def test_k2_replay_matches_plain_and_jax(c, heads, b, form, masked):
    """K2's windows entry on the tensor-core body in both of the style
    transformer's forms, against window_block_windows_plain and JAX's
    fused_window_block (interpret mode) within 1e-5 at f32."""
    p, xw, mask, padmask = _k2_case(c, heads, form, masked, b)
    opts = K2_FORMS[form]
    w = wb.block_weights(params_from_jax(p), (7, 7), torch.float32,
                         opts["use_norm"], norm2=opts["norm2"])
    assert (w.n1s is None, w.n2s is None) == ((form == "key",) * 2)
    kw = dict(heads=heads,
              mask=None if mask is None else torch.from_numpy(mask),
              padmask=None if padmask is None else torch.from_numpy(padmask))
    xt = torch.from_numpy(xw)
    got = _replay_windows(xt, w, **kw)
    plain = wb.window_block_windows_plain(xt, w, **kw)
    scale = max(1.0, plain.abs().max().item())
    assert (got - plain).abs().max().item() <= TOL * scale

    pj = jax.tree_util.tree_map(jnp.asarray, p)
    bias = jwin.relative_position_bias(pj["attn"]["rel_bias_table"], 7, 7)
    norms = (None, None) if form == "key" else (pj["norm2"], pj["norm1"])
    ref = np.asarray(jpallas.fused_window_block(
        pj["attn"], jnp.asarray(xw), bias, mask, heads, pj["mlp"], *norms,
        padmask, interpret=True))
    if padmask is not None:     # the real tokens; the pad ones hold garbage
        keep = np.broadcast_to(padmask[None, :, :, None] == 1, ref.shape)
        err = np.abs(got.numpy() - ref)[keep].max()
    else:
        err = np.abs(got.numpy() - ref).max()
    assert err <= TOL, err


@pytest.mark.parametrize("form", list(K2_FORMS))
def test_k2_replay_rounds_where_the_plain_version_rounds(form):
    """At bfloat16 K2's replay in either form agrees with the plain version
    within the card's bf16 tolerance; the Key block's MLP input is round(y)
    while its second residual keeps y in f32."""
    p, xw, mask, padmask = _k2_case(64, 4, form, True, 2, seed=1)
    opts = K2_FORMS[form]
    w = wb.block_weights(params_from_jax(p), (7, 7), torch.bfloat16,
                         opts["use_norm"], norm2=opts["norm2"])
    kw = dict(heads=4, mask=torch.from_numpy(mask),
              padmask=torch.from_numpy(padmask))
    xt = torch.from_numpy(xw).to(torch.bfloat16)
    got = _replay_windows(xt, w, **kw).float()
    ref = wb.window_block_windows_plain(xt, w, **kw).float()
    ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
    tol = (2 * torch.where(ref == 0, 0.0, ulp)
           + 2.0 ** -6 * (ref - xt.float()).abs().max())
    assert ((got - ref).abs() <= tol).all()


@pytest.mark.parametrize("c,heads", [(32, 2), (96, 3), (192, 6), (256, 8)])
def test_schedule_streams_each_weight_once_per_use(c, heads):
    """The tiles cover wqkv, wp and w1 once each and w2 once, every tile
    kp rows deep and at most a panel wide."""
    hidden = 4 * c
    plan = wb.block_plan("window_block_rows", 49, c, heads, hidden,
                         torch.bfloat16)
    shapes = {"wqkv": (c, 3 * c), "wp": (c, c), "w1": (c, hidden),
              "w2": (hidden, c)}
    count = {k: torch.zeros(s, dtype=torch.int32) for k, s in shapes.items()}
    for name, r0, c0, nr, wd in wb.tile_schedule(plan, c, hidden):
        assert nr == plan.kp and 0 < wd <= plan.panel and wd % 32 == 0
        count[name][r0:r0 + nr, c0:c0 + wd] += 1
    for k in count:
        assert (count[k] == 1).all(), k


def _weights_params(seed=0):
    cfg = jcfg.AttentionConfig(dim=32, num_heads=2, window_size=(7, 7),
                               shift_size=(0, 0))
    return params_from_jax(jax.device_get(init_style_swin_block(
        jax.random.PRNGKey(seed), cfg, use_norm=True, exclude_mlp=False,
        mlp_ratio=4.0)))


def test_block_weights_cache_hits():
    """The same params, dtype and options give the same prepared tensors
    (no rebuild); another dtype or other options are other entries."""
    pt = _weights_params()
    w1 = wb.block_weights(pt, (7, 7), torch.bfloat16, True)
    w2 = wb.block_weights(pt, (7, 7), torch.bfloat16, True)
    assert w1 is w2
    assert wb.block_weights(pt, (7, 7), torch.float32, True) is not w1
    assert wb.block_weights(pt, (7, 7), torch.bfloat16, False) is not w1


def test_block_weights_cache_misses_after_an_in_place_update():
    """An in-place update of a source (an optimizer step) bumps its version:
    the next call rebuilds, and the rebuilt weights carry the update."""
    pt = _weights_params()
    before = wb.block_weights(pt, (7, 7), torch.float32, True)
    wq = before.wqkv.clone()
    with torch.no_grad():
        pt["attn"]["wq"]["kernel"].add_(1.0)
        pt["mlp"]["fc2"]["bias"].mul_(2.0)
    after = wb.block_weights(pt, (7, 7), torch.float32, True)
    assert after is not before
    c = wq.shape[0]
    assert torch.equal(after.wqkv[:, :c], wq[:, :c] + 1.0)
    assert torch.equal(after.b2, pt["mlp"]["fc2"]["bias"])
    assert wb.block_weights(pt, (7, 7), torch.float32, True) is after


def test_block_weights_not_cached_under_autograd():
    """A source that requires grad (with grad enabled) is prepared afresh
    each call, so that the graph runs through it."""
    pt = _weights_params()
    pt["mlp"]["fc1"]["kernel"].requires_grad_()
    w1 = wb.block_weights(pt, (7, 7), torch.float32, True)
    w2 = wb.block_weights(pt, (7, 7), torch.float32, True)
    assert w1 is not w2 and w1.w1.requires_grad
