"""K3's tensor-core body (csrc/style_tc.cuh) replayed in torch on the CPU
from its plan (ops/style_block.py:style_plan, style_layout; its weights in
ops/window_block.py:tile_schedule's order).

The replay runs the kernel's algorithm on every (window, stream) block (the
blocks side by side) as it reads the plan: Key's and the stream's tokens
into 64-row tiles whose pad rows are zero; LN1 of each (or the raw tokens)
and the pad tokens zeroed; per head group (a panel of C), q and k panels
from Key's view and the v panel from the stream's, through the shared
[wq | wk | wv], from weight tiles taken one by one from the schedule, each
product summed in f32; the head group's attention as K1's warps run it
(tests/test_torch_window_tc_plan.py's, shared); round(y) = round(V_raw + heads wp +
bp); the f32 sum round(y) + b2, then the stream's MLP by 128-wide hidden
chunks, fc1 on round(y) and GELU, fc2's panels into the sum; every tile
used once, in order. It rounds to the input type where the kernel does
(the normed views, q before and after the scale, k, v, the numerators,
the head outputs, y, GELU, the output).

At float32 it must agree within 1e-4 with encoder_scale_shift_plain (the
kernel's yardstick) and with the JAX package's K3
(``fused_encoder_scale_shift``, in Pallas interpret mode); at bfloat16
with the plain version within the card's tolerance (two units in the last
place plus 2^-6 of the largest update), a unit off in a few elements at
most, while the same replay with K2's residual (y kept in f32, not
round(y)) must move a third of them. Cases: C = 256 with
8 heads (the style transformer's) and C = 32 with 2 (head dim 16), LN1 off
and on, with and without the pad mask and the shift mask, on a 9 x 9 grid
padded to 14 x 14 (4 windows; the pad tokens hold garbage).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.ops import attention as jattn
from mastermetastyletransfer_tpu.ops import mlp as jmlp
from mastermetastyletransfer_tpu.ops import pallas_attention as jpallas
from mastermetastyletransfer_tpu.ops import windows as jwin
from mastermetastyletransfer_tpu_torch.ops import style_block as sb
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax
from tests.test_torch_window_tc_plan import _attend_group, _ln
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
GRID, PAD = 9, 14


def _replay(key, scale_in, shift_in, w, *, heads, mask, padmask,
            residual="round"):
    """(Scale', Shift') as K3's tensor-core blocks compute them from the
    plan; ``residual="f32"`` swaps in K2's second residual (y in f32, the
    MLP still on round(y)), the error the test must catch."""
    b, nw, n, c = key.shape
    hidden = w.s_w1.shape[1]
    plan = sb.style_plan(n, c, heads, hidden, torch.bfloat16)
    assert plan.body == "tc"
    rows, panel, kp, dh = plan.rows, plan.panel, plan.kp, c // heads

    def rnd(v):
        return v.to(key.dtype).float()

    masks = (None if mask is None else mask.repeat(b, 1, 1),
             None if padmask is None else padmask.repeat(b, 1))

    def view(x):
        """The 64-row normed view zp(LN1 x) of each window."""
        xs = x.float().reshape(b * nw, n, c)
        v = rnd(_ln(xs, w.n1s, w.n1b)) if w.n1s is not None else xs
        if masks[1] is not None:
            v = torch.where(masks[1][:, :, None] == 0, 0.0, v)
        t = torch.zeros(b * nw, rows, c)
        t[:, :n] = v
        return t

    kt = view(key)
    outs = []
    for vin, mlp in ((scale_in, ("s_w1", "s_b1", "s_w2", "s_b2")),
                     (shift_in, ("h_w1", "h_b1", "h_w2", "h_b2"))):
        w1, b1, w2, b2 = (getattr(w, f) for f in mlp)
        mats = {"wqkv": w.wqkv.float(), "wp": w.wp.float(),
                "w1": w1.float(), "w2": w2.float()}
        tiles = iter(wb.tile_schedule(plan, c, hidden))

        def gemm(a, k, width):
            acc = torch.zeros(a.shape[0], rows, width)
            for k0 in range(0, k, kp):
                name, r0, c0, nr, wd = next(tiles)
                assert (nr, wd) == (kp, width)
                acc += a[:, :, k0:k0 + kp] @ mats[name][r0:r0 + kp,
                                                        c0:c0 + wd]
            return acc

        vt = view(vin)
        ob = torch.zeros(b * nw, rows, c)
        for c0, wg in plan.head_groups:
            q = rnd(rnd(gemm(kt, c, wg) + w.bqkv[c0:c0 + wg]) * dh ** -0.5)
            k = rnd(gemm(kt, c, wg) + w.bqkv[c + c0:c + c0 + wg])
            v = rnd(gemm(vt, c, wg) + w.bqkv[2 * c + c0:2 * c + c0 + wg])
            _attend_group(q, k, v, ob, c0, wg, n, dh, w.rel_bias, masks[0],
                          rnd)
        y = vin.float().reshape(b * nw, n, c).clone()
        for p0, width in plan.head_groups:
            y[..., p0:p0 + width] = (y[..., p0:p0 + width]
                                     + gemm(ob, c, width)[:, :n]
                                     + w.bp[p0:p0 + width])
        yr = torch.zeros(b * nw, rows, c)
        yr[:, :n] = rnd(y)
        acc = (yr[:, :n] if residual == "round" else y) + b2
        for j in range(hidden // panel):
            hid = rnd(F.gelu(gemm(yr, c, panel)
                             + b1[j * panel:(j + 1) * panel]))
            for p0, width in plan.head_groups:
                acc[..., p0:p0 + width] += gemm(hid, panel, width)[:, :n]
        assert next(tiles, None) is None  # every tile used, in order
        outs.append(acc.reshape(key.shape).to(key.dtype))
    return tuple(outs)


def _case(c, heads, use_ln1, padded, shifted, seed=0):
    """JAX and torch weights (a non-trivial LN1 where use_ln1), the Key,
    Scale and Shift windows (numpy), and the masks (numpy or None)."""
    rng = np.random.default_rng(seed + c + 2 * use_ln1 + padded + shifted)
    cj = jcfg.AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                              shift_size=(4, 4))
    attn = jax.device_get(jattn.init_window_attention(
        jax.random.PRNGKey(seed), cj))
    mlps = [jax.device_get(jmlp.init_mlp(jax.random.PRNGKey(seed + i), c,
                                         4 * c, init="xavier_uniform"))
            for i in (1, 2)]
    norm1 = ({"scale": 1.0 + 0.3 * rng.standard_normal(c).astype(np.float32),
              "bias": 0.3 * rng.standard_normal(c).astype(np.float32)}
             if use_ln1 else None)
    sh, sw = jwin.effective_shift(PAD, PAD, (7, 7), (4, 4))
    mask = jwin.shift_attention_mask(PAD, PAD, 7, 7, sh, sw)
    padmask = jwin.valid_token_mask(GRID, GRID, PAD, PAD, 7, 7, sh, sw)
    xs = [rng.standard_normal((2, 4, 49, c)).astype(np.float32) * 0.5
          for _ in range(3)]
    if padded:   # the pad tokens hold garbage that must stay inert
        xs = [np.where(padmask[None, :, :, None] == 0, 5.0, x) for x in xs]
    return (attn, mlps, norm1, xs, mask if shifted else None,
            padmask if padded else None)


CASES = [(c, heads, use_ln1, padded, shifted)
         for c, heads in ((256, 8), (32, 2)) for use_ln1 in (False, True)
         for padded in (True, False) for shifted in (True, False)]


@pytest.mark.parametrize("c,heads,use_ln1,padded,shifted", CASES)
def test_replay_matches_plain_and_jax(c, heads, use_ln1, padded, shifted):
    attn, mlps, norm1, xs, mask, padmask = _case(c, heads, use_ln1, padded,
                                                 shifted)
    w = sb.encoder_weights(params_from_jax(attn), *map(params_from_jax, mlps),
                           None if norm1 is None else params_from_jax(norm1),
                           (7, 7), torch.float32)
    kw = dict(heads=heads,
              mask=None if mask is None else torch.from_numpy(mask),
              padmask=None if padmask is None else torch.from_numpy(padmask))
    xt = [torch.from_numpy(x) for x in xs]
    got = _replay(*xt, w, **kw)
    plain = sb.encoder_scale_shift_plain(*xt, w, **kw)
    pj = jax.tree_util.tree_map(jnp.asarray, attn)
    bias = jwin.relative_position_bias(pj["rel_bias_table"], 7, 7)
    want = jpallas.fused_encoder_scale_shift(
        pj, *map(jnp.asarray, xs), bias, mask, heads,
        *(jax.tree_util.tree_map(jnp.asarray, m) for m in mlps),
        None if norm1 is None else jax.tree_util.tree_map(jnp.asarray, norm1),
        padmask, interpret=True)
    for g, p, j in zip(got, plain, want):
        assert (g - p).abs().max().item() <= TOL
        assert np.abs(g.numpy() - np.asarray(j)).max() <= TOL


@pytest.mark.parametrize("use_ln1", [False, True])
def test_replay_rounds_where_the_plain_version_rounds(use_ln1):
    """At bfloat16 the replay agrees with the plain version within the
    card's tolerance, its output elements equal to the plain version's but
    for a few that a sum in another order moved by a unit; with K2's f32
    residual instead of round(y), a third of them move (the half unit that
    round(y) drops), whatever the tolerance says."""
    attn, mlps, norm1, xs, mask, padmask = _case(256, 8, use_ln1, True, True,
                                                 seed=1)
    w = sb.encoder_weights(params_from_jax(attn), *map(params_from_jax, mlps),
                           None if norm1 is None else params_from_jax(norm1),
                           (7, 7), torch.bfloat16)
    kw = dict(heads=8, mask=torch.from_numpy(mask),
              padmask=torch.from_numpy(padmask))
    xt = [torch.from_numpy(x).to(torch.bfloat16) for x in xs]
    plain = sb.encoder_scale_shift_plain(*xt, w, **kw)

    def compare(got):
        """(largest error / tolerance, share of elements that differ, mean
        |error|) over both streams."""
        worst, moved, mean = 0.0, 0.0, 0.0
        for g, ref, x in zip(got, plain, xt[1:]):
            g, ref = g.float(), ref.float()
            ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
            tol = (2 * torch.where(ref == 0, 0.0, ulp)
                   + 2.0 ** -6 * (ref - x.float()).abs().max())
            err = (g - ref).abs()
            worst = max(worst, (err / tol).max().item())
            moved = max(moved, (err > 0).float().mean().item())
            mean = max(mean, err.mean().item())
        return worst, moved, mean

    worst, moved, mean = compare(_replay(*xt, w, **kw))
    assert worst <= 1.0 and moved < 0.02
    _, moved_f32, mean_f32 = compare(_replay(*xt, w, residual="f32", **kw))
    assert moved_f32 > 0.2 and mean_f32 > 10 * mean


@pytest.mark.parametrize("c,heads,kp", [(32, 2, 32), (96, 3, 32),
                                        (128, 4, 64), (192, 6, 64),
                                        (256, 8, 64), (256, 16, 64),
                                        (256, 4, 64)])
def test_plan_takes_bf16_and_fits_a_block(c, heads, kp):
    """At bf16 K3 runs the tensor-core body, one block of 16 warps an SM
    with a ring of 3 tiles of kp rows (64 where C allows), at head dims
    16, 32 and 64; its shared memory is style_layout's and fits a block
    (232,448 bytes; 206,848 at C = 256), the f32 output sum fitting the
    two tiles it takes over."""
    plan = sb.style_plan(49, c, heads, 4 * c, torch.bfloat16)
    assert (plan.body, plan.blocks_per_sm, plan.kp, plan.stages) == (
        "tc", 1, kp, 3)
    lay = sb.style_layout(49, c, kp, 3)
    assert plan.smem_bytes == lay["total"] <= wb.MAX_SMEM_BYTES
    assert lay["xs"] == lay["kt"] and lay["ob"] - lay["kt"] == lay["vt"] - \
        lay["ob"] == 2 * 64 * (c + 8)
    assert 4 * 49 * (c + 4) <= lay["vt"] - lay["kt"]
    assert sum(wd for _, wd in plan.head_groups) == c
    if c == 256:
        assert plan.smem_bytes == 206848


def test_plan_leaves_f32_and_other_shapes_scalar():
    """f32, a head dim outside 16/32/64, C not a multiple of 32, a window
    over 64 tokens or an MLP width not a multiple of 128 keep the scalar
    body."""
    for args in ((49, 256, 8, 1024, torch.float32),
                 (49, 96, 12, 384, torch.bfloat16),
                 (49, 80, 5, 320, torch.bfloat16),
                 (81, 256, 8, 1024, torch.bfloat16),
                 (49, 256, 8, 960, torch.bfloat16)):
        assert sb.style_plan(*args).body == "scalar"


@pytest.mark.parametrize("c,heads", [(32, 2), (256, 8)])
def test_schedule_streams_each_weight_once_per_block(c, heads):
    """One block's tiles (tile_schedule, K1's order) cover the shared
    [wq | wk | wv] and wp once each and the stream's w1 and w2 once, every
    tile kp rows deep and at most a panel wide."""
    hidden = 4 * c
    plan = sb.style_plan(49, c, heads, hidden, torch.bfloat16)
    shapes = {"wqkv": (c, 3 * c), "wp": (c, c), "w1": (c, hidden),
              "w2": (hidden, c)}
    count = {k: torch.zeros(s, dtype=torch.int32) for k, s in shapes.items()}
    for name, r0, c0, nr, wd in wb.tile_schedule(plan, c, hidden):
        assert nr == plan.kp and 0 < wd <= plan.panel and wd % 32 == 0
        count[name][r0:r0 + nr, c0:c0 + wd] += 1
    for k in count:
        assert (count[k] == 1).all(), k
