"""K4's tensor-core body (csrc/tail_tc.cuh) replayed in torch on the CPU
from its plan (ops/style_block.py:tail_plan, tail_layout) and the order of
its weight tiles (tail_tile_schedule).

The replay runs the kernel's algorithm on every window's block (the blocks
side by side) as it reads the plan: per value stream (Scale, then Shift),
its raw tokens with the pad tokens zeroed in a 64-row tile whose pad rows
are zero; per head group (a panel of C), the q panel (q times the scale,
rounded) and the k panel as given, pad rows zero, and the v panel through
the stream's columns of wv, from weight tiles taken one by one from the
schedule, each product summed in f32; the group's attention as K1's warps
run it (tests/test_torch_window_tc_plan.py's, shared) into the stream's head
tile; per panel of C, sigma = heads_s wp + bp and mu = heads_h wp + bp in
f32 (wp's tiles twice), round(y) = round(Query sigma + mu); the f32 sum
round(y) + b2, then the last MLP by 128-wide hidden chunks, fc1 on round(y)
and GELU, fc2's panels into the sum; every tile used once, in order. It
rounds to the input type where the kernel does (q after the scale, v, the
numerators, the head outputs, y, GELU, the output).

At float32 it must agree within 1e-4 with decoder_tail_plain (the kernel's
yardstick) and with the JAX package's K4 (``fused_decoder_tail``, in Pallas
interpret mode); at bfloat16 with the plain version within the card's
tolerance (two units in the last place plus 2^-6 of the largest |out -
Query|), a unit off in a few elements at most, while the same replay with a
rounding point moved -- sigma and mu rounded to bf16, or y kept in f32 as
the MLP's residual -- must move a clear share of them. Cases: C = 256 with
8 heads (the style transformer's) and C = 32 with 2 (head dim 16), the
shift mask and the pad mask each on and off, on a 9 x 9 grid padded to 14 x
14 (4 windows; the value streams' pad tokens hold garbage).
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
from tests.test_torch_window_tc_plan import _attend_group
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
GRID, PAD = 9, 14
# The rounding points a planted variant moves: "sigma_mu" rounds sigma and
# mu to the input type, "y_f32" keeps y in f32 as the MLP's residual.
VARIANTS = ("sigma_mu", "y_f32")


def _replay(q, k, v_scale, v_shift, query, w, *, heads, mask, padmask,
            variant=None):
    """K4's output as its tensor-core blocks compute it from the plan;
    ``variant`` (one of VARIANTS) moves one rounding point."""
    b, nw, n, c = q.shape
    hidden = w.w1.shape[1]
    plan = sb.tail_plan(n, c, heads, hidden, torch.bfloat16)
    assert plan.body == "tc"
    rows, panel, kp, dh = plan.rows, plan.panel, plan.kp, c // heads

    def rnd(v):
        return v.to(q.dtype).float()

    masks = (None if mask is None else mask.repeat(b, 1, 1),
             None if padmask is None else padmask.repeat(b, 1))
    mats = {name: getattr(w, name).float() for name in ("wv", "wp", "w1",
                                                        "w2")}
    tiles = iter(sb.tail_tile_schedule(plan, c, hidden))

    def gemm(a, depth, width):
        acc = torch.zeros(a.shape[0], rows, width)
        for k0 in range(0, depth, kp):
            name, r0, c0, nr, wd = next(tiles)
            assert (nr, wd) == (kp, width)
            acc += a[:, :, k0:k0 + kp] @ mats[name][r0:r0 + kp, c0:c0 + wd]
        return acc

    def tile(x):
        """A (B nW, 64, C) tile of the windows, pad rows zero."""
        t = torch.zeros(b * nw, rows, x.shape[-1])
        t[:, :n] = x.float().reshape(b * nw, n, -1)
        return t

    obs = []
    for s, vin in enumerate((v_scale, v_shift)):
        v_raw = vin.float().reshape(b * nw, n, c)
        if masks[1] is not None:
            v_raw = torch.where(masks[1][:, :, None] == 0, 0.0, v_raw)
        vt = tile(v_raw)
        ob = torch.zeros(b * nw, rows, c)
        for c0, wg in plan.head_groups:
            qp = tile(rnd(q[..., c0:c0 + wg].float() * dh ** -0.5))
            kpn = tile(k[..., c0:c0 + wg])
            v = rnd(gemm(vt, c, wg) + w.bv[s * c + c0:s * c + c0 + wg])
            _attend_group(qp, kpn, v, ob, c0, wg, n, dh, w.rel_bias,
                          masks[0], rnd)
        obs.append(ob)
    qy = query.float().reshape(b * nw, n, c)
    y = torch.zeros(b * nw, n, c)
    for p0, width in plan.head_groups:
        sigma = gemm(obs[0], c, width)[:, :n] + w.bp[p0:p0 + width]
        mu = gemm(obs[1], c, width)[:, :n] + w.bp[p0:p0 + width]
        if variant == "sigma_mu":
            sigma, mu = rnd(sigma), rnd(mu)
        y[..., p0:p0 + width] = qy[..., p0:p0 + width] * sigma + mu
    yr = tile(rnd(y))
    acc = (y if variant == "y_f32" else yr[:, :n]) + w.b2
    for j in range(hidden // panel):
        hid = rnd(F.gelu(gemm(yr, c, panel)
                         + w.b1[j * panel:(j + 1) * panel]))
        for p0, width in plan.head_groups:
            acc[..., p0:p0 + width] += gemm(hid, panel, width)[:, :n]
    assert next(tiles, None) is None  # every tile used, in order
    return acc.reshape(q.shape).to(q.dtype)


def _case(c, heads, padded, shifted, seed=0):
    """JAX dual-value attention and last-MLP params, the five windows
    (numpy: q, k, Scale, Shift, Query) and the masks (numpy or None)."""
    rng = np.random.default_rng(seed + c + 2 * padded + shifted)
    cj = jcfg.AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                              shift_size=(4, 4))
    dual = jax.device_get(jattn.init_dual_value_window_attention(
        jax.random.PRNGKey(seed), cj))
    mlp = jax.device_get(jmlp.init_mlp(jax.random.PRNGKey(seed + 1), c,
                                       4 * c, init="xavier_uniform"))
    sh, sw = jwin.effective_shift(PAD, PAD, (7, 7), (4, 4))
    mask = jwin.shift_attention_mask(PAD, PAD, 7, 7, sh, sw)
    padmask = jwin.valid_token_mask(GRID, GRID, PAD, PAD, 7, 7, sh, sw)
    xs = [rng.standard_normal((2, 4, 49, c)).astype(np.float32) * 0.5
          for _ in range(5)]
    if padded:   # the value streams' pad tokens hold garbage, zeroed inside
        for i in (2, 3):
            xs[i] = np.where(padmask[None, :, :, None] == 0, 5.0, xs[i])
    return (dual, mlp, xs, mask if shifted else None,
            padmask if padded else None)


def _weights(dual, mlp, dtype):
    return sb.decoder_tail_weights(params_from_jax(dual),
                                   params_from_jax(mlp), (7, 7), dtype)


def _kw(heads, mask, padmask):
    return dict(heads=heads,
                mask=None if mask is None else torch.from_numpy(mask),
                padmask=None if padmask is None else torch.from_numpy(
                    padmask))


CASES = [(c, heads, padded, shifted)
         for c, heads in ((256, 8), (32, 2)) for padded in (True, False)
         for shifted in (True, False)]


@pytest.mark.parametrize("c,heads,padded,shifted", CASES)
def test_replay_matches_plain_and_jax(c, heads, padded, shifted):
    dual, mlp, xs, mask, padmask = _case(c, heads, padded, shifted)
    w = _weights(dual, mlp, torch.float32)
    kw = _kw(heads, mask, padmask)
    xt = [torch.from_numpy(x) for x in xs]
    got = _replay(*xt, w, **kw)
    plain = sb.decoder_tail_plain(*xt, w, **kw)
    assert (got - plain).abs().max().item() <= TOL
    dj = jax.tree_util.tree_map(jnp.asarray, dual)
    bias = jwin.relative_position_bias(dj["rel_bias_table"], 7, 7)
    want = jpallas.fused_decoder_tail(
        dj, *map(jnp.asarray, xs), bias, mask, heads,
        jax.tree_util.tree_map(jnp.asarray, mlp), padmask, interpret=True)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


def _compare(got, ref, query):
    """(largest error / the card's tolerance, share of elements that
    differ, mean |error|)."""
    got, ref = got.float(), ref.float()
    ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
    tol = (2 * torch.where(ref == 0, 0.0, ulp)
           + 2.0 ** -6 * (ref - query.float()).abs().max())
    err = (got - ref).abs()
    return ((err / tol).max().item(), (err > 0).float().mean().item(),
            err.mean().item())


@pytest.mark.parametrize("padded", [True, False])
def test_replay_rounds_where_the_plain_version_rounds(padded):
    """At bfloat16 the replay agrees with the plain version within the
    card's tolerance, its output elements equal to the plain version's but
    for a few that a sum in another order moved by a unit; with sigma and
    mu rounded to bf16, or y kept in f32 as the MLP's residual, a clear
    share of them move, whatever the tolerance says."""
    dual, mlp, xs, mask, padmask = _case(256, 8, padded, True, seed=1)
    w = _weights(dual, mlp, torch.bfloat16)
    kw = _kw(8, mask, padmask)
    xt = [torch.from_numpy(x).to(torch.bfloat16) for x in xs]
    plain = sb.decoder_tail_plain(*xt, w, **kw)
    worst, moved, mean = _compare(_replay(*xt, w, **kw), plain, xt[4])
    assert worst <= 1.0 and moved < 0.02
    for variant in VARIANTS:
        _, moved_v, mean_v = _compare(
            _replay(*xt, w, variant=variant, **kw), plain, xt[4])
        assert moved_v > 0.1 and mean_v > 5 * mean, variant


@pytest.mark.parametrize("c,heads,kp", [(32, 2, 32), (96, 3, 32),
                                        (128, 4, 64), (192, 6, 64),
                                        (256, 8, 64), (256, 16, 64),
                                        (256, 4, 64)])
def test_plan_takes_bf16_and_fits_a_block(c, heads, kp):
    """At bf16 K4 runs the tensor-core body, one block of 16 warps an SM
    with a ring of 3 tiles of kp rows (64 where C allows), at head dims
    16, 32 and 64; its shared memory is tail_layout's and fits a block
    (232,448 bytes; 205,824 at C = 256), the f32 output sum fitting the two
    head tiles it takes over and sigma's panel the q/k/v panels."""
    plan = sb.tail_plan(49, c, heads, 4 * c, torch.bfloat16)
    assert (plan.body, plan.blocks_per_sm, plan.kp, plan.stages) == (
        "tc", 1, kp, 3)
    lay = sb.tail_layout(49, c, kp, 3)
    assert plan.smem_bytes == lay["total"] <= wb.MAX_SMEM_BYTES
    tile = 2 * 64 * (c + 8)
    assert (lay["xs"], lay["ob_h"], lay["vt"]) == (0, tile, 2 * tile)
    assert 4 * 49 * (c + 4) <= lay["vt"] - lay["xs"]
    assert lay["sig"] == lay["qkv"]
    assert 4 * 64 * 132 <= lay["ring"] - lay["qkv"]
    assert sum(wd for _, wd in plan.head_groups) == c
    if c == 256:
        assert plan.smem_bytes == 205824


def test_plan_leaves_f32_and_other_shapes_scalar():
    """f32, a head dim outside 16/32/64, C not a multiple of 32, a window
    over 64 tokens or an MLP width not a multiple of 128 keep the scalar
    body."""
    for args in ((49, 256, 8, 1024, torch.float32),
                 (49, 96, 12, 384, torch.bfloat16),
                 (49, 80, 5, 320, torch.bfloat16),
                 (81, 256, 8, 1024, torch.bfloat16),
                 (49, 256, 8, 960, torch.bfloat16)):
        assert sb.tail_plan(*args).body == "scalar"


@pytest.mark.parametrize("c,heads", [(32, 2), (192, 6), (256, 8)])
def test_schedule_streams_wv_once_per_stream_and_wp_twice(c, heads):
    """One block's tiles cover wv (both streams' columns) once, wp twice
    (sigma, then mu, panel by panel) and w1 and w2 once, every tile kp rows
    deep and at most a panel wide; the value panels come first, stream by
    stream, then proj, then the MLP in K1's order."""
    hidden = 4 * c
    plan = sb.tail_plan(49, c, heads, hidden, torch.bfloat16)
    shapes = {"wv": (c, 2 * c), "wp": (c, c), "w1": (c, hidden),
              "w2": (hidden, c)}
    count = {k: torch.zeros(s, dtype=torch.int32) for k, s in shapes.items()}
    sched = sb.tail_tile_schedule(plan, c, hidden)
    for name, r0, c0, nr, wd in sched:
        assert nr == plan.kp and 0 < wd <= plan.panel and wd % 32 == 0
        count[name][r0:r0 + nr, c0:c0 + wd] += 1
    want = {"wv": 1, "wp": 2, "w1": 1, "w2": 1}
    for k in count:
        assert (count[k] == want[k]).all(), k
    names = [t[0] for t in sched]
    nv = names.count("wv")
    assert names[:nv] == ["wv"] * nv
    assert names[nv:nv + names.count("wp")] == ["wp"] * names.count("wp")
    # stream 0's columns before stream 1's
    cols = [t[2] for t in sched[:nv]]
    assert max(cols[:nv // 2]) < c <= min(cols[nv // 2:])
    assert sched[nv + names.count("wp"):] == wb.mlp_tile_schedule(
        plan, c, hidden)
