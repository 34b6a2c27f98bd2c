"""K8's and K9's tensor-core bodies replayed in torch on the CPU: the
backward (csrc/attn_tc.cuh) from its plan (ops/window_attention.py:
attn_bwd_plan, attn_bwd_layout) and the order of its weight tiles
(attn_bwd_tile_schedule), with the weight-gradient product's row chunks
(ops/ln_mlp.py:weight_splits, wgrad_chunks) and the per-window partials
added in window order; and the forward (csrc/attn_fwd_tc.cuh) from
attn_fwd_plan, attn_fwd_layout and attn_fwd_tile_schedule (the second
half of the file).

The replay runs the body's algorithm on every window at once, on 64 rows
(the window's 49 tokens and 15 pad rows, zero in every input tile), head
group by head group, each projection summed in f32 from weight tiles taken
one by one from the schedule:

- the group's panels: NV 1 qs = round((q Wq + bq) scale), qc = round(q Wq
  + bq), k, v, dO = round(g Wp^T); NV 2 the two value streams and the two
  dO, q and k as they come, qs = round(q scale);
- per head: S = qs k^T + mask + bias on the real rows and keys, -inf on the
  pad keys, P = softmax(S) in f32; round(o_s) = round(round(P) v_s) to the
  o_t scratch; dP = sum_s dO_s v_s^T; dS = P (dP - rowsum(dP P)) with the
  f32 P (its f32 values the window's d-bias partial); dq = scale round(dS)
  k, dk = scale round(dS)^T qc, dv_s = round(P)^T dO_s, each rounded to its
  scratch, their f32 column sums over the real rows per m16 tile, the four
  tiles added in order;
- then dX = round(round(d{q,k,v}) W^T) through the transposes' 128-column
  panels, and the weight gradients over the row chunks.

At bfloat16 the replay must agree with the plain backward
(``window_attention_bwd_plain``, ``window_attention_dual_bwd_plain``: the
kernels' yardstick) within the card's tolerance -- two units in the last
place plus 2^-6 of the largest |grad| of the tensor (of all the bias grads
for a bias grad: the key bias's own is zero up to rounding) -- in both K9
forms (its own two value projections; one wv twice), with the shift mask
on and off, at C = 128 with 4 heads (one head group) and C = 256 with 8
(two); at float32 with JAX's VJP of
its custom-VJP kernels (interpret mode) within 1e-4 (relative max-abs); and
the same replay with a rounding point moved (P unrounded before P^T dO and
P v, dS unrounded before its products, or dS from round(P)) must move the
gradients well past that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu.ops import windows as jwin
from mastermetastyletransfer_tpu.ops.pallas_attention_vjp import (
    window_attention as jwindow_attention,
    window_attention_dual as jwindow_attention_dual,
)
from mastermetastyletransfer_tpu_torch.ops import ln_mlp as lm
from mastermetastyletransfer_tpu_torch.ops import window_attention as wa
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from tests.torch_threads import one_torch_thread  # noqa: F401

B, NW, N = 2, 4, 49
TOL_F32 = 1e-4
# The rounding points a planted variant moves: "p_f32" keeps P unrounded
# before P v and P^T dO, "ds_f32" dS unrounded before dS k and dS^T q,
# "ds_of_rounded_p" computes dS from round(P) instead of the f32 P.
VARIANTS = ("p_f32", "ds_f32", "ds_of_rounded_p")


def _in_order(parts):
    """Partials along dim 0 added in order."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _wgrad(pairs, dtype):
    """dW = sum over pairs of A^T B over weight_splits' row chunks, a
    chunk's products summed, the chunks' partials added in chunk order
    (csrc/grad_common.cuh)."""
    rows, i = pairs[0][0].shape
    splits = lm.weight_splits(rows, i, pairs[0][1].shape[1], dtype)
    parts = [sum(a[r0:r1].T @ b[r0:r1] for a, b in pairs)
             for r0, r1 in lm.wgrad_chunks(rows, splits)]
    return _in_order(parts)


def replay(nv, gs, q, k, vs, projs, bias, mask, heads, plan, variant=None):
    """The backward as the tensor-core body (plan), the weight-gradient
    product and the reductions compute it: what the plain backward of K8
    (nv 1: projs wq, wk, wv, wp) or K9 (nv 2: wvs, wvh, wp) returns.
    ``variant`` (one of VARIANTS) moves one rounding point."""
    t = q.dtype
    b, nw, n, c = q.shape
    nwin, rows, gw, kp = b * nw, plan.rows, plan.panel, plan.kp
    dh = c // heads
    scale = dh ** -0.5

    def rnd(v):
        return v.to(t).float()

    def tile(x):
        out = torch.zeros(nwin, rows, c)
        out[:, :n] = x.reshape(nwin, n, c).float()
        return out

    real = (torch.arange(rows) < n).float()[None, :, None]
    w = [rnd(p.w) for p in projs]
    vecs = [torch.zeros(c) if p.b is None else p.b.float() for p in projs]
    if nv == 1:
        mats = {"wq": w[0], "wk": w[1], "wv0": w[2], "wpt": w[3].T,
                "wqt": w[0].T, "wkt": w[1].T, "wv0t": w[2].T}
    else:
        mats = {"wv0": w[0], "wv1": w[1], "wpt": w[2].T, "wv0t": w[0].T,
                "wv1t": w[1].T}
    tiles = iter(wa.attn_bwd_tile_schedule(plan, c, nv))

    def gemm(a, name, col, width):
        acc = torch.zeros(nwin, rows, width)
        for k0 in range(0, c, kp):
            got = next(tiles)
            assert got == (name, k0, col, kp, width), (got, name, col)
            acc += a[:, :, k0:k0 + kp] @ mats[name][k0:k0 + kp,
                                                    col:col + width]
        return acc

    comb = bias.float()[None].expand(nw, heads, n, n)
    if mask is not None:
        comb = comb + mask[:, None]
    comb = comb.repeat(b, 1, 1, 1)                     # per window
    tg = [tile(x) for x in gs]
    tin = [tile(x) for x in ([q, k] + list(vs))]
    full = {name: torch.zeros(nwin, rows, c)
            for name in ["dq", "dk"] + [f"dv{s}" for s in range(nv)]
            + [f"o{s}" for s in range(nv)]}
    part_bias = torch.zeros(nwin, heads, n, n)
    for gi in range(c // gw):
        c0 = gi * gw
        cols = slice(c0, c0 + gw)
        if nv == 1:
            qf = gemm(tin[0], "wq", c0, gw) + vecs[0][cols]
            qs, qc = rnd(qf * scale), rnd(qf)
            kc = rnd(gemm(tin[1], "wk", c0, gw) + vecs[1][cols])
            vc = [rnd(gemm(tin[2], "wv0", c0, gw) + vecs[2][cols])]
            do = [rnd(gemm(tg[0], "wpt", c0, gw))]
        else:
            qc, kc = tin[0][..., cols], tin[1][..., cols]
            qs = rnd(qc * scale)
            vc = [rnd(gemm(tin[2 + s], f"wv{s}", c0, gw) + vecs[s][cols])
                  for s in range(2)]
            do = [rnd(gemm(tg[s], "wpt", c0, gw)) for s in range(2)]
        for hl in range(gw // dh):
            h, hc = c0 // dh + hl, slice(hl * dh, (hl + 1) * dh)
            add = torch.zeros(nwin, rows, rows)
            add[:, :n, :n] = comb[:, h]
            add[:, :, n:] = -torch.inf
            s_ = qs[..., hc] @ kc[..., hc].transpose(-1, -2) + add
            e = torch.exp(s_ - s_.amax(-1, keepdim=True))
            p = e / e.sum(-1, keepdim=True)
            pr = rnd(p)
            pv = p if variant == "p_f32" else pr
            out = (slice(None), slice(None), slice(c0 + hl * dh,
                                                   c0 + (hl + 1) * dh))
            for si in range(nv):
                full[f"o{si}"][out] = rnd(pv @ vc[si][..., hc])
            dp = sum(do[si][..., hc] @ vc[si][..., hc].transpose(-1, -2)
                     for si in range(nv))
            pp = pr if variant == "ds_of_rounded_p" else p
            ds = pp * (dp - (dp * pp).sum(-1, keepdim=True))
            part_bias[:, h] = ds[:, :n, :n]
            dsr = ds if variant == "ds_f32" else rnd(ds)
            full["dq"][out] = scale * (dsr @ kc[..., hc])
            full["dk"][out] = scale * (dsr.transpose(-1, -2) @ qc[..., hc])
            for si in range(nv):
                full[f"dv{si}"][out] = pv.transpose(-1, -2) @ do[si][..., hc]
    # The windows' column sums: per m16 tile over its real rows, the four
    # tiles in order; then the windows in order (reduce_parts).
    def colsum(x):
        return _in_order((x * real).reshape(nwin, 4, 16, c).sum(2)
                         .transpose(0, 1))

    def reduced(x):
        return _in_order(colsum(x))

    dbp = _in_order(sum((x * real).sum(1) for x in tg))
    dbias = _in_order(part_bias)
    # dX = round(round(d) W^T) through the transposes' 128-column panels.
    dnames = (["dq", "dk", "dv0"] if nv == 1 else ["dv0", "dv1"])
    xt = (["wqt", "wkt", "wv0t"] if nv == 1 else ["wv0t", "wv1t"])
    dx = {}
    for dn, mn in zip(dnames, xt):
        a = rnd(full[dn]) * real
        dx[dn] = torch.cat([rnd(gemm(a, mn, p0, min(128, c - p0)))
                            for p0 in range(0, c, 128)], -1)
    assert next(tiles, None) is None  # every tile used, in order

    def rows_of(x):
        return x[:, :n].reshape(b * nw * n, -1)

    def shaped(x):
        return x[:, :n].reshape(b, nw, n, c).to(t)

    xs_in = [q, k] + list(vs)
    if nv == 1:
        flat_in = [x.reshape(-1, c).float() for x in xs_in]
        dw = [_wgrad([(flat_in[i], rows_of(rnd(full[d])))], t)
              for i, d in enumerate(("dq", "dk", "dv0"))]
        dwp = _wgrad([(rows_of(full["o0"]), rows_of(tg[0]))], t)
        return (shaped(dx["dq"]), shaped(dx["dk"]), shaped(dx["dv0"]),
                dw[0], reduced(full["dq"]), dw[1], reduced(full["dk"]),
                dw[2], reduced(full["dv0"]), dwp, dbp, dbias)
    flat_v = [x.reshape(-1, c).float() for x in vs]
    dw = [_wgrad([(flat_v[s], rows_of(rnd(full[f"dv{s}"])))], t)
          for s in range(2)]
    dwp = _wgrad([(rows_of(full[f"o{s}"]), rows_of(tg[s]))
                  for s in range(2)], t)
    return (shaped(full["dq"]), shaped(full["dk"]), shaped(dx["dv0"]),
            shaped(dx["dv1"]), dw[0], reduced(full["dv0"]), dw[1],
            reduced(full["dv1"]), dwp, dbp, dbias)


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

def _draw(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _case(nv, c, heads, shifted, shared=False, seed=0):
    """numpy draws: the window inputs, the output gradients, the
    projections (kernel, bias) and the relative bias; the shift mask of a
    14 x 14 grid shifted by 3, or None."""
    rng = np.random.default_rng(seed + 10 * nv + c + shifted)
    xs = [_draw(rng, (B, NW, N, c), 0.5) for _ in range(2 + nv)]
    gs = [_draw(rng, (B, NW, N, c)) for _ in range(nv)]
    projs = [(_draw(rng, (c, c), c ** -0.5), _draw(rng, (c,), 0.1))
             for _ in range(4 if nv == 1 else 3)]
    if shared:
        projs[1] = projs[0]
    bias = _draw(rng, (heads, N, N), 0.1)
    mask = (jwin.shift_attention_mask(14, 14, 7, 7, 3, 3) if shifted
            else None)
    return xs, gs, projs, bias, mask


def _torch_case(case, dtype):
    xs, gs, projs, bias, mask = case
    return ([torch.from_numpy(x).to(dtype) for x in xs],
            [torch.from_numpy(g).to(dtype) for g in gs],
            [wa.Proj(torch.from_numpy(w), torch.from_numpy(b_))
             for w, b_ in projs],
            torch.from_numpy(bias),
            None if mask is None else torch.from_numpy(mask))


def _plain(nv, xs, gs, projs, bias, mask, heads):
    if nv == 1:
        return wa.window_attention_bwd_plain(gs[0], *xs, *projs, bias, mask,
                                             heads)
    return wa.window_attention_dual_bwd_plain(*gs, *xs, *projs, bias, mask,
                                              heads)


def _replay(nv, xs, gs, projs, bias, mask, heads, plan, variant=None):
    return replay(nv, gs, xs[0], xs[1], xs[2:], projs, bias, mask, heads,
                  plan, variant)


def _plan(nv, c, heads):
    plan = wa.attn_bwd_plan(N, c, heads, nv, torch.bfloat16)
    assert plan.body == "tc"
    return plan


def _names(nv):
    if nv == 1:
        return ["dq", "dk", "dv", "dwq", "bq", "dwk", "bk", "dwv", "bv",
                "dwp", "bp", "dbias"]
    return ["dq", "dk", "dvs", "dvh", "dwvs", "bvs", "dwvh", "bvh", "dwp",
            "bp", "dbias"]


def _card_errors(nv, got, ref):
    """Per gradient (largest error / the card's tolerance, share of
    elements that differ, mean |error|): two units in the last place of
    bf16 plus 2^-6 of the largest |grad| (of every bias grad for a bias
    grad)."""
    names = _names(nv)
    vec = max(r.float().abs().max().item() for nm, r in zip(names, ref)
              if nm.startswith("b"))
    out = {}
    for nm, a, r in zip(names, got, ref):
        a, r = a.float(), r.float()
        scale = vec if nm.startswith("b") else r.abs().max().item()
        ulp = torch.exp2((torch.frexp(r)[1] - 8).float())
        tol = 2 * torch.where(r == 0, 0.0, ulp) + 2.0 ** -6 * scale
        err = (a - r).abs()
        out[nm] = ((err / tol).max().item(), (err > 0).float().mean().item(),
                   err.mean().item())
    return out


BF16_CASES = ([(1, False, 128, 4, s) for s in (True, False)]
              + [(2, sh, 128, 4, s) for sh in (False, True)
                 for s in (True, False)]
              + [(1, False, 256, 8, True), (2, False, 256, 8, True),
                 (2, True, 256, 8, False)])


@pytest.mark.parametrize("nv,shared,c,heads,shifted", BF16_CASES)
def test_replay_matches_plain_at_bf16(nv, shared, c, heads, shifted):
    """bfloat16: K8's backward (nv 1) and K9's in both forms (shared: one
    wv for both streams, the style encoder's Scale/Shift pair), mask on and
    off, C = 128 (one head group) and 256 (two): every gradient within the
    card's tolerance of the plain backward's."""
    args = _torch_case(_case(nv, c, heads, shifted, shared), torch.bfloat16)
    got = _replay(nv, *args, heads, _plan(nv, c, heads))
    ref = _plain(nv, *args, heads)
    errs = _card_errors(nv, got, ref)
    assert max(e[0] for e in errs.values()) <= 1.0, errs


def _jax_params(nv, projs):
    names = ("wq", "wk", "wv", "proj") if nv == 1 else ("wv_scale",
                                                         "wv_shift", "proj")
    params = {nm: {"kernel": jnp.asarray(w), "bias": jnp.asarray(b_)}
              for nm, (w, b_) in zip(names, projs)}
    # the table the bias is gathered from, outside the kernel (unused here)
    params["rel_bias_table"] = jnp.zeros((13 * 13, 8))
    return params, names


def _rel(got, want, scale=None) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    den = np.abs(want).max() if scale is None else scale
    return float(np.abs(got - want).max() / den)


@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("c,heads", [(128, 4), (256, 8)])
def test_replay_matches_plain_and_jax_at_f32(nv, c, heads):
    """float32, C = 128 and 256, shift mask on: the replay within 1e-4 of
    the plain backward and of JAX's VJP of window_attention (nv 1) or
    window_attention_dual (nv 2) in interpret mode. The key bias's
    gradient is zero up to rounding, so it is held to 1e-4 of the largest
    bias gradient."""
    case = _case(nv, c, heads, True, seed=3)
    xs, gs, projs, bias, mask = case
    args = _torch_case(case, torch.float32)
    got = _replay(nv, *args, heads, _plan(nv, c, heads))
    ref = _plain(nv, *args, heads)
    names = _names(nv)
    vec = max(np.abs(r.numpy()).max() for nm, r in zip(names, ref)
              if nm.startswith("b"))
    for nm, a, r in zip(names, got, ref):
        assert _rel(a, r.numpy(), vec if nm == "bk" else None) <= TOL_F32, nm

    pj, pnames = _jax_params(nv, projs)
    mask_key = (mask.shape, tuple(mask.ravel().tolist()))
    jxs = [jnp.asarray(x) for x in xs]
    if nv == 1:
        _, vjp = jax.vjp(lambda p, q_, k_, v_, b_: jwindow_attention(
            p, q_, k_, v_, b_, mask_key, heads, True), pj, *jxs,
            jnp.asarray(bias))
        dp, dq, dk, dv, db = vjp(jnp.asarray(gs[0]))
        want = [dq, dk, dv]
    else:
        _, vjp = jax.vjp(lambda p, q_, k_, vs_, vh_, b_: jwindow_attention_dual(
            p, q_, k_, vs_, vh_, b_, mask_key, heads, True), pj, *jxs,
            jnp.asarray(bias))
        dp, dq, dk, dvs, dvh, db = vjp(tuple(jnp.asarray(g) for g in gs))
        want = [dq, dk, dvs, dvh]
    for nm in pnames:
        want += [dp[nm]["kernel"], dp[nm]["bias"]]
    want.append(db)
    for nm, a, wnt in zip(names, got, want):
        assert _rel(a, wnt, vec if nm == "bk" else None) <= TOL_F32, nm


@pytest.mark.parametrize("nv", [1, 2])
def test_replay_tells_the_rounding_points_apart(nv):
    """bfloat16 at C = 128, 4 heads: the replay is within the card's
    tolerance of the plain backward, its input gradients equal but for a
    few elements (under 1%) that a sum in another order moved by a unit;
    each planted variant -- P unrounded before P v and P^T dO, dS unrounded
    before its products, dS from round(P) -- moves over 30% of an input
    gradient's elements and its mean error over 100 times the replay's
    own. (An error of one rounding of P or dS stays within the tolerance's
    2^-6 of the largest gradient: the shares and means tell it.)"""
    c, heads = 128, 4
    args = _torch_case(_case(nv, c, heads, True, seed=5), torch.bfloat16)
    plan = _plan(nv, c, heads)
    ref = _plain(nv, *args, heads)
    base = _card_errors(nv, _replay(nv, *args, heads, plan), ref)
    assert max(e[0] for e in base.values()) <= 1.0, base
    inputs = _names(nv)[:2 + nv]
    assert max(base[k][1] for k in inputs) < 0.01, base
    for variant in VARIANTS:
        errs = _card_errors(nv, _replay(nv, *args, heads, plan, variant),
                            ref)
        assert any(errs[k][1] > 0.3 and errs[k][2] > 100 * base[k][2]
                   for k in inputs), (variant, errs)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

# The training step's attention shapes: the style transformer (8 contents,
# 25 windows, C 256, 8 heads), the Swin's stage 2 (16 images, 25 windows,
# C 256, 8 heads) and stage 1 (16 images, 100 windows, C 128, 4 heads).
TRAIN_SHAPES = ((256, 8), (256, 8), (128, 4))


@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("c,heads", sorted(set(TRAIN_SHAPES)))
def test_plan_takes_the_training_shapes(nv, c, heads):
    """Every training shape at bf16 takes the tensor-core body in
    ATTN_BWD_FORM, its shared memory attn_bwd_layout's and within a block's
    232,448 bytes: 201,728 (NV 1) and 217,088 (NV 2), the same at C = 128
    and 256 (the panels are a head group's)."""
    plan = wa.attn_bwd_plan(N, c, heads, nv, torch.bfloat16)
    per_sm, gw, kp, stages = wa.ATTN_BWD_FORM
    assert (plan.body, plan.blocks_per_sm, plan.panel, plan.kp,
            plan.stages, plan.rows, plan.dx) == (
        "tc", per_sm, gw, kp, stages, 64, "scratch")
    lay = wa.attn_bwd_layout(c, gw, kp, stages, nv)
    assert plan.smem_bytes == lay["total"] <= min(
        wb.MAX_SMEM_BYTES, wb.SMEM_PER_SM // per_sm - 1024)
    assert plan.smem_bytes == (201728 if nv == 1 else 217088)
    assert lay["u"] - lay["panels"] == (5 if nv == 1 else 6) * 2 * 64 * (
        gw + 8)
    assert wa.smem_bytes(N, c, heads, torch.bfloat16, nv, True) == \
        plan.smem_bytes
    # a third ring tile of 64 rows does not fit beside NV 2's panels
    assert wa.attn_bwd_layout(256, gw, kp, 3, 2)["total"] > \
        wb.MAX_SMEM_BYTES


def test_plan_leaves_f32_and_other_shapes_scalar():
    """f32, a head dim other than 32, N over 64 or a C that the head group
    does not divide keep the scalar body."""
    for args in ((49, 256, 8, torch.float32), (49, 256, 4, torch.bfloat16),
                 (49, 256, 16, torch.bfloat16), (81, 256, 8, torch.bfloat16),
                 (49, 96, 3, torch.bfloat16), (49, 192, 6, torch.bfloat16),
                 (49, 64, 2, torch.bfloat16)):
        for nv in (1, 2):
            assert wa.attn_bwd_plan(args[0], args[1], args[2], nv,
                                    args[3]).body == "scalar", args


@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("c", [128, 256, 384])
def test_schedule_covers_each_matrix_once_per_use(nv, c):
    """The schedule streams each projection's matrix once per head group
    over its columns (wpt once per stream at NV 2) and each transpose once
    for dX, every tile kp rows deep and at most 128 wide, group by group."""
    plan = _plan(nv, c, c // 32)
    uses = ({"wq": 1, "wk": 1, "wv0": 1, "wpt": 1, "wqt": 1, "wkt": 1,
             "wv0t": 1} if nv == 1
            else {"wv0": 1, "wv1": 1, "wpt": 2, "wv0t": 1, "wv1t": 1})
    count = {m: torch.zeros(c, c, dtype=torch.int32) for m in uses}
    sched = wa.attn_bwd_tile_schedule(plan, c, nv)
    for m, r0, c0, nr, wd in sched:
        assert nr == plan.kp and 0 < wd <= 128
        count[m][r0:r0 + nr, c0:c0 + wd] += 1
    for m, n_uses in uses.items():
        assert (count[m] == n_uses).all(), m
    per_group = 4 * (c // plan.kp)
    for gi in range(c // plan.panel):
        assert {s[2] for s in sched[gi * per_group:(gi + 1) * per_group]} \
            == {gi * plan.panel}


# ---------------------------------------------------------------------------
# The forward body (csrc/attn_fwd_tc.cuh)
# ---------------------------------------------------------------------------
#
# Replayed on every window at once on 64 rows, head group by head group,
# each projection summed in f32 from weight tiles taken one by one from
# attn_fwd_tile_schedule: NV 1 the group's q, k and v panels (q = round((x
# Wq + bq) scale), k and v rounded after their bias); NV 2 q scaled and
# rounded, k as it comes, each value stream's panel rounded; per head S =
# qs k^T + mask + bias on the real rows and keys, -inf on the pad keys, e =
# exp(S - max), the head output round((round(e) v) / sum e); then per
# stream out = round(heads Wp + bp) through wp's 128-column panels. At
# bfloat16 it must agree with the plain forward within the card's
# tolerance, at float32 with JAX's kernels in interpret mode within 1e-4;
# and a rounding point moved ("e_f32": the numerators unrounded; "q_scale":
# NV 1's q rounded before its scale, NV 2's q scale left unrounded; "o_f32":
# the head outputs unrounded) must move the output well past the replay's
# own error.
FWD_VARIANTS = ("e_f32", "q_scale", "o_f32")


def replay_fwd(nv, q, k, vs, projs, bias, mask, heads, plan, variant=None):
    """The forward as the tensor-core body (plan) computes it: what
    ``window_attention_plain`` (nv 1: projs wq, wk, wv, wp) or
    ``window_attention_dual_plain`` (nv 2: wvs, wvh, wp) returns.
    ``variant`` (one of FWD_VARIANTS) moves one rounding point."""
    t = q.dtype
    b, nw, n, c = q.shape
    nwin, rows, gw, kp = b * nw, plan.rows, plan.panel, plan.kp
    dh = c // heads
    scale = dh ** -0.5

    def rnd(v):
        return v.to(t).float()

    def tile(x):
        out = torch.zeros(nwin, rows, c)
        out[:, :n] = x.reshape(nwin, n, c).float()
        return out

    w = [rnd(p.w) for p in projs]
    vecs = [torch.zeros(c) if p.b is None else p.b.float() for p in projs]
    mats = ({"wq": w[0], "wk": w[1], "wv0": w[2], "wp": w[3]} if nv == 1
            else {"wv0": w[0], "wv1": w[1], "wp": w[2]})
    tiles = iter(wa.attn_fwd_tile_schedule(plan, c, nv))

    def gemm(a, name, col, width):
        acc = torch.zeros(nwin, rows, width)
        for k0 in range(0, c, kp):
            got = next(tiles)
            assert got == (name, k0, col, kp, width), (got, name, col)
            acc += a[:, :, k0:k0 + kp] @ mats[name][k0:k0 + kp,
                                                    col:col + width]
        return acc

    comb = bias.float()[None].expand(nw, heads, n, n)
    if mask is not None:
        comb = comb + mask[:, None]
    comb = comb.repeat(b, 1, 1, 1)                     # per window
    tin = [tile(x) for x in ([q, k] + list(vs))]
    ob = [torch.zeros(nwin, rows, c) for _ in range(nv)]
    for gi in range(c // gw):
        c0 = gi * gw
        cols = slice(c0, c0 + gw)
        if nv == 1:
            qf = gemm(tin[0], "wq", c0, gw) + vecs[0][cols]
            qs = rnd(rnd(qf) * scale) if variant == "q_scale" else rnd(
                qf * scale)
            kc = rnd(gemm(tin[1], "wk", c0, gw) + vecs[1][cols])
            vc = [rnd(gemm(tin[2], "wv0", c0, gw) + vecs[2][cols])]
        else:
            qs = tin[0][..., cols] * scale
            qs = qs if variant == "q_scale" else rnd(qs)
            kc = tin[1][..., cols]
            vc = [rnd(gemm(tin[2 + s_], f"wv{s_}", c0, gw) + vecs[s_][cols])
                  for s_ in range(2)]
        for hl in range(gw // dh):
            h, hc = c0 // dh + hl, slice(hl * dh, (hl + 1) * dh)
            add = torch.zeros(nwin, rows, rows)
            add[:, :n, :n] = comb[:, h]
            add[:, :, n:] = -torch.inf
            s_ = qs[..., hc] @ kc[..., hc].transpose(-1, -2) + add
            e = torch.exp(s_ - s_.amax(-1, keepdim=True))
            recip = 1.0 / e.sum(-1, keepdim=True)
            er = e if variant == "e_f32" else rnd(e)
            for si in range(nv):
                o = (er @ vc[si][..., hc]) * recip
                ob[si][..., c0 + hl * dh:c0 + (hl + 1) * dh] = (
                    o if variant == "o_f32" else rnd(o))
    outs = [torch.cat([rnd(gemm(ob[si], "wp", p0, 128)
                           + vecs[-1][p0:p0 + 128])
                       for p0 in range(0, c, 128)], -1)
            for si in range(nv)]
    assert next(tiles, None) is None  # every tile used, in order
    return tuple(o[:, :n].reshape(b, nw, n, c).to(t) for o in outs)


def _fwd_case(nv, c, heads, shifted, shared=False, seed=0):
    """numpy draws of a forward call (``_case``'s, without the output
    gradients)."""
    xs, _, projs, bias, mask = _case(nv, c, heads, shifted, shared, seed)
    return xs, projs, bias, mask


def _fwd_torch(case, dtype):
    xs, projs, bias, mask = case
    args = _torch_case((xs, [], projs, bias, mask), dtype)
    return args[0], args[2], args[3], args[4]


def _fwd_plain(nv, xs, projs, bias, mask, heads):
    if nv == 1:
        return (wa.window_attention_plain(*xs, *projs, bias, mask, heads),)
    return wa.window_attention_dual_plain(*xs, *projs, bias, mask, heads)


def _fwd_replay(nv, xs, projs, bias, mask, heads, plan, variant=None):
    return replay_fwd(nv, xs[0], xs[1], xs[2:], projs, bias, mask, heads,
                      plan, variant)


def _fwd_plan(nv, c, heads):
    plan = wa.attn_fwd_plan(N, c, heads, nv, torch.bfloat16)
    assert plan.body == "tc"
    return plan


def _fwd_card_errors(got, ref):
    """Per output (largest error / the card's tolerance -- two units in the
    last place plus 2^-6 of the output's largest |value| --, share of
    elements that differ, mean |error|)."""
    out = []
    for a, r in zip(got, ref):
        a, r = a.float(), r.float()
        ulp = torch.exp2((torch.frexp(r)[1] - 8).float())
        tol = 2 * torch.where(r == 0, 0.0, ulp) + 2.0 ** -6 * r.abs().max()
        err = (a - r).abs()
        out.append(((err / tol).max().item(), (err > 0).float().mean().item(),
                    err.mean().item()))
    return out


FWD_BF16_CASES = ([(1, False, c, c // 32, s) for c in (128, 256)
                   for s in (True, False)]
                  + [(2, sh, 256, 8, s) for sh in (False, True)
                     for s in (True, False)])


@pytest.mark.parametrize("nv,shared,c,heads,shifted", FWD_BF16_CASES)
def test_fwd_replay_matches_plain_at_bf16(nv, shared, c, heads, shifted):
    """bfloat16: K8's forward at C = 128 with 4 heads (the Swin's stage 1,
    one head group) and 256 with 8 (stage 2 and the style transformer, two
    groups), K9's at 256 in both forms (shared: one wv for both streams),
    the shift mask on and off: every output within the card's tolerance of
    the plain forward's."""
    args = _fwd_torch(_fwd_case(nv, c, heads, shifted, shared),
                      torch.bfloat16)
    got = _fwd_replay(nv, *args, heads, _fwd_plan(nv, c, heads))
    errs = _fwd_card_errors(got, _fwd_plain(nv, *args, heads))
    assert max(e[0] for e in errs) <= 1.0, errs


@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("c,heads", [(128, 4), (256, 8)])
def test_fwd_replay_matches_plain_and_jax_at_f32(nv, c, heads):
    """float32, C = 128 and 256, shift mask on: the replay within 1e-4
    (relative max-abs) of the plain forward and of JAX's window_attention
    (nv 1) or window_attention_dual (nv 2) kernel in interpret mode."""
    case = _fwd_case(nv, c, heads, True, seed=3)
    xs, projs, bias, mask = case
    args = _fwd_torch(case, torch.float32)
    got = _fwd_replay(nv, *args, heads, _fwd_plan(nv, c, heads))
    for a, r in zip(got, _fwd_plain(nv, *args, heads)):
        assert _rel(a, r.numpy()) <= TOL_F32
    pj, _ = _jax_params(nv, projs)
    mask_key = (mask.shape, tuple(mask.ravel().tolist()))
    jxs = [jnp.asarray(x) for x in xs]
    want = (jwindow_attention if nv == 1 else jwindow_attention_dual)(
        pj, *jxs, jnp.asarray(bias), mask_key, heads, True)
    for a, w in zip(got, want if nv == 2 else (want,)):
        assert _rel(a, w) <= TOL_F32


@pytest.mark.parametrize("nv", [1, 2])
def test_fwd_replay_tells_the_rounding_points_apart(nv):
    """bfloat16 at C = 128 (K8) or 256 (K9): the replay is within the
    card's tolerance of the plain forward and equal to it but for a few
    elements (under 1%) that a sum in another order moved by a unit; each
    planted variant -- the numerators unrounded, q's rounding moved, the
    head outputs unrounded -- changes over 30% of an output's elements and
    its mean error over 100 times the replay's own (each stays within the
    card's tolerance: the shares and means tell it)."""
    c = 128 if nv == 1 else 256
    heads = c // 32
    args = _fwd_torch(_fwd_case(nv, c, heads, True, seed=5), torch.bfloat16)
    plan = _fwd_plan(nv, c, heads)
    ref = _fwd_plain(nv, *args, heads)
    base = _fwd_card_errors(_fwd_replay(nv, *args, heads, plan), ref)
    assert max(e[0] for e in base) <= 1.0 and max(e[1] for e in base) < 0.01
    for variant in FWD_VARIANTS:
        errs = _fwd_card_errors(
            _fwd_replay(nv, *args, heads, plan, variant), ref)
        assert any(e[1] > 0.3 and e[2] > 100 * b_[2]
                   for e, b_ in zip(errs, base)), (variant, errs, base)


@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("c,heads", sorted(set(TRAIN_SHAPES)))
def test_fwd_plan_takes_the_training_shapes(nv, c, heads):
    """Every training shape at bf16 takes the tensor-core forward: K8 at C
    = 128 in two blocks of 8 warps an SM (104,448 bytes, within half an
    SM), K8 at 256 and K9 in one block of 16 warps (154,624 and 188,416
    bytes); the shared memory attn_fwd_layout's and the form the first of
    ATTN_FWD_FORMS that fits."""
    plan = wa.attn_fwd_plan(N, c, heads, nv, torch.bfloat16)
    assert (plan.body, plan.rows, plan.panel) == ("tc", 64, 128)
    fits = [f for f in wa.ATTN_FWD_FORMS
            if wa.attn_fwd_layout(c, nv, f[1], f[2])["total"]
            <= min(wb.MAX_SMEM_BYTES, wb.SMEM_PER_SM // f[0] - 1024)]
    assert (plan.blocks_per_sm, plan.kp, plan.stages) == fits[0]
    assert plan.smem_bytes == wa.attn_fwd_layout(c, nv, plan.kp,
                                                 plan.stages)["total"]
    assert wa.smem_bytes(N, c, heads, torch.bfloat16, nv, False) == \
        plan.smem_bytes
    want = {(1, 128): (2, 104448), (1, 256): (1, 154624),
            (2, 128): (1, 139264), (2, 256): (1, 188416)}[nv, c]
    assert (plan.blocks_per_sm, plan.smem_bytes) == want


def test_fwd_plan_leaves_f32_and_other_shapes_scalar():
    """f32, a head dim other than 32, N over 64 or a C that is no multiple
    of the 128-column head group keep the scalar forward."""
    for args in ((49, 256, 8, torch.float32), (49, 128, 4, torch.float32),
                 (49, 256, 4, torch.bfloat16), (49, 256, 16, torch.bfloat16),
                 (81, 256, 8, torch.bfloat16), (49, 96, 3, torch.bfloat16),
                 (49, 192, 6, torch.bfloat16), (49, 64, 2, torch.bfloat16)):
        for nv in (1, 2):
            assert wa.attn_fwd_plan(args[0], args[1], args[2], nv,
                                    args[3]).body == "scalar", args


@pytest.mark.parametrize("nv,c", [(1, 128), (1, 256), (1, 384), (2, 128),
                                  (2, 256)])
def test_fwd_schedule_covers_each_matrix_once_per_use(nv, c):
    """The forward's schedule streams each projection's matrix once over
    its columns, group by group, and wp once per value stream, every tile
    kp rows deep and 128 wide (K9's two head-output tiles at C = 384 no
    longer fit: the scalar body)."""
    plan = _fwd_plan(nv, c, c // 32)
    uses = ({"wq": 1, "wk": 1, "wv0": 1, "wp": 1} if nv == 1
            else {"wv0": 1, "wv1": 1, "wp": 2})
    count = {m: torch.zeros(c, c, dtype=torch.int32) for m in uses}
    sched = wa.attn_fwd_tile_schedule(plan, c, nv)
    for m, r0, c0, nr, wd in sched:
        assert nr == plan.kp and wd == 128
        count[m][r0:r0 + nr, c0:c0 + wd] += 1
    for m, n_uses in uses.items():
        assert (count[m] == n_uses).all(), m
    per_group = (3 if nv == 1 else 2) * (c // plan.kp)
    for gi in range(c // plan.panel):
        part = sched[gi * per_group:(gi + 1) * per_group]
        assert {s_[2] for s_ in part} == {gi * plan.panel}
        assert all(s_[0] != "wp" for s_ in part)
