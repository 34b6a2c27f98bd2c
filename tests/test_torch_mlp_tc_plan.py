"""K10's tensor-core bodies (csrc/mlp_tc.cuh) and the weight-gradient
product (csrc/grad_common.cuh) replayed in torch on the CPU from their plan
(ops/ln_mlp.py:mlp_plan, mlp_layout), the order of their weight tiles
(mlp_tile_schedule, mlp_bwd_tile_schedule) and the product's row chunks
(weight_splits, wgrad_chunks).

The replay runs the kernels' algorithm on every 64-row tile of the
flattened (rows, C) (the tiles side by side, the last one ragged: its pad
rows zero in every A tile, never stored nor summed), each product summed
in f32 from weight tiles taken one by one from the schedule:

- forward: LN (or the raw x) rounded as the MLP input, the f32 sum x + b2;
  per 128-wide hidden chunk, fc1's panel and round(GELU(a + b1)), then
  fc2's panels into the sum; out = round(sum);
- backward: h = round(LN(x)) (or x) and round(g); per chunk, a = h W1 + b1,
  z = round(GELU(a)) for dW2, dz = round(g) W2^T, da = dz GELU'(a) in f32
  (db1's per-tile column sum), round(da) for dW1 and dh += round(da) W1^T;
  then the per-tile column sums of g (db2), dh xhat and dh (the LN
  grads), the LN backward and dx = round(g + LN^T(dh)); the per-tile
  partials added in tile order; dW1 = h^T round(da) and dW2 = round(z)^T g
  over weight_splits' row chunks, their partials added in chunk order.

At float32 the replay must agree within 1e-4 (relative max-abs) with the
plain versions (the kernels' yardstick) and with the JAX package's K10
(``fused_ln_mlp_residual``) and the VJP of its ``ln_mlp_residual``, in
Pallas interpret mode; at bfloat16 with the plain versions within the
card's tolerance (two units in the last place plus 2^-6 of the largest
update |out - x| or of the largest |grad|), while the same replay with a
rounding point moved -- da kept in f32 before dh, or z unrounded for dW2 --
must move a clear share of dx or a clear part of dW2. Cases: C = 32 with
hidden 128 and C = 256 with hidden 1024 (the style transformer's), LN on
and off, 134 rows (two full tiles and one of 6 rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mastermetastyletransfer_tpu.ops.pallas_mlp import fused_ln_mlp_residual
from mastermetastyletransfer_tpu.ops.pallas_mlp_vjp import (
    ln_mlp_residual as jln_mlp_residual,
)
from mastermetastyletransfer_tpu_torch.ops import ln_mlp as lm
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
ROWS = 134
# The rounding points a planted variant moves: "da_f32" keeps da in f32 as
# dh's operand, "z_f32" keeps z unrounded as dW2's.
VARIANTS = ("da_f32", "z_f32")
_INV_SQRT2PI = (2 * np.pi) ** -0.5


def _tiles(v: torch.Tensor, plan) -> torch.Tensor:
    """(rows, n) -> (tiles, 64, n) in f32, pad rows zero."""
    out = torch.zeros(plan.tiles * plan.rows, v.shape[-1])
    out[:v.shape[0]] = v.float()
    return out.reshape(plan.tiles, plan.rows, -1)


def _valid(rows: int, plan) -> torch.Tensor:
    return (torch.arange(plan.tiles * plan.rows) < rows).float().reshape(
        plan.tiles, plan.rows, 1)


def _gemm_from(tiles, mats, kp):
    """The 64-row panel product over the next tiles of the schedule."""
    def gemm(a, depth, width):
        acc = torch.zeros(a.shape[0], a.shape[1], width)
        for k0 in range(0, depth, kp):
            name, r0, c0, nr, wd = next(tiles)
            assert (nr, wd) == (kp, width)
            acc += a[:, :, k0:k0 + kp] @ mats[name][r0:r0 + kp, c0:c0 + wd]
        return acc
    return gemm


def _stats(xt):
    mean = xt.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xt - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    return mean, rstd


def _panels(c, p):
    return [(p0, min(p, c - p0)) for p0 in range(0, c, p)]


def replay_forward(x, w1, b1, w2, b2, ns=None, nb=None):
    """K10's forward as its tensor-core blocks compute it from the plan."""
    t = x.dtype
    c, hidden = w1.shape
    x2 = x.reshape(-1, c)
    rows = x2.shape[0]
    plan = lm.mlp_plan(rows, c, hidden, False, torch.bfloat16)
    assert plan.body == "tc"

    def rnd(v):
        return v.to(t).float()

    tiles = iter(lm.mlp_tile_schedule(plan, c, hidden))
    gemm = _gemm_from(tiles, {"w1": rnd(w1), "w2": rnd(w2)}, plan.kp)
    xt, valid = _tiles(x2, plan), _valid(rows, plan)
    h = xt
    if ns is not None:
        mean, rstd = _stats(xt)
        h = (xt - mean) * rstd * ns + nb
    h = rnd(h) * valid
    acc = xt + b2
    p = plan.panel
    for j in range(hidden // p):
        hid = rnd(F.gelu(gemm(h, c, p) + b1[j * p:(j + 1) * p]))
        for p0, width in _panels(c, p):
            acc[..., p0:p0 + width] += gemm(hid, p, width)
    assert next(tiles, None) is None  # every tile used, in order
    return acc.reshape(-1, c)[:rows].to(t).reshape(x.shape)


def replay_wgrad(a, b, dtype):
    """dW = A^T B over weight_splits' row chunks, their partials added in
    chunk order (csrc/grad_common.cuh, reduce_parts)."""
    rows, i = a.shape
    splits = lm.weight_splits(rows, i, b.shape[1], dtype)
    parts = [a[r0:r1].T @ b[r0:r1]
             for r0, r1 in lm.wgrad_chunks(rows, splits)]
    assert sum(r1 - r0 for r0, r1 in lm.wgrad_chunks(rows, splits)) == rows
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _in_order(parts):
    """Per-tile partials (tiles, n) added in tile order."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def replay_backward(g, x, w1, b1, w2, ns=None, nb=None, variant=None):
    """K10's backward as its tensor-core blocks, the weight-gradient
    product and the reductions compute it from the plan: what
    ``ln_mlp_residual_bwd_plain`` returns. ``variant`` (one of VARIANTS)
    moves one rounding point."""
    t = x.dtype
    c, hidden = w1.shape
    x2 = x.reshape(-1, c)
    rows = x2.shape[0]
    plan = lm.mlp_plan(rows, c, hidden, True, torch.bfloat16)
    assert plan.body == "tc"

    def rnd(v):
        return v.to(t).float()

    tiles = iter(lm.mlp_bwd_tile_schedule(plan, c, hidden))
    w1r = rnd(w1)
    gemm = _gemm_from(tiles, {"w1": w1r, "w2t": rnd(w2).T, "w1t": w1r.T},
                      plan.kp)
    xt, valid = _tiles(x2, plan), _valid(rows, plan)
    gt = rnd(_tiles(g.reshape(-1, c), plan))
    h = xt
    if ns is not None:
        mean, rstd = _stats(xt)
        xhat = (xt - mean) * rstd
        h = xhat * ns + nb
    h = rnd(h) * valid
    dh = torch.zeros_like(xt)
    p = plan.panel
    z_t = torch.zeros(plan.tiles, plan.rows, hidden)
    da_t = torch.zeros_like(z_t)
    db1 = torch.zeros(plan.tiles, hidden)
    for j in range(hidden // p):
        cols = slice(j * p, (j + 1) * p)
        a = gemm(h, c, p) + b1[cols]
        phi = 0.5 * (1.0 + torch.erf(a * 0.5 ** 0.5))
        z = a * phi
        z_t[..., cols] = z if variant == "z_f32" else rnd(z)
        da = gemm(gt, c, p) * (phi + a * _INV_SQRT2PI
                               * torch.exp(-0.5 * a * a))
        db1[:, cols] = (da * valid).sum(1)
        da_t[..., cols] = rnd(da)
        dat = da if variant == "da_f32" else rnd(da)
        for p0, width in _panels(c, p):
            dh[..., p0:p0 + width] += gemm(dat, p, width)
    assert next(tiles, None) is None  # every tile used, in order
    dns = dnb = None
    if ns is not None:
        dns = _in_order((dh * xhat * valid).sum(1))
        dnb = _in_order((dh * valid).sum(1))
        dhat = dh * ns
        m1 = dhat.mean(-1, keepdim=True)
        m2 = (dhat * xhat).mean(-1, keepdim=True)
        dx = gt + rstd * (dhat - m1 - xhat * m2)
    else:
        dx = gt + dh
    flat = [v.reshape(-1, v.shape[-1])[:rows] for v in (h, z_t, da_t, gt)]
    dw1 = replay_wgrad(flat[0], flat[2], t)
    dw2 = replay_wgrad(flat[1], flat[3], t)
    return (dx.reshape(-1, c)[:rows].to(t).reshape(x.shape), dw1,
            _in_order(db1), dw2, _in_order((gt * valid).sum(1)), dns, dnb)


def _case(c, use_norm, seed=0):
    """numpy draws: x, g (ROWS, C), the MLP's weights and the norm."""
    rng = np.random.default_rng(seed + c + use_norm)
    hidden = 4 * c

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    w = dict(w1=draw((c, hidden), c ** -0.5), b1=draw(hidden, 0.1),
             w2=draw((hidden, c), hidden ** -0.5), b2=draw(c, 0.1))
    norm = (dict(ns=1.0 + draw(c, 0.2), nb=draw(c, 0.2)) if use_norm
            else dict(ns=None, nb=None))
    return draw((ROWS, c), 1.0), draw((ROWS, c), 1.0), w, norm


def _torch(d):
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in d.items()}


def _rel(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


CASES = [(c, use_norm) for c in (32, 256) for use_norm in (True, False)]


@pytest.mark.parametrize("c,use_norm", CASES)
def test_replay_matches_plain_and_jax(c, use_norm):
    """float32: the forward and backward replays against the plain
    versions and against JAX's K10 and the VJP of its custom-VJP kernel
    (interpret mode)."""
    xn, gn, wn, normn = _case(c, use_norm)
    x, g, w, norm = (torch.from_numpy(xn), torch.from_numpy(gn), _torch(wn),
                     _torch(normn))
    got_out = replay_forward(x, **w, **norm)
    got = replay_backward(g, x, w["w1"], w["b1"], w["w2"], **norm)
    plain_out = lm.ln_mlp_residual_plain(x, **w, **norm)
    plain = lm.ln_mlp_residual_bwd_plain(g, x, w["w1"], w["b1"], w["w2"],
                                         **norm)
    assert _rel(got_out, plain_out.numpy()) <= TOL
    for a, b in zip(got, plain):
        if b is not None:
            assert _rel(a, b.numpy()) <= TOL

    mlp = {"fc1": {"kernel": jnp.asarray(wn["w1"]),
                   "bias": jnp.asarray(wn["b1"])},
           "fc2": {"kernel": jnp.asarray(wn["w2"]),
                   "bias": jnp.asarray(wn["b2"])}}
    nj = (None if not use_norm else {"scale": jnp.asarray(normn["ns"]),
                                     "bias": jnp.asarray(normn["nb"])})
    want_out = fused_ln_mlp_residual(jnp.asarray(xn), mlp, nj,
                                     interpret=True)
    assert _rel(got_out, want_out) <= TOL
    _, vjp = jax.vjp(lambda x_, m_, n_: jln_mlp_residual(x_, m_, n_, 1e-5,
                                                         True),
                     jnp.asarray(xn), mlp, nj)
    dx, dm, dn = vjp(jnp.asarray(gn))
    want = [dx, dm["fc1"]["kernel"], dm["fc1"]["bias"], dm["fc2"]["kernel"],
            dm["fc2"]["bias"]]
    if use_norm:
        want += [dn["scale"], dn["bias"]]
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL


def _card_error(got, ref, scale):
    """(largest error / the card's tolerance, share of elements that
    differ, mean |error|): two units in the last place of bf16 plus 2^-6
    of ``scale``."""
    got, ref = got.float(), ref.float()
    ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
    tol = 2 * torch.where(ref == 0, 0.0, ulp) + 2.0 ** -6 * scale
    err = (got - ref).abs()
    return ((err / tol).max().item(), (err > 0).float().mean().item(),
            err.mean().item())


@pytest.mark.parametrize("use_norm", [True, False])
def test_replay_rounds_where_the_plain_version_rounds(use_norm):
    """bfloat16 at the style transformer's width: the replays agree with
    the plain versions within the card's tolerance (dx's elements equal but
    for a few that a sum in another order moved by a unit); with da kept in
    f32 before dh a clear share of dx moves, and with z unrounded dW2 moves
    by far more than the sum orders move it."""
    xn, gn, wn, normn = _case(256, use_norm, seed=1)
    bf = torch.bfloat16
    x, g = torch.from_numpy(xn).to(bf), torch.from_numpy(gn).to(bf)
    w, norm = _torch(wn), _torch(normn)
    out = replay_forward(x, **w, **norm)
    plain_out = lm.ln_mlp_residual_plain(x, **w, **norm)
    worst, moved, _ = _card_error(out, plain_out,
                                  (plain_out.float() - x.float()).abs().max())
    assert worst <= 1.0 and moved < 0.02
    plain = lm.ln_mlp_residual_bwd_plain(g, x, w["w1"], w["b1"], w["w2"],
                                         **norm)
    got = replay_backward(g, x, w["w1"], w["b1"], w["w2"], **norm)
    errs = [_card_error(a, b, b.float().abs().max())
            for a, b in zip(got, plain) if b is not None]
    assert max(e[0] for e in errs) <= 1.0
    dx_moved, dx_mean = errs[0][1], errs[0][2]
    dw2_mean = errs[3][2]
    assert dx_moved < 0.02
    da_f32 = replay_backward(g, x, w["w1"], w["b1"], w["w2"], **norm,
                             variant="da_f32")
    _, moved_v, mean_v = _card_error(da_f32[0], plain[0],
                                     plain[0].float().abs().max())
    assert moved_v > 0.1 and mean_v > 5 * dx_mean
    z_f32 = replay_backward(g, x, w["w1"], w["b1"], w["w2"], **norm,
                            variant="z_f32")
    _, _, mean_z = _card_error(z_f32[3], plain[3], plain[3].abs().max())
    assert mean_z > 5 * dw2_mean


@pytest.mark.parametrize("c,kp", [(32, 32), (96, 32), (128, 64), (192, 64),
                                  (256, 64), (384, 64)])
def test_forward_plan_takes_k1s_forms(c, kp):
    """The forward at bf16: K1's forms -- two blocks of 8 warps an SM with a
    ring of 2 tiles of 32 rows where C <= 128, else one block of 16 warps
    with 3 tiles of kp rows (64 where C allows) -- its shared memory
    mlp_layout's, within a block's share of an SM; 172,032 bytes at
    C = 256."""
    plan = lm.mlp_plan(1000, c, 4 * c, False, torch.bfloat16)
    two = c <= 128
    assert (plan.body, plan.blocks_per_sm, plan.kp, plan.stages) == (
        "tc", 2 if two else 1, 32 if two else kp, 2 if two else 3)
    assert (plan.rows, plan.panel, plan.tiles) == (64, 128, 16)
    lay = lm.mlp_layout(c, plan.kp, plan.stages, False)
    assert plan.smem_bytes == lay["total"] <= (
        wb.SMEM_PER_SM // 2 - 1024 if two else wb.MAX_SMEM_BYTES)
    assert lay["ln"] - lay["xs"] == 4 * 64 * (c + 8)
    assert lay["ring"] - lay["hid"] == 2 * 64 * 136
    if c == 256:
        assert plan.smem_bytes == 172032


@pytest.mark.parametrize("c,kp,stages", [(32, 32, 4), (96, 32, 4),
                                         (128, 64, 2), (192, 64, 2),
                                         (256, 64, 2)])
def test_backward_plan_fits_a_block(c, kp, stages):
    """The backward at bf16: one block of 16 warps an SM, a ring of 2 tiles
    of 64 rows where C % 64 == 0, else 4 of 32; 223,232 bytes at C = 256
    (h, g, dh, the two chunk tiles and a ring of 3 x 64 rows would take
    239,616, over a block's 232,448)."""
    plan = lm.mlp_plan(ROWS, c, 4 * c, True, torch.bfloat16)
    assert (plan.body, plan.blocks_per_sm, plan.kp, plan.stages) == (
        "tc", 1, kp, stages)
    assert plan.tiles == 3
    lay = lm.mlp_layout(c, kp, stages, True)
    assert plan.smem_bytes == lay["total"] <= wb.MAX_SMEM_BYTES
    tile = 2 * 64 * (c + 8)
    assert lay["g"] - lay["ln"] == tile == lay["fa"] - lay["g"]
    assert lay["hid"] - lay["fa"] == 4 * 64 * 136
    if c == 256:
        assert plan.smem_bytes == 223232
        assert lm.mlp_layout(256, 64, 3, True)["total"] > wb.MAX_SMEM_BYTES


def test_plan_leaves_f32_and_other_shapes_scalar():
    """f32, C not a multiple of 32 or an MLP width not a multiple of 128
    keep the scalar body, forward and backward."""
    for backward in (False, True):
        for args in ((100, 256, 1024, torch.float32),
                     (100, 80, 320, torch.bfloat16),
                     (100, 256, 960, torch.bfloat16),
                     (100, 256, 64, torch.bfloat16)):
            assert lm.mlp_plan(args[0], *args[1:3], backward,
                               args[3]).body == "scalar"


@pytest.mark.parametrize("c", [32, 192, 256])
def test_schedules_cover_each_matrix_once_per_use(c):
    """The forward's tiles cover w1 and w2 once (K1's MLP order); the
    backward's cover w1, w2t = W2^T and w1t = W1^T once, chunk by chunk:
    w1's panel, w2t's panel, then w1t's panels; every tile kp rows deep and
    at most a panel wide."""
    hidden = 4 * c
    for backward, want in ((False, {"w1": (c, hidden), "w2": (hidden, c)}),
                           (True, {"w1": (c, hidden), "w2t": (c, hidden),
                                   "w1t": (hidden, c)})):
        plan = lm.mlp_plan(ROWS, c, hidden, backward, torch.bfloat16)
        sched = (lm.mlp_bwd_tile_schedule if backward
                 else lm.mlp_tile_schedule)(plan, c, hidden)
        count = {k: torch.zeros(s, dtype=torch.int32)
                 for k, s in want.items()}
        for name, r0, c0, nr, wd in sched:
            assert nr == plan.kp and 0 < wd <= plan.panel and wd % 32 == 0
            count[name][r0:r0 + nr, c0:c0 + wd] += 1
        for k in count:
            assert (count[k] == 1).all(), k
        if backward:
            nk, per = c // plan.kp, len(sched) // (hidden // 128)
            for j in range(hidden // 128):
                chunk = sched[j * per:(j + 1) * per]
                names = [s[0] for s in chunk]
                assert names == (["w1"] * nk + ["w2t"] * nk
                                 + ["w1t"] * (per - 2 * nk))
                assert {s[2] for s in chunk[:2 * nk]} == {j * 128}
                assert {s[1] // 128 for s in chunk[2 * nk:]} == {j}


@pytest.mark.parametrize("rows,i,j,dtype,splits", [
    (8192, 256, 1024, torch.bfloat16, 9), (8192, 1024, 256, torch.bfloat16, 9),
    (8192, 256, 1024, torch.float32, 2),
    (78400, 128, 128, torch.bfloat16, 132),
    (134, 32, 128, torch.bfloat16, 2), (50, 256, 256, torch.bfloat16, 1)])
def test_weight_splits_and_chunks(rows, i, j, dtype, splits):
    """The weight-gradient product's row chunks: two waves of blocks over
    132 SMs with its tiles (64 x 128 at bf16, 32 x 32 at f32), at least
    64 rows a chunk; the chunks cover the rows once, in order."""
    assert lm.weight_splits(rows, i, j, dtype) == splits
    chunks = lm.wgrad_chunks(rows, splits)
    assert chunks[0][0] == 0 and chunks[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(r1 > r0 for r0, r1 in chunks)
