"""The training kernels' plain versions (ops/window_attention.py K8 and K9,
ops/ln_mlp.py K10) and the decoder kernels' backward passes
(ops/phase_conv.py K5, K6, K7) against the JAX package on the CPU: float32,
and K8, K9 and K10 also at bfloat16, training's type.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do:
the forward kernels and, through ``jax.vjp`` of their custom VJPs, their
backward kernels (pallas_attention_vjp.py, pallas_mlp_vjp.py); the stencil
and align backward passes are plain XLA there. Inputs are numpy draws
shared by both sides. Every explicit plain backward is also held to
``torch.autograd`` of its plain forward.

Bound: relative max-abs, max|a - b| / max|b|, at most 1e-5 for forward
outputs and 1e-4 for gradients (sums in another order; the JAX kernels'
Abramowitz-Stegun erf against the exact erf). The key bias of K8 has an
exactly zero gradient (the softmax does not see a shift of every key by one
vector), so its two sides are both rounding noise: it is held to 1e-4 of
the largest gradient of the other projections instead.

At bfloat16 (the ``-bf16`` cases) the inputs are the same numpy draws
cast to bf16 on both sides (the weights stay float32; both sides round
them where their kernels do), and the port's plain forward and explicit
plain backward are held to JAX's bf16 kernels and ``jax.vjp`` of them.
Bound: the card's bf16 tolerance (PERF.md section 2; chip_smoke.py), two
bf16 units in the last place of JAX's element plus 2^-6 of the tensor's
largest |value| (the bias gradients: of the largest of them, the key
bias's own being zero up to rounding); and the bf16 tensors -- the
outputs and the input gradients -- equal to JAX's but for under 1% of
their elements (a sum in another order moves an element by one unit).
The second bound is the one that sees a rounding point out of place: one
rounding of an intermediate moves an output by less than the first's 2^-6
term, but a third of its elements (a planted one shows it).

tests/test_torch_cuda_kernels.py holds the CUDA kernels to the plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.ops import attention as jattn
from mastermetastyletransfer_tpu.ops import conv as jconv
from mastermetastyletransfer_tpu.ops import mlp as jmlp
from mastermetastyletransfer_tpu.ops import pallas_conv as jpc
from mastermetastyletransfer_tpu.ops import windows as jwin
from mastermetastyletransfer_tpu.ops.pallas_attention_vjp import (
    window_attention as jwindow_attention,
    window_attention_dual as jwindow_attention_dual,
)
from mastermetastyletransfer_tpu.ops.pallas_mlp_vjp import (
    ln_mlp_residual as jln_mlp_residual,
)
from mastermetastyletransfer_tpu_torch.ops import conv as tconv
from mastermetastyletransfer_tpu_torch.ops import ln_mlp as lm
from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc
from mastermetastyletransfer_tpu_torch.ops import window_attention as wa
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    flatten_params, params_from_jax,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL_FWD, TOL_GRAD = 1e-5, 1e-4
TOL_BF16_ULPS, TOL_BF16_SCALE = 2, 2.0 ** -6
MAX_BF16_DIFF_SHARE = 0.01
C, HEADS, B, NW, N = 128, 4, 2, 4, 49
# The f32 cases keep their ids; the bf16 cases add "-bf16".
F32_BF16 = [torch.float32, torch.bfloat16]


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _attn_params(seed, dual=False):
    cj = jcfg.AttentionConfig(dim=C, num_heads=HEADS, window_size=(7, 7),
                              shift_size=(3, 3))
    init = (jattn.init_dual_value_window_attention if dual
            else jattn.init_window_attention)
    p = jax.device_get(init(jax.random.PRNGKey(seed), cj))
    # non-trivial biases, so that their gradients are exercised
    for name in p:
        if isinstance(p[name], dict) and "bias" in p[name]:
            p[name]["bias"] = _np(seed + 7, (C,), 0.1)
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p)


def _mask(shifted: bool):
    """The shift mask of a 14 x 14 grid shifted by 3, or None."""
    if not shifted:
        return None, None
    m = jwin.shift_attention_mask(14, 14, 7, 7, 3, 3)
    return (m.shape, tuple(m.ravel().tolist())), torch.from_numpy(m)


def _bias(seed):
    b = _np(seed, (HEADS, N, N), 0.1)
    return jnp.asarray(b), torch.from_numpy(b).requires_grad_()


def _windows(seed, n):
    xs = [_np(seed + i, (B, NW, N, C), 0.5) for i in range(n)]
    return ([jnp.asarray(x) for x in xs],
            [torch.from_numpy(x).requires_grad_() for x in xs])


def _leaves(tree):
    """The port's param leaves, set to require grad, by flat key."""
    flat = flatten_params(tree)
    for v in flat.values():
        v.requires_grad_()
    return flat


def _params(*vals):
    """pytest cases of ``vals`` at float32 (the value's id, as before the
    bf16 cases) and at bfloat16 (id ``...-bf16``)."""
    return [pytest.param(v, t, id=f"{v}" + ("-bf16" if t == torch.bfloat16
                                            else ""))
            for t in F32_BF16 for v in vals]


def _card(got, want, scale=None):
    """(largest error over the card's bf16 tolerance, share of elements that
    differ) of the port's tensor against JAX's: two bf16 units in the last
    place of JAX's element plus 2^-6 of ``scale`` (default: the largest
    |JAX value|)."""
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    ulp = np.where(want == 0, 0.0, 2.0 ** (np.frexp(want)[1] - 8))
    err = np.abs(got - want)
    return (float((err / (TOL_BF16_ULPS * ulp + TOL_BF16_SCALE * scale))
                  .max()), float((err > 0).mean()))


def _bf16_errors(names, got, want):
    """Per tensor of a bf16 case: _card's pair, the bias gradients (names
    "b...") scaled by the largest of them."""
    vec = max(float(np.abs(np.asarray(w, np.float32)).max())
              for n, w in zip(names, want) if n.startswith("b"))
    return {n: _card(g, w, vec if n.startswith("b") else None)
            for n, g, w in zip(names, got, want)}


def _assert_bf16(errs, bf16_names):
    """The bf16 bounds: every tensor within the card's tolerance, and the
    bf16 ones (outputs, input gradients) equal to JAX's but for under
    MAX_BF16_DIFF_SHARE of their elements."""
    for n, (over, share) in errs.items():
        assert over <= 1.0, (n, errs)
        if n in bf16_names:
            assert share <= MAX_BF16_DIFF_SHARE, (n, errs)


def _bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


K8_NAMES = ["out", "dq", "dk", "dv", "wq", "bq", "wk", "bk", "wv", "bv",
            "wp", "bp", "dbias"]


def _k8_bf16_errors(shifted):
    """K8 at bf16: the port's plain forward and explicit plain backward
    against JAX's kernel and its VJP, per tensor (``_bf16_errors``)."""
    pj, pt = _attn_params(0)
    mask_key, mask = _mask(shifted)
    xs = [_np(10 + i, (B, NW, N, C), 0.5) for i in range(3)]
    bnp, gnp = _np(20, (HEADS, N, N), 0.1), _np(30, (B, NW, N, C))
    want, vjp = jax.vjp(lambda p, q, k, v, b: jwindow_attention(
        p, q, k, v, b, mask_key, HEADS, True), pj, *map(_bf16, xs),
        jnp.asarray(bnp))
    dp, dq, dk, dv, db = vjp(_bf16(gnp))
    dpf = flatten_params(jax.device_get(dp))
    tx = [torch.from_numpy(x).to(torch.bfloat16) for x in xs]
    projs = [wa.Proj(pt[p]["kernel"], pt[p]["bias"])
             for p in ("wq", "wk", "wv", "proj")]
    bt = torch.from_numpy(bnp)
    out = wa.window_attention_plain(*tx, *projs, bt, mask, HEADS)
    grads = wa.window_attention_bwd_plain(
        torch.from_numpy(gnp).to(torch.bfloat16), *tx, *projs, bt, mask,
        HEADS)
    assert out.dtype == grads[0].dtype == torch.bfloat16
    wants = [want, dq, dk, dv] + [dpf[f"{p}/{leaf}"] for p in (
        "wq", "wk", "wv", "proj") for leaf in ("kernel", "bias")] + [db]
    return _bf16_errors(K8_NAMES, (out,) + tuple(grads), wants)


@pytest.mark.parametrize("shifted,dtype", _params(True, False))
def test_window_attention_matches_jax(shifted, dtype):
    """K8: the forward, the explicit plain backward and the autograd
    Function against JAX's kernels, and the plain backward against autograd
    of the plain forward; at bf16 the plain forward and backward against
    JAX's bf16 kernels."""
    if dtype == torch.bfloat16:
        _assert_bf16(_k8_bf16_errors(shifted), K8_NAMES[:4])
        return
    pj, pt = _attn_params(0)
    mask_key, mask = _mask(shifted)
    (qj, kj, vj), (qt, kt, vt) = _windows(10, 3)
    bj, bt = _bias(20)
    gnp = _np(30, (B, NW, N, C))

    def fj(p, q, k, v, b):
        return jwindow_attention(p, q, k, v, b, mask_key, HEADS, True)

    want, vjp = jax.vjp(fj, pj, qj, kj, vj, bj)
    dp, dq, dk, dv, db = vjp(jnp.asarray(gnp))
    flat = _leaves(pt)
    got = wa.window_attention(pt, qt, kt, vt, bt, mask, HEADS)
    assert _rel(got, want) <= TOL_FWD
    names = ["wq/kernel", "wq/bias", "wk/kernel", "wk/bias", "wv/kernel",
             "wv/bias", "proj/kernel", "proj/bias"]
    inputs = [qt, kt, vt] + [flat[n] for n in names] + [bt]
    auto = torch.autograd.grad(got, inputs, torch.from_numpy(gnp))
    dpf = flatten_params(jax.device_get(dp))
    wants = [dq, dk, dv] + [dpf[n] for n in names] + [db]
    scale = max(np.abs(np.asarray(w)).max() for w in wants)
    for name, a, w in zip(["dq", "dk", "dv"] + names + ["dbias"], auto,
                          wants):
        if name == "wk/bias":
            err = np.abs(a.numpy() - np.asarray(w)).max() / scale
        else:
            err = _rel(a, w)
        assert err <= TOL_GRAD, (name, err)

    projs = [wa.Proj(flat[f"{p}/kernel"].detach(), flat[f"{p}/bias"].detach())
             for p in ("wq", "wk", "wv", "proj")]
    plain = wa.window_attention_bwd_plain(
        torch.from_numpy(gnp), qt.detach(), kt.detach(), vt.detach(), *projs,
        bt.detach(), mask, HEADS)
    for name, a, p in zip(["dq", "dk", "dv"] + names + ["dbias"], auto,
                          plain):
        assert (a - p).abs().max() <= TOL_GRAD * max(scale * 1e-3,
                                                     a.abs().max()), name


def test_bf16_bound_sees_a_rounding_point_moved(monkeypatch):
    """The bf16 bound bites: with the softmax numerators left unrounded
    before the value product (planted in the port's plain K8 through its
    attention core), the output stays within the card's tolerance -- one
    rounding is under its 2^-6 term -- but differs from JAX's in far more
    than MAX_BF16_DIFF_SHARE of its elements, and the bf16 case fails."""

    def attend_unrounded(q, k, values, rel_bias, *, heads, mask=None):
        t = q.dtype
        b, nw, n, c = q.shape

        def split(z):
            return z.reshape(b, nw, n, heads, c // heads).transpose(2, 3)\
                .float()

        comb = rel_bias[None, None]
        if mask is not None:
            comb = mask[None, :, None] + comb
        s_ = split(q) @ split(k).transpose(-1, -2) + comb
        e = torch.exp(s_ - s_.amax(-1, keepdim=True))
        recip = 1.0 / e.sum(-1, keepdim=True)
        return tuple(((e @ split(v)) * recip).to(t).transpose(2, 3)
                     .reshape(b, nw, n, c) for v in values)

    monkeypatch.setattr(wa, "attend", attend_unrounded)
    errs = _k8_bf16_errors(True)
    assert errs["out"][0] <= 1.0 and errs["out"][1] > 10 * MAX_BF16_DIFF_SHARE
    with pytest.raises(AssertionError):
        _assert_bf16(errs, K8_NAMES[:4])


K9_NAMES = ["sigma", "mu", "dq", "dk", "dvs", "dvh", "wvs", "bvs", "wvh",
            "bvh", "wp", "bp", "dbias"]


def _k9_bf16_errors(shared):
    """K9 at bf16 in one of its forms, as ``_k8_bf16_errors``; with one wv
    for both streams each use's gradient is held to JAX's for that use."""
    pj, pt = _attn_params(1, dual=True)
    if shared:
        pj = dict(pj, wv_shift=pj["wv_scale"])
        pt = dict(pt, wv_shift=pt["wv_scale"])
    mask_key, mask = _mask(True)
    xs = [_np(40 + i, (B, NW, N, C), 0.5) for i in range(4)]
    bnp = _np(50, (HEADS, N, N), 0.1)
    gs = [_np(60 + i, (B, NW, N, C)) for i in range(2)]
    (sj, mj), vjp = jax.vjp(lambda p, q, k, vs, vh, b: jwindow_attention_dual(
        p, q, k, vs, vh, b, mask_key, HEADS, True), pj, *map(_bf16, xs),
        jnp.asarray(bnp))
    dp, dq, dk, dvs, dvh, db = vjp(tuple(map(_bf16, gs)))
    dpf = flatten_params(jax.device_get(dp))
    tx = [torch.from_numpy(x).to(torch.bfloat16) for x in xs]
    projs = [wa.Proj(pt[p]["kernel"], pt[p]["bias"])
             for p in ("wv_scale", "wv_shift", "proj")]
    bt = torch.from_numpy(bnp)
    outs = wa.window_attention_dual_plain(*tx, *projs, bt, mask, HEADS)
    grads = wa.window_attention_dual_bwd_plain(
        *(torch.from_numpy(g).to(torch.bfloat16) for g in gs), *tx, *projs,
        bt, mask, HEADS)
    wants = [sj, mj, dq, dk, dvs, dvh] + [dpf[f"{p}/{leaf}"] for p in (
        "wv_scale", "wv_shift", "proj") for leaf in ("kernel", "bias")] + [db]
    return _bf16_errors(K9_NAMES, tuple(outs) + tuple(grads), wants)


@pytest.mark.parametrize("shared,dtype", _params(False, True))
def test_window_attention_dual_matches_jax(shared, dtype):
    """K9 in both of its forms: the decoder's (wv_scale, wv_shift) and the
    style encoder's Scale/Shift pair, which passes one wv twice; at bf16
    the plain forward and backward against JAX's bf16 kernels."""
    if dtype == torch.bfloat16:
        _assert_bf16(_k9_bf16_errors(shared), K9_NAMES[:6])
        return
    pj, pt = _attn_params(1, dual=True)
    if shared:
        pj = dict(pj, wv_shift=pj["wv_scale"])
        pt = dict(pt, wv_shift=pt["wv_scale"])
    mask_key, mask = _mask(True)
    (qj, kj, vsj, vhj), (qt, kt, vst, vht) = _windows(40, 4)
    bj, bt = _bias(50)
    gs, gh = _np(60, (B, NW, N, C)), _np(61, (B, NW, N, C))

    def fj(p, q, k, vs, vh, b):
        return jwindow_attention_dual(p, q, k, vs, vh, b, mask_key, HEADS,
                                      True)

    (sj, mj), vjp = jax.vjp(fj, pj, qj, kj, vsj, vhj, bj)
    dp, dq, dk, dvs, dvh, db = vjp((jnp.asarray(gs), jnp.asarray(gh)))
    dpf = flatten_params(jax.device_get(dp))
    flat = _leaves(pt)
    st, mt = wa.window_attention_dual(pt, qt, kt, vst, vht, bt, mask, HEADS)
    assert _rel(st, sj) <= TOL_FWD and _rel(mt, mj) <= TOL_FWD
    names = ["wv_scale/kernel", "wv_scale/bias", "proj/kernel", "proj/bias"]
    if not shared:
        names += ["wv_shift/kernel", "wv_shift/bias"]
    inputs = [qt, kt, vst, vht] + [flat[n] for n in names] + [bt]
    auto = torch.autograd.grad((st, mt), inputs,
                               (torch.from_numpy(gs), torch.from_numpy(gh)))
    wants = [dq, dk, dvs, dvh]
    for n in names:
        w = np.asarray(dpf[n])
        if shared and n.startswith("wv_scale"):
            # autograd sums the grads of the two uses of the shared wv
            w = w + np.asarray(dpf[n.replace("scale", "shift")])
        wants.append(w)
    wants.append(db)
    for name, a, w in zip(["dq", "dk", "dvs", "dvh"] + names + ["dbias"],
                          auto, wants):
        assert _rel(a, w) <= TOL_GRAD, name

    if not shared:
        projs = [wa.Proj(flat[f"{p}/kernel"].detach(),
                         flat[f"{p}/bias"].detach())
                 for p in ("wv_scale", "wv_shift", "proj")]
        plain = wa.window_attention_dual_bwd_plain(
            torch.from_numpy(gs), torch.from_numpy(gh), qt.detach(),
            kt.detach(), vst.detach(), vht.detach(), *projs, bt.detach(),
            mask, HEADS)
        order = [0, 1, 2, 3, 4, 5, 8, 9, 6, 7, 10]   # the autograd order
        for name, a, i in zip(["dq", "dk", "dvs", "dvh"] + names + ["dbias"],
                              auto, order):
            assert (a - plain[i]).abs().max() <= TOL_GRAD * a.abs().max(), \
                name


def _mlp_case(use_norm):
    """K10's numpy draws: the MLP's params, the norm's or None, x and the
    output's gradient (3, 5, 7, C)."""
    p = jax.device_get(jmlp.init_mlp(jax.random.PRNGKey(2), C, 4 * C,
                                     init="xavier_uniform"))
    p["fc1"]["bias"] = _np(70, (4 * C,), 0.1)
    p["fc2"]["bias"] = _np(71, (C,), 0.1)
    norm = ({"scale": 1.0 + _np(72, (C,), 0.3), "bias": _np(73, (C,), 0.3)}
            if use_norm else None)
    return p, norm, _np(74, (3, 5, 7, C)), _np(75, (3, 5, 7, C))


def _k10_bf16_errors(use_norm):
    """K10 at bf16, as ``_k8_bf16_errors``: the port's plain forward and
    explicit plain backward against JAX's kernel and its VJP."""
    p, norm, xnp, gnp = _mlp_case(use_norm)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    nj = None if norm is None else jax.tree_util.tree_map(jnp.asarray, norm)
    want, vjp = jax.vjp(lambda x, m, n: jln_mlp_residual(x, m, n, 1e-5, True),
                        _bf16(xnp), pj, nj)
    dx, dm, dn = vjp(_bf16(gnp))
    t = {k: torch.tensor(np.asarray(v)) for k, v in flatten_params(
        {"mlp": p, **({"norm": norm} if norm else {})}).items()}
    w = (t["mlp/fc1/kernel"], t["mlp/fc1/bias"], t["mlp/fc2/kernel"])
    ns_nb = ((t["norm/scale"], t["norm/bias"]) if norm else (None, None))
    xt = torch.from_numpy(xnp).to(torch.bfloat16)
    out = lm.ln_mlp_residual_plain(xt, *w, t["mlp/fc2/bias"], *ns_nb)
    grads = lm.ln_mlp_residual_bwd_plain(
        torch.from_numpy(gnp).to(torch.bfloat16), xt, *w, *ns_nb)
    dj = flatten_params(jax.device_get({"mlp": dm, **(
        {"norm": dn} if norm else {})}))
    names = ["out", "dx", "w1", "b1", "w2", "b2"] + (
        ["scale", "bn"] if norm else [])
    wants = [want, dx] + [dj[k] for k in (
        "mlp/fc1/kernel", "mlp/fc1/bias", "mlp/fc2/kernel", "mlp/fc2/bias")]
    if norm:
        wants += [dj["norm/scale"], dj["norm/bias"]]
    got = (out,) + tuple(g for g in grads if g is not None)
    assert out.dtype == grads[0].dtype == torch.bfloat16
    return _bf16_errors(names, got, wants)


@pytest.mark.parametrize("use_norm,dtype", _params(True, False))
def test_ln_mlp_residual_matches_jax(use_norm, dtype):
    """K10 with and without its LayerNorm; at bf16 the plain forward and
    backward against JAX's bf16 kernel and its VJP."""
    if dtype == torch.bfloat16:
        _assert_bf16(_k10_bf16_errors(use_norm), ["out", "dx"])
        return
    p, norm, xnp, gnp = _mlp_case(use_norm)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    nj = None if norm is None else jax.tree_util.tree_map(jnp.asarray, norm)
    want, vjp = jax.vjp(lambda x, m, n: jln_mlp_residual(x, m, n, 1e-5, True),
                        jnp.asarray(xnp), pj, nj)
    dx, dm, dn = vjp(jnp.asarray(gnp))
    pt, nt = params_from_jax(p), None if norm is None else params_from_jax(
        norm)
    flat = _leaves({"mlp": pt, **({"norm": nt} if nt else {})})
    xt = torch.from_numpy(xnp).requires_grad_()
    got = lm.ln_mlp_residual(xt, pt, nt)
    assert _rel(got, want) <= TOL_FWD
    names = list(flat)
    auto = torch.autograd.grad(got, [xt] + [flat[n] for n in names],
                               torch.from_numpy(gnp))
    dflat = flatten_params(jax.device_get(
        {"mlp": dm, **({"norm": dn} if nt else {})}))
    assert _rel(auto[0], dx) <= TOL_GRAD
    for n, a in zip(names, auto[1:]):
        assert _rel(a, dflat[n]) <= TOL_GRAD, n

    ns, nb = (None, None) if nt is None else (flat["norm/scale"].detach(),
                                              flat["norm/bias"].detach())
    plain = lm.ln_mlp_residual_bwd_plain(
        torch.from_numpy(gnp), xt.detach(), flat["mlp/fc1/kernel"].detach(),
        flat["mlp/fc1/bias"].detach(), flat["mlp/fc2/kernel"].detach(),
        ns, nb)
    by_name = {"mlp/fc1/kernel": plain[1], "mlp/fc1/bias": plain[2],
               "mlp/fc2/kernel": plain[3], "mlp/fc2/bias": plain[4],
               "norm/scale": plain[5], "norm/bias": plain[6]}
    assert (plain[0] - auto[0]).abs().max() <= TOL_GRAD * auto[0].abs().max()
    for n, a in zip(names, auto[1:]):
        assert (by_name[n] - a).abs().max() <= TOL_GRAD * a.abs().max(), n


# ---------------------------------------------------------------------------
# The decoder kernels' backward passes
# ---------------------------------------------------------------------------

def _grads_close(got, want) -> None:
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL_GRAD


@pytest.mark.parametrize("form", ["up", "l1"])
def test_stencil_phase_conv_backward_matches_jax(form):
    """K5's autograd Function (plain backward) against jax.vjp of JAX's
    stencil_phase_conv (its _stencil_bwd), at Cin 128, C' 32."""
    cin = 128 if form == "up" else 32
    w = _np(80, (3, 3, cin, 32), 0.1)
    bias4 = np.tile(_np(81, (32,), 0.3), 4)
    x = _np(82, (2, 6, 7, 128))
    gnp = _np(83, (2, 6, 7, 128))
    wj = jnp.asarray(w)
    if form == "up":
        kj, kt = jconv._phase_kernel(wj), tconv._phase_kernel(
            torch.from_numpy(w))
        table = tconv._UPSAMPLE_TABLE
    else:
        kj, kt = jconv._phase_space_kernel(wj), tconv._phase_space_kernel(
            torch.from_numpy(w))
        table = tconv._phase_space_table()
    ppj = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)),
                  mode="edge")
    want, vjp = jax.vjp(lambda pp, k, b: jpc.stencil_phase_conv(
        pp, k, b, True, True), ppj, kj, jnp.asarray(bias4))
    ppt = torch.from_numpy(np.array(ppj)).requires_grad_()
    kt = kt.detach().requires_grad_()
    bt = torch.from_numpy(bias4).requires_grad_()
    got = pc.stencil_phase_conv(ppt, kt, bt, table)
    assert got.grad_fn is not None and _rel(got, want) <= TOL_FWD
    _grads_close(torch.autograd.grad(got, (ppt, kt, bt),
                                     torch.from_numpy(gnp)),
                 vjp(jnp.asarray(gnp)))


def test_stencil_phase2_conv_backward_matches_jax():
    """K6's plain entry (the L2 up-conv, 4 x 32 -> 16 x 32) against
    jax.vjp of JAX's stencil_phase2_conv (its _stencil2_bwd)."""
    w = _np(84, (3, 3, 32, 32), 0.1)
    bias16 = np.tile(_np(85, (32,), 0.3), 16)
    x = _np(86, (2, 6, 7, 128))
    gnp = _np(87, (2, 6, 7, 512))
    kj, bases = jconv._phase2_kernel(jnp.asarray(w), True)
    kt, _ = tconv._phase2_kernel(torch.from_numpy(w), True)
    table = tconv._phase2_table(True)
    ppj = jconv._phase2_pad(jnp.asarray(x), 2, 32, True)
    want, vjp = jax.vjp(lambda pp, k, b: jpc.stencil_phase2_conv(
        pp, k, b, tuple(bases), table.present, True, True), ppj, kj,
        jnp.asarray(bias16))
    ppt = torch.from_numpy(np.array(ppj)).requires_grad_()
    kt = kt.detach().requires_grad_()
    bt = torch.from_numpy(bias16).requires_grad_()
    got = pc.stencil_phase2_conv(ppt, kt, bt, table)
    assert _rel(got, want) <= TOL_FWD
    _grads_close(torch.autograd.grad(got, (ppt, kt, bt),
                                     torch.from_numpy(gnp)),
                 vjp(jnp.asarray(gnp)))


def test_phase_align_backward_matches_jax():
    """K7's Function against jax.vjp of JAX's phase_align
    (_phase_align_bwd): an exact scatter, so bit-equal."""
    big = _np(88, (2, 7, 8, 4 * 64))
    gnp = _np(89, (2, 6, 7, 4 * 64))
    _, vjp = jax.vjp(lambda t: jpc.phase_align(t, 64, True), jnp.asarray(big))
    bt = torch.from_numpy(big).requires_grad_()
    (got,) = torch.autograd.grad(pc.phase_align(bt, 64), bt,
                                 torch.from_numpy(gnp))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(vjp(jnp.asarray(gnp))[0]))
