"""Parity of the port's ops (mastermetastyletransfer_tpu_torch/ops) with the
JAX package's, on a 9x9 token grid so that the pad, roll and shift-mask
paths all run. Inputs come from numpy; weights from JAX initializers,
shared through params_from_jax. Tolerance: max-abs 1e-5 (float32 both
sides; only the summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.ops import attention as jattn
from mastermetastyletransfer_tpu.ops import mlp as jmlp
from mastermetastyletransfer_tpu.ops import norm as jnorm
from mastermetastyletransfer_tpu.ops import windows as jwin
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.ops import attention as tattn
from mastermetastyletransfer_tpu_torch.ops import mlp as tmlp
from mastermetastyletransfer_tpu_torch.ops import norm as tnorm
from mastermetastyletransfer_tpu_torch.ops import windows as twin
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


def _pair(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("geom", [(9, 9, 7, 7, 0, 0), (14, 14, 7, 7, 3, 3),
                                  (14, 21, 7, 7, 4, 4), (10, 12, 5, 6, 2, 3)])
def test_window_geometry(rng, geom):
    h, w, wh, ww, sh, sw = geom
    np.testing.assert_array_equal(twin.relative_position_index(wh, ww),
                                  jwin.relative_position_index(wh, ww))
    ph, pw = -(-h // wh) * wh, -(-w // ww) * ww
    np.testing.assert_array_equal(
        twin.shift_attention_mask(ph, pw, wh, ww, sh, sw),
        jwin.shift_attention_mask(ph, pw, wh, ww, sh, sw))
    np.testing.assert_array_equal(
        twin.valid_token_mask(h - 1, w - 2, ph, pw, wh, ww, sh, sw),
        jwin.valid_token_mask(h - 1, w - 2, ph, pw, wh, ww, sh, sw))
    assert (twin.effective_shift(ph, pw, (wh, ww), (sh, sw))
            == jwin.effective_shift(ph, pw, (wh, ww), (sh, sw)))
    xj, xt = _pair(rng, (2, h, w, 5))
    pj, jh, jw = jwin.pad_to_windows(xj, wh, ww)
    pt, th, tw = twin.pad_to_windows(xt, wh, ww)
    assert (jh, jw) == (th, tw)
    _close(pt, pj, 0)
    wj = jwin.window_partition(pj, wh, ww)
    wt = twin.window_partition(pt, wh, ww)
    _close(wt, wj, 0)
    _close(twin.window_merge(wt, 2, ph, pw, wh, ww),
           jwin.window_merge(wj, 2, ph, pw, wh, ww), 0)
    tj, tt = _pair(rng, ((2 * wh - 1) * (2 * ww - 1), 3))
    _close(twin.relative_position_bias(tt, wh, ww),
           jwin.relative_position_bias(tj, wh, ww), 0)


@pytest.mark.parametrize("affine", [False, True])
def test_norms(rng, affine):
    xj, xt = _pair(rng, (2, 9, 9, 32), 3.0)
    sj, st = _pair(rng, (32,))
    bj, bt = _pair(rng, (32,))
    kw_j = dict(scale=sj, bias=bj) if affine else {}
    kw_t = dict(scale=st, bias=bt) if affine else {}
    _close(tnorm.instance_norm(xt, **kw_t), jnorm.instance_norm(xj, **kw_j))
    _close(tnorm.layer_norm(xt, st, bt), jnorm.layer_norm(xj, sj, bj))


def test_linear_and_mlp(rng):
    p = jmlp.init_mlp(jax.random.PRNGKey(1), 32, 128, init="xavier_uniform")
    pt = params_from_jax(jax.device_get(p))
    xj, xt = _pair(rng, (2, 9, 9, 32))
    _close(tmlp.linear(pt["fc1"], xt), jmlp.linear(p["fc1"], xj))
    _close(tmlp.mlp_apply(pt, xt), jmlp.mlp_apply(p, xj))


def _attn_cfgs(shift):
    kw = dict(dim=64, num_heads=4, window_size=(7, 7), shift_size=shift)
    return jcfg.AttentionConfig(**kw), tcfg.AttentionConfig(**kw)


@pytest.mark.parametrize("shift", [(0, 0), (4, 4)])
def test_shifted_window_attention(rng, shift):
    cj, ct = _attn_cfgs(shift)
    p = jattn.init_window_attention(jax.random.PRNGKey(0), cj)
    pt = params_from_jax(jax.device_get(p))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, (2, 9, 9, 64)) for _ in range(3))
    _close(tattn.shifted_window_attention(pt, qt, kt, vt, ct),
           jattn.shifted_window_attention(p, qj, kj, vj, cj))


def test_shifted_window_attention_two_v(rng):
    cj, ct = _attn_cfgs((4, 4))
    p = jattn.init_window_attention(jax.random.PRNGKey(2), cj)
    pt = params_from_jax(jax.device_get(p))
    (kj, kt), (v1j, v1t), (v2j, v2t) = (_pair(rng, (2, 9, 9, 64))
                                        for _ in range(3))
    a1, a2 = jattn.shifted_window_attention_two_v(p, kj, kj, v1j, v2j, cj)
    b1, b2 = tattn.shifted_window_attention_two_v(pt, kt, kt, v1t, v2t, ct)
    _close(b1, a1)
    _close(b2, a2)


@pytest.mark.parametrize("key_in_after", [True, False])
@pytest.mark.parametrize("affine", [False, True])
def test_shifted_window_attention_dual_value(rng, key_in_after, affine):
    cj, ct = _attn_cfgs((4, 4))
    p = jattn.init_dual_value_window_attention(jax.random.PRNGKey(3), cj)
    pt = params_from_jax(jax.device_get(p))
    ins = [_pair(rng, (2, 9, 9, 64)) for _ in range(4)]
    inp_j = inp_t = None
    if affine:
        aff = {w: {"scale": rng.standard_normal(64).astype(np.float32),
                   "bias": rng.standard_normal(64).astype(np.float32)}
               for w in ("q", "k")}
        inp_j = jax.tree_util.tree_map(jnp.asarray, aff)
        inp_t = params_from_jax(aff)
    sj, mj = jattn.shifted_window_attention_dual_value(
        p, *[a for a, _ in ins], cj,
        key_instance_norm_after_linear=key_in_after,
        instance_norm_params=inp_j)
    st, mt = tattn.shifted_window_attention_dual_value(
        pt, *[b for _, b in ins], ct,
        key_instance_norm_after_linear=key_in_after,
        instance_norm_params=inp_t)
    _close(st, sj)
    _close(mt, mj)
