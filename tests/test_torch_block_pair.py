"""The Swin block pair (ops/block_pair.py, the pair branch of models/swin.py)
and the patch-embed kernel module (ops/patch_embed.py) against the JAX
package, float32 on the CPU.

* K11's plain version against JAX's ``fused_window_block_pair_rows`` in
  Pallas interpret mode (whose output, in block 1's rolled frame, is
  un-rolled here), at swin_B's two stage widths on grids of 3x3 and 2x2
  windows with pad tokens: max-abs 1e-5 (sums in another order, and JAX's
  Abramowitz-Stegun erf in GELU against the exact erf).
* ``swin_backbone_apply`` with ``MMST_BLOCK_PAIR=1`` on both sides at 64^2:
  max-abs 1e-4, both stages through the pair.
* The zero-shift gate: at 32^2 stage 2 is one window, where JAX's knob
  fails its assertion; the port takes the per-block loop there and matches
  JAX with the knob off.
* K13's plain version against JAX's ``pallas_patch_embed`` in interpret
  mode at the geometries and tolerances of tests/test_ops.py.

tests/test_torch_cuda_kernels.py holds the CUDA kernels to the plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.models import master as jmaster
from mastermetastyletransfer_tpu.models import swin as jswin
from mastermetastyletransfer_tpu.ops import attention as jattn
from mastermetastyletransfer_tpu.ops import pallas_attention as jpallas
from mastermetastyletransfer_tpu.ops import pallas_conv as jpc
from mastermetastyletransfer_tpu.ops import windows as jwin
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.models import swin as tswin
from mastermetastyletransfer_tpu_torch.ops import attention as tattn
from mastermetastyletransfer_tpu_torch.ops import block_pair as bpr
from mastermetastyletransfer_tpu_torch.ops import patch_embed as tpe
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from mastermetastyletransfer_tpu_torch.ops import windows as twin
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def swin():
    """The default model's Swin weights (JAX-initialised) and their copy."""
    pj = jax.device_get(jmaster.init_master_model(
        jax.random.PRNGKey(0), jcfg.ModelConfig())["swin"])
    return pj, params_from_jax(pj)


def _x(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("stage,valid", [(0, 16), (1, 10)])
def test_pair_plain_matches_jax_kernel(swin, stage, valid):
    """One stage's two blocks (swin_B: C=128, 4 heads at stage 1; C=256, 8
    heads at stage 2) on a padded grid of valid x valid tokens, 2 images."""
    pj, pt = swin
    c = 128 * 2 ** stage
    heads = (4, 8)[stage]
    pad = -(-valid // 7) * 7
    sh = sw = 3
    xj, xt = _x(stage, (2, pad, pad, c))
    bj = [pj[f"stage{stage}_block{i}"] for i in range(2)]
    bt = [pt[f"stage{stage}_block{i}"] for i in range(2)]
    norms = [(p["norm1"], p["norm2"]) for p in bj]
    pm = [jwin.valid_token_mask(valid, valid, pad, pad, 7, 7, s, s)
          for s in (0, sh)]
    ref = jpallas.fused_window_block_pair_rows(
        bj[0]["attn"], bj[1]["attn"], xj,
        jattn.relative_position_bias(bj[0]["attn"]["rel_bias_table"], 7, 7),
        jattn.relative_position_bias(bj[1]["attn"]["rel_bias_table"], 7, 7),
        jwin.shift_attention_mask(pad, pad, 7, 7, sh, sw), heads,
        bj[0]["mlp"], bj[1]["mlp"], norms[0], norms[1], pm[0], pm[1],
        window=(7, 7), shift=(sh, sw), interpret=True)
    ref = np.roll(np.asarray(ref), (sh, sw), (1, 2))
    w0, w1 = (wb.block_weights(p, (7, 7), torch.float32, True) for p in bt)
    got = bpr.window_block_pair_rows(
        xt, w0, w1, heads=heads, window=(7, 7), shift=(sh, sw),
        mask1=torch.from_numpy(twin.shift_attention_mask(pad, pad, 7, 7, sh,
                                                         sw)),
        padmask0=torch.from_numpy(pm[0]), padmask1=torch.from_numpy(pm[1]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def _count_pairs(monkeypatch):
    calls = []
    real = tattn.block_pair.window_block_pair_rows

    def counted(x, *a, **k):
        calls.append(tuple(x.shape))
        return real(x, *a, **k)

    monkeypatch.setattr(tattn.block_pair, "window_block_pair_rows", counted)
    return calls


def test_swin_with_block_pair_matches_jax(swin, monkeypatch):
    pj, pt = swin
    monkeypatch.setenv("MMST_BLOCK_PAIR", "1")
    calls = _count_pairs(monkeypatch)
    cj = jcfg.SwinConfig(use_pallas=True)
    ct = tcfg.SwinConfig(use_pallas=True)
    xj, xt = _x(3, (1, 64, 64, 3))
    ref = np.asarray(jswin.swin_backbone_apply(pj, xj, cj))
    got = tswin.swin_backbone_apply(pt, xt, ct)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    assert calls == [(1, 21, 21, 128), (1, 14, 14, 256)]


def test_zero_shift_takes_the_per_block_path(swin, monkeypatch):
    """At 32^2 stage 2 (4x4 tokens) is one window, so block 1's effective
    shift is 0: JAX's pair kernel asserts there, the port's gate takes the
    per-block loop for that stage and matches JAX with the knob off."""
    pj, pt = swin
    cj = jcfg.SwinConfig(use_pallas=True)
    ct = tcfg.SwinConfig(use_pallas=True)
    xj, xt = _x(4, (1, 32, 32, 3))
    ref = np.asarray(jswin.swin_backbone_apply(pj, xj, cj))
    monkeypatch.setenv("MMST_BLOCK_PAIR", "1")
    with pytest.raises(AssertionError):
        jswin.swin_backbone_apply(pj, xj, cj)
    calls = _count_pairs(monkeypatch)
    got = tswin.swin_backbone_apply(pt, xt, ct)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    assert calls == [(1, 14, 14, 128)]


@pytest.mark.parametrize("geometry,dtype,tol", [
    ((2, 64, 128), "float32", 1e-5),
    ((1, 96, 96), "float32", 1e-5),
    ((2, 64, 128), "bfloat16", 2e-2)])
@pytest.mark.parametrize("use_ln", [True, False])
def test_patch_embed_plain_matches_jax_kernel(geometry, dtype, tol, use_ln):
    b, s, e = geometry
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    k = (rng.standard_normal((4, 4, 3, e)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(e) * 0.01).astype(np.float32)
    sc = (1.0 + 0.1 * rng.standard_normal(e)).astype(np.float32)
    sb = (0.1 * rng.standard_normal(e)).astype(np.float32)
    ln = (sc, sb) if use_ln else (None, None)
    ref = jpc.pallas_patch_embed(
        jnp.asarray(x, dtype), jnp.asarray(k), jnp.asarray(bias),
        *(None if v is None else jnp.asarray(v) for v in ln),
        interpret=True)
    got = tpe.patch_embed(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(k),
        torch.from_numpy(bias),
        *(None if v is None else torch.from_numpy(v) for v in ln))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (b, s // 4, s // 4, e)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)
