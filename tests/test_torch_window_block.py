"""The port's Swin block kernel module (ops/window_block.py) against the
JAX package's block kernels K1 (``fused_window_block_rows``, reached through
``fused_self_attention_block``) and K2 (``fused_window_block``), which run
in Pallas interpret mode on the CPU. C=128 with 4 heads on a 16x16 grid,
which 7 does not divide, with and without the shift, with LN2 and norm-free.

On the CPU the wrappers run the plain PyTorch version. Tolerance: max-abs
1e-4 -- the JAX kernels' GELU uses the Abramowitz-Stegun erf (|err| <=
1.5e-7) where the port uses the exact erf, and sums run in another order.

tests/test_torch_cuda_kernels.py holds the CUDA kernel to the plain version
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.models.style_transformer import (
    init_style_swin_block,
)
from mastermetastyletransfer_tpu.ops import attention as jattn
from mastermetastyletransfer_tpu.ops import pallas_attention as jpallas
from mastermetastyletransfer_tpu.ops import windows as jwin
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.ops import attention as tattn
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from mastermetastyletransfer_tpu_torch.ops import windows as twin
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
C, HEADS = 128, 4


def _block(rng, shift):
    cj = jcfg.AttentionConfig(dim=C, num_heads=HEADS, window_size=(7, 7),
                              shift_size=shift, use_pallas=True)
    p = jax.device_get(init_style_swin_block(
        jax.random.PRNGKey(0), cj, use_norm=True, exclude_mlp=False,
        mlp_ratio=4.0))
    for norm in ("norm1", "norm2"):       # non-trivial affine
        p[norm] = {"scale": 1.0 + 0.3 * rng.standard_normal(C).astype(np.float32),
                   "bias": 0.3 * rng.standard_normal(C).astype(np.float32)}
    ct = tcfg.AttentionConfig(dim=C, num_heads=HEADS, window_size=(7, 7),
                              shift_size=shift, use_pallas=True)
    return cj, ct, jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p)


def _x(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("use_norm", [True, False])
@pytest.mark.parametrize("shift", [(0, 0), (3, 3)])
def test_block_matches_jax(rng, shift, use_norm):
    """fused_self_attention_block: the port's dispatch (f32 -> window entry)
    and its row entry, each against JAX's (K1 in interpret mode)."""
    cj, ct, pj, pt = _block(rng, shift)
    xj, xt = _x(rng, (2, 16, 16, C))
    ref = np.asarray(jattn.fused_self_attention_block(pj, xj, cj,
                                                      use_norm=use_norm))
    got = tattn.fused_self_attention_block(pt, xt, ct, use_norm=use_norm)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)

    xp, ph, pw = twin.pad_to_windows(xt, 7, 7)
    sh, sw = twin.effective_shift(ph, pw, (7, 7), shift)
    mask = (torch.from_numpy(twin.shift_attention_mask(ph, pw, 7, 7, sh, sw))
            if sh or sw else None)
    padmask = torch.from_numpy(twin.valid_token_mask(16, 16, ph, pw, 7, 7,
                                                     sh, sw))
    w = wb.block_weights(pt, (7, 7), torch.float32, use_norm)
    rows = wb.window_block_rows(xp, w, heads=HEADS, window=(7, 7),
                                shift=(sh, sw), mask=mask, padmask=padmask)
    np.testing.assert_allclose(rows[:, :16, :16].numpy(), ref, rtol=0,
                               atol=TOL)


def test_block_padded_resident_matches_jax(rng):
    """A pre-padded stage: garbage in the pad rows must stay inert."""
    cj, ct, pj, pt = _block(rng, (3, 3))
    xj, xt = _x(rng, (1, 21, 21, C))
    ref = np.asarray(jattn.fused_self_attention_block(
        pj, xj, cj, use_norm=True, valid_hw=(16, 16)))
    got = tattn.fused_self_attention_block(pt, xt, ct, use_norm=True,
                                           valid_hw=(16, 16))
    np.testing.assert_allclose(got[:, :16, :16].numpy(), ref[:, :16, :16],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("use_norm", [True, False])
def test_window_entry_matches_fused_window_block(rng, use_norm):
    """The window entry against K2 on (B, nW, N, C) window tensors, with
    the shift mask and a pad-validity mask."""
    _, _, pj, pt = _block(rng, (3, 3))
    xj, xt = _x(rng, (2, 9, 49, C))
    mask = jwin.shift_attention_mask(21, 21, 7, 7, 3, 3)
    padmask = jwin.valid_token_mask(16, 16, 21, 21, 7, 7, 3, 3)
    bias = jwin.relative_position_bias(pj["attn"]["rel_bias_table"], 7, 7)
    ref = np.asarray(jpallas.fused_window_block(
        pj["attn"], xj, bias, mask, HEADS, pj["mlp"],
        pj["norm2"] if use_norm else None, pj["norm1"] if use_norm else None,
        padmask, interpret=True))
    w = wb.block_weights(pt, (7, 7), torch.float32, use_norm)
    got = wb.window_block_windows(xt, w, heads=HEADS,
                                  mask=torch.from_numpy(mask),
                                  padmask=torch.from_numpy(padmask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


def test_wrappers_reject_other_devices(rng):
    _, _, _, pt = _block(rng, (0, 0))
    w = wb.block_weights(pt, (7, 7), torch.float32, True)
    x = torch.zeros(1, 7, 7, C, device="meta")
    with pytest.raises(ValueError):
        wb.window_block_rows(x, w, heads=HEADS, window=(7, 7), shift=(0, 0))
    with pytest.raises(ValueError):
        wb.window_block_windows(x.reshape(1, 1, 49, C), w, heads=HEADS)
