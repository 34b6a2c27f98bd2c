"""The port's window-resident style transformer and its kernels against the
JAX package, float32 on the CPU.

The kernel module (ops/style_block.py) runs its plain PyTorch versions here;
the JAX side runs its Pallas kernels K2 (``fused_window_block``), K3
(``fused_encoder_scale_shift``) and K4 (``fused_decoder_tail``) in interpret
mode, as its own tests do. A 9x9 token grid, which the 7x7 window does not
divide, so the pad re-zeroing and the masked instance norms run; C=256 with
8 heads, the slice's widths.

Tolerances: max-abs 1e-4 (sums in another order, and the JAX kernels'
Abramowitz-Stegun erf against the exact erf); the whole model at per-pixel
MAE <= 1e-5 and max-abs <= 1e-4.

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
from mastermetastyletransfer_tpu.models import style_transformer as jst
from mastermetastyletransfer_tpu.ops import attention as jattn
from mastermetastyletransfer_tpu.ops import mlp as jmlp
from mastermetastyletransfer_tpu.ops import pallas_attention as jpallas
from mastermetastyletransfer_tpu.ops import windows as jwin
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.models import master as tmaster
from mastermetastyletransfer_tpu_torch.models import style_transformer as tst
from mastermetastyletransfer_tpu_torch.ops import style_block as sb
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
C, HEADS = 256, 8
GRID = 9                 # tokens per side; padded to 14, 4 windows
PAD, NW = 14, 4


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _masks():
    sh, sw = jwin.effective_shift(PAD, PAD, (7, 7), (4, 4))
    mask = jwin.shift_attention_mask(PAD, PAD, 7, 7, sh, sw)
    padmask = jwin.valid_token_mask(GRID, GRID, PAD, PAD, 7, 7, sh, sw)
    return mask, padmask, torch.from_numpy(mask), torch.from_numpy(padmask)


def _attn(seed, dual=False):
    cj = jcfg.AttentionConfig(dim=C, num_heads=HEADS, window_size=(7, 7),
                              shift_size=(4, 4))
    init = (jattn.init_dual_value_window_attention if dual
            else jattn.init_window_attention)
    p = jax.device_get(init(jax.random.PRNGKey(seed), cj))
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p)


def _mlp(seed):
    p = jax.device_get(jmlp.init_mlp(jax.random.PRNGKey(seed), C, 4 * C,
                                     init="xavier_uniform"))
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p)


def _norm(rng):
    p = {"scale": 1.0 + _np(rng, C, 0.3), "bias": _np(rng, C, 0.3)}
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p)


def _windows(rng, n):
    xs = [_np(rng, (2, NW, 49, C), 0.5) for _ in range(n)]
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("use_ln1", [False, True])
def test_encoder_scale_shift_matches_jax(rng, use_ln1):
    """K3's plain version against fused_encoder_scale_shift."""
    (aj, at), (msj, mst), (mhj, mht) = _attn(0), _mlp(1), _mlp(2)
    nj, nt = _norm(rng) if use_ln1 else (None, None)
    mask, padmask, mask_t, padmask_t = _masks()
    (kj, sj, hj), (kt, st, ht) = _windows(rng, 3)
    bias = jwin.relative_position_bias(aj["rel_bias_table"], 7, 7)
    want_s, want_h = jpallas.fused_encoder_scale_shift(
        aj, kj, sj, hj, bias, mask, HEADS, msj, mhj, nj, padmask,
        interpret=True)
    w = sb.encoder_weights(at, mst, mht, nt, (7, 7), torch.float32)
    got_s, got_h = sb.encoder_scale_shift(kt, st, ht, w, heads=HEADS,
                                          mask=mask_t, padmask=padmask_t)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=TOL)


def test_decoder_tail_matches_jax(rng):
    """K4's plain version against fused_decoder_tail."""
    (dj, dt), (mj, mt) = _attn(3, dual=True), _mlp(4)
    mask, padmask, mask_t, padmask_t = _masks()
    xj, xt = _windows(rng, 5)
    bias = jwin.relative_position_bias(dj["rel_bias_table"], 7, 7)
    want = jpallas.fused_decoder_tail(dj, *xj, bias, mask, HEADS, mj, padmask,
                                      interpret=True)
    w = sb.decoder_tail_weights(dt, mt, (7, 7), torch.float32)
    got = sb.decoder_tail(*xt, w, heads=HEADS, mask=mask_t,
                          padmask=padmask_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_key_block_ln1_only_matches_jax(rng):
    """The block kernel's plain version with LN1 and no LN2 (the encoder Key
    block with encoder_use_norm) against fused_window_block(norm2=None)."""
    (aj, at), (mj, mt) = _attn(5), _mlp(6)
    nj, nt = _norm(rng)
    mask, padmask, mask_t, padmask_t = _masks()
    (xj,), (xt,) = _windows(rng, 1)
    bias = jwin.relative_position_bias(aj["rel_bias_table"], 7, 7)
    want = jpallas.fused_window_block(aj, xj, bias, mask, HEADS, mj, None, nj,
                                      padmask, interpret=True)
    w = wb.block_weights({"attn": at, "mlp": mt, "norm1": nt}, (7, 7),
                         torch.float32, True, norm2=False)
    assert w.n1s is not None and w.n2s is None
    got = wb.window_block_windows(xt, w, heads=HEADS, mask=mask_t,
                                  padmask=padmask_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------------------
# The style transformer's window-resident path
# ---------------------------------------------------------------------------

VARIANT = dict(
    encoder_use_norm=True,
    encoder_if_use_processed_Key_in_Scale_and_Shift_calculation=False,
    decoder_use_instance_norm_with_affine=True,
    decoder_use_Key_instance_norm_after_linear_transformation=False)


def _st(flags, seed=0):
    cj = jcfg.StyleTransformerConfig(use_pallas=True, **flags)
    ct = tcfg.StyleTransformerConfig.from_dict(cj.to_dict())
    p = jax.device_get(jst.init_style_transformer(jax.random.PRNGKey(seed),
                                                  cj))
    rng = np.random.default_rng(seed)
    norms = [p["encoder"]["shared_mha"].get("norm1"),
             p["decoder"].get("in_q"), p["decoder"].get("in_k")]
    for norm in filter(None, norms):          # non-trivial affines
        norm["scale"] = 1.0 + _np(rng, C, 0.3)
        norm["bias"] = _np(rng, C, 0.3)
    return cj, ct, jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p)


@pytest.fixture(scope="module")
def st_default():
    return _st({})


def _features(seed, shape=(2, GRID, GRID, C)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("k", [1, 3])
def test_windowed_style_transformer_matches_jax(st_default, k):
    cj, ct, pj, pt = st_default
    fcj, fct = _features(1)
    fsj, fst = _features(2)
    want = jst.style_transformer_apply(pj, fcj, fsj, cj, k=k)
    _close(tst.style_transformer_apply(pt, fct, fst, ct, k=k), want)


def test_windowed_variant_matches_jax():
    """The other orderings and norms: LN1 in the encoder, Key after
    Scale/Shift, affine decoder INs, Key IN before its linear."""
    cj, ct, pj, pt = _st(VARIANT, seed=1)
    fcj, fct = _features(3)
    fsj, fst = _features(4)
    want = jst.style_transformer_apply(pj, fcj, fsj, cj, k=2)
    _close(tst.style_transformer_apply(pt, fct, fst, ct, k=2), want)


@pytest.mark.parametrize("k", [1, 3])
def test_fused_port_matches_jax_split_route(st_default, k):
    """The port fuses the iteration at float32 too; the JAX package splits
    it there (K9 + K10). Both compute the same function."""
    cj, ct, pj, pt = st_default
    fcj, fct = _features(5)
    fsj, fst = _features(6)
    want = jst.style_transformer_apply_windowed(pj, fcj, fsj, cj, k=k,
                                                fuse_iteration=False)
    _close(tst.style_transformer_apply(pt, fct, fst, ct, k=k), want)


def test_style_stream_matches_apply(st_default):
    """style_transformer_stream + _apply_from_stream: a batch-1 stream
    broadcast over two contents against JAX's one-pass path on the tiled
    style, and an equal-batch stream against the port's one-pass path."""
    cj, ct, pj, pt = st_default
    fcj, fct = _features(7)
    fsj, fst = _features(8)
    want = jst.style_transformer_apply(pj, fcj, jnp.tile(fsj[:1], (2, 1, 1, 1)),
                                       cj, k=2)
    stream = tst.style_transformer_stream(pt, fst[:1], ct, k=2)
    assert isinstance(stream, tst.WindowedStyleStream)
    assert len(stream) == 2 and stream.hw == (GRID, GRID)
    _close(tst.style_transformer_apply_from_stream(pt, fct, stream, ct), want)

    stream = tst.style_transformer_stream(pt, fst, ct, k=2)
    got = tst.style_transformer_apply_from_stream(pt, fct, stream, ct)
    one_pass = tst.style_transformer_apply(pt, fct, fst, ct, k=2)
    np.testing.assert_allclose(got.numpy(), one_pass.numpy(), rtol=0,
                               atol=1e-6)


def test_style_stream_rejects_another_feature_size(st_default):
    """8x8 and 9x9 features pad to the same 14x14 window grid; the stream
    carries (h, w), so decoding 8x8 content against a 9x9 stream raises."""
    _, ct, _, pt = st_default
    _, fst = _features(9)
    _, fct = _features(10, (2, 8, 8, C))
    stream = tst.style_transformer_stream(pt, fst, ct, k=1)
    with pytest.raises(ValueError, match="feature size"):
        tst.style_transformer_apply_from_stream(pt, fct, stream, ct)


@pytest.mark.parametrize("k", [1, 3])
def test_split_route_matches_jax_split_route(st_default, k):
    """fuse_iteration=False on both sides: the Scale/Shift update through
    K9 and two K10 without a norm, the decoder tail through K9 and K10,
    only the shift mask passed to K9 on the grid the window does not
    divide (JAX models/style_transformer.py:592-604, :673-683)."""
    cj, ct, pj, pt = st_default
    fcj, fct = _features(13)
    fsj, fst = _features(14)
    want = jst.style_transformer_apply_windowed(pj, fcj, fsj, cj, k=k,
                                                fuse_iteration=False)
    _close(tst.style_transformer_apply_windowed(pt, fct, fst, ct, k=k,
                                                fuse_iteration=False), want)


def test_split_route_variant_matches_jax():
    """The split route with LN1 in the encoder (K9's value streams and q,
    k normed), Key after Scale/Shift and the affine INs."""
    cj, ct, pj, pt = _st(VARIANT, seed=2)
    fcj, fct = _features(15)
    fsj, fst = _features(16)
    want = jst.style_transformer_apply_windowed(pj, fcj, fsj, cj, k=2,
                                                fuse_iteration=False)
    _close(tst.style_transformer_apply_windowed(pt, fct, fst, ct, k=2,
                                                fuse_iteration=False), want)


@pytest.fixture(scope="module")
def st_exclude():
    return _st({"decoder_exclude_MLP_after_Fcs_self_MHA": True}, seed=3)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("use_norm", [True, False])
def test_exclude_mlp_windowed_matches_jax(st_exclude, fuse, use_norm):
    """The decoder's self block without its MLP: zp(LN1(Fcs)) (or zp(Fcs))
    through K8, plus Fcs, in the fused and the split route (JAX :628-637);
    the stream API too."""
    cj, ct, pj, pt = st_exclude
    cj = cj.replace(decoder_use_norm=use_norm)
    ct = ct.replace(decoder_use_norm=use_norm)
    fcj, fct = _features(17)
    fsj, fst = _features(18)
    want = jst.style_transformer_apply_windowed(pj, fcj, fsj, cj, k=2,
                                                fuse_iteration=fuse)
    _close(tst.style_transformer_apply_windowed(pt, fct, fst, ct, k=2,
                                                fuse_iteration=fuse), want)
    stream = tst.style_stream_windowed(pt, fst, ct, k=2, fuse_iteration=fuse)
    _close(tst.style_apply_windowed_from_stream(pt, fct, stream, ct,
                                                fuse_iteration=fuse), want)


def test_generic_path_with_kernels_matches_jax():
    """The generic path with kernels on (a configuration the windowed gate
    refuses: the regular-MHA tail) runs K8-K10 and matches JAX."""
    cj, regular, pj, preg = _st(
        {"decoder_use_regular_MHA_instead_of_Swin_at_the_end": True})
    assert not tst._st_windowed_ok(regular)
    fcj, fct = _features(11)
    _close(tst.style_transformer_apply(preg, fct, fct, regular, k=1),
           jst.style_transformer_apply(pj, fcj, fcj, cj, k=1))


def _master_all_kernels(transformer=None):
    """master_apply at 64^2, k=1, every stage's kernels on, on both sides,
    from JAX's seed-0 weights: the per-pixel error against JAX."""
    cj = jcfg.ModelConfig()
    if transformer:
        cj = cj.replace(transformer=cj.transformer.replace(**transformer))
    cj = cj.replace(swin=cj.swin.replace(use_pallas=True),
                    transformer=cj.transformer.replace(use_pallas=True),
                    decoder=cj.decoder.replace(use_pallas=True))
    ct = tcfg.ModelConfig.from_dict(cj.to_dict())
    pj = jax.device_get(jmaster.init_master_model(jax.random.PRNGKey(0), cj))
    pt = params_from_jax(pj)
    rng = np.random.default_rng(12)
    c, s = (rng.random((1, 64, 64, 3), dtype=np.float32) for _ in range(2))
    want = np.asarray(jmaster.master_apply(pj, jnp.asarray(c), jnp.asarray(s),
                                           cj, k=1))
    got = tmaster.make_stylize_fn(ct, k=1, device="cpu")(pt, c, s)
    return ct, np.abs(got.numpy() - want)


def test_master_apply_all_kernels_matches_jax():
    """The slice at float32: every stage's kernels on, both sides (JAX:
    K1-K7 in interpret mode; the port: the plain versions)."""
    ct, err = _master_all_kernels()
    assert ct == tcfg.ModelConfig().with_kernels()
    assert err.mean() <= 1e-5 and err.max() <= TOL, (err.mean(), err.max())


def test_master_apply_exclude_mlp_all_kernels_matches_jax():
    """An exclude-MLP checkpoint's configuration (what utils/convert.py
    writes for such a style transformer) with every kernel on: the
    decoder's self attention through K8 inside the whole model."""
    ct, err = _master_all_kernels(
        {"decoder_exclude_MLP_after_Fcs_self_MHA": True})
    assert ct.transformer.decoder_exclude_MLP_after_Fcs_self_MHA
    assert err.mean() <= 1e-5, (err.mean(), err.max())


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """Both sources include csrc/window_common.cuh: editing it must give
    every library a new build path, or a stale library would load."""
    from mastermetastyletransfer_tpu_torch.ops import _build

    for name in ("window_block.cu", "style_block.cu", "window_common.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.sources() == ["style_block", "window_block"]
    before = {n: _build.library_path(n) for n in _build.sources()}
    (tmp_path / "window_common.cuh").write_text("// edited\n")
    after = {n: _build.library_path(n) for n in _build.sources()}
    assert all(before[n] != after[n] for n in before)
