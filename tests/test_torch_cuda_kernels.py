"""The port's CUDA kernels (ops/window_block.py, ops/block_pair.py,
ops/style_block.py, ops/phase_conv.py, ops/patch_embed.py,
ops/window_attention.py, ops/ln_mlp.py) against their plain PyTorch versions
on the card, the training kernels' backward passes against torch.autograd
of the plain forward.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor tests/conftest.py's fixtures, so that it also runs on a
machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance, element by element, as chip_smoke.py states it: at float32
1e-4 of the largest magnitude of the plain output (order of sums); at
bfloat16 two units in the last place of the plain output element (a value
near a rounding boundary may land on either side) plus 2^-6 of the block's
largest update |out - x| (intermediates rounded on either side of a
boundary). The decoder's stencil kernels: at bfloat16 two units in the
last place plus 2^-8 of the largest |output| (both sides sum in f32 and
round once); the phase align exactly. The pair kernel K11 as the block
kernel, and bit for bit as K1 applied twice (the same per-window body
with the same plan at either dtype: the scalar one at float32, the
tensor-core one at bfloat16); the RGB-tail
kernel K12 as the stencil kernels; the patch-embed kernel K13 at
bfloat16 two units in the last place plus 2^-6 of the largest |output|.
"""

import pytest
import torch

from mastermetastyletransfer_tpu_torch.config import AttentionConfig
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    init_style_swin_block,
)
from mastermetastyletransfer_tpu_torch.ops import block_pair as bpr
from mastermetastyletransfer_tpu_torch.ops import patch_embed as tpe
from mastermetastyletransfer_tpu_torch.ops import style_block as sb
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from mastermetastyletransfer_tpu_torch.ops import windows as twin
from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map

C, HEADS = 128, 4
TOL_F32 = 1e-4
TOL_BF16_ULPS, TOL_BF16_UPDATE = 2, 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(cuda, dtype, use_norm):
    g = torch.Generator().manual_seed(0)
    acfg = AttentionConfig(dim=C, num_heads=HEADS, window_size=(7, 7),
                           shift_size=(3, 3))
    params = tree_map(lambda t: t.to(cuda), init_style_swin_block(
        g, acfg, use_norm=True, exclude_mlp=False, mlp_ratio=4.0))
    w = wb.block_weights(params, (7, 7), dtype, use_norm)
    x = torch.randn((2, 21, 21, C), generator=g).to(cuda, dtype)
    mask = torch.from_numpy(
        twin.shift_attention_mask(21, 21, 7, 7, 3, 3)).to(cuda)
    padmask = torch.from_numpy(
        twin.valid_token_mask(16, 16, 21, 21, 7, 7, 3, 3)).to(cuda)
    return w, x, mask, padmask


def _check(got, ref, x):
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if x.dtype == torch.float32:
        tol = TOL_F32 * max(1.0, ref.abs().max().item())
    else:
        # bf16 unit in the last place of |ref| = m 2^e, m in [0.5, 1)
        ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
        ulp = torch.where(ref == 0, 0.0, ulp)
        tol = (TOL_BF16_ULPS * ulp
               + TOL_BF16_UPDATE * (ref - x.float()).abs().max())
    assert (err <= tol).all(), (err.max().item(), (err / tol).max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("use_norm", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_entry_matches_plain(cuda, dtype, use_norm):
    w, x, mask, padmask = _inputs(cuda, dtype, use_norm)
    kw = dict(heads=HEADS, window=(7, 7), shift=(3, 3), mask=mask,
              padmask=padmask)
    before = wb.LAUNCHES["window_block_rows"]
    got = wb.window_block_rows(x, w, **kw)
    assert wb.LAUNCHES["window_block_rows"] == before + 1
    _check(got, wb.window_block_rows_plain(x, w, **kw), x)


@pytest.mark.cuda
@pytest.mark.parametrize("use_norm", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windows_entry_matches_plain(cuda, dtype, use_norm):
    w, x, mask, padmask = _inputs(cuda, dtype, use_norm)
    xw = twin.window_partition(torch.roll(x, (-3, -3), (1, 2)), 7, 7)
    xw = xw.reshape(2, 9, 49, C).contiguous()
    kw = dict(heads=HEADS, mask=mask, padmask=padmask)
    before = wb.LAUNCHES["window_block_windows"]
    got = wb.window_block_windows(xw, w, **kw)
    assert wb.LAUNCHES["window_block_windows"] == before + 1
    _check(got, wb.window_block_windows_plain(xw, w, **kw), xw)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    w, x, mask, padmask = _inputs(cuda, torch.float32, True)
    kw = dict(heads=HEADS, window=(7, 7), shift=(3, 3))
    with pytest.raises(ValueError):       # not padded to the window
        wb.window_block_rows(x[:, :20].contiguous(), w, **kw)
    with pytest.raises(TypeError):        # weights of another type than x
        wb.window_block_rows(x.to(torch.bfloat16), w, **kw)
    with pytest.raises(ValueError):       # not contiguous
        wb.window_block_rows(x.transpose(1, 2), w, **kw)


# ---------------------------------------------------------------------------
# The block kernel at the swin_T/S widths, and with LN1 only
# ---------------------------------------------------------------------------

def _block_case(cuda, dtype, c, heads, use_norm=True, norm2=None):
    g = torch.Generator().manual_seed(1)
    acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                           shift_size=(3, 3))
    params = init_style_swin_block(g, acfg, use_norm=True, exclude_mlp=False,
                                   mlp_ratio=4.0)
    for name in ("norm1", "norm2"):       # non-trivial affine
        params[name] = {"scale": 1 + 0.3 * torch.randn(c, generator=g),
                        "bias": 0.3 * torch.randn(c, generator=g)}
    params = tree_map(lambda t: t.to(cuda), params)
    w = wb.block_weights(params, (7, 7), dtype, use_norm, norm2=norm2)
    x = torch.randn((2, 21, 21, c), generator=g).to(cuda, dtype)
    mask = torch.from_numpy(
        twin.shift_attention_mask(21, 21, 7, 7, 3, 3)).to(cuda)
    padmask = torch.from_numpy(
        twin.valid_token_mask(16, 16, 21, 21, 7, 7, 3, 3)).to(cuda)
    return w, x, mask, padmask


def _run_entry(entry, w, x, heads, mask, padmask):
    before = wb.LAUNCHES[f"window_block_{entry}"]
    if entry == "rows":
        kw = dict(heads=heads, window=(7, 7), shift=(3, 3), mask=mask,
                  padmask=padmask)
        got = wb.window_block_rows(x, w, **kw)
        ref = wb.window_block_rows_plain(x, w, **kw)
    else:
        x = twin.window_partition(torch.roll(x, (-3, -3), (1, 2)), 7, 7)
        x = x.reshape(2, 9, 49, -1).contiguous()
        kw = dict(heads=heads, mask=mask, padmask=padmask)
        got = wb.window_block_windows(x, w, **kw)
        ref = wb.window_block_windows_plain(x, w, **kw)
    assert wb.LAUNCHES[f"window_block_{entry}"] == before + 1
    _check(got, ref, x)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(96, 3), (192, 6)])
@pytest.mark.parametrize("entry", ["rows", "windows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swin_t_s_widths_match_plain(cuda, dtype, entry, c, heads):
    """The port's gate sends swin_T/S blocks (C=96 with 3 heads, C=192 with
    6, head dim 32) through the block kernel."""
    w, x, mask, padmask = _block_case(cuda, dtype, c, heads)
    _run_entry(entry, w, x, heads, mask, padmask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln1_only_block_matches_plain(cuda, dtype):
    """LN1 and no LN2: the style encoder's Key block with encoder_use_norm."""
    w, x, mask, padmask = _block_case(cuda, dtype, C, HEADS, norm2=False)
    assert w.n1s is not None and w.n2s is None
    _run_entry("windows", w, x, HEADS, mask, padmask)


# K1's tensor-core body at the Swin stages' widths on ragged grids:
# (Hp, Wp, valid h, valid w), the padded grid a multiple of the window.
K1_GRIDS = [(14, 14, 9, 12), (21, 35, 16, 30), (7, 7, 7, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", K1_GRIDS)
@pytest.mark.parametrize("shift", [(0, 0), (3, 3)])
@pytest.mark.parametrize("c,heads", [(128, 4), (256, 8), (32, 2), (128, 2),
                                     (256, 4)])
def test_k1_tensor_core_body_matches_plain(cuda, c, heads, shift, grid):
    """K1 at bf16 runs the tensor-core body (block_plan) at stage 1's and
    stage 2's widths (head dim 32; two blocks an SM at C = 128, one at
    256), and at head dims 16 and 64 in both forms, with and without the
    shift, against the plain version; the pad tokens hold garbage that
    must stay inert."""
    hp, wp, vh, vw = grid
    g = torch.Generator().manual_seed(c + hp + wp + shift[0])
    acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                           shift_size=shift)
    params = init_style_swin_block(g, acfg, use_norm=True, exclude_mlp=False,
                                   mlp_ratio=4.0)
    for name in ("norm1", "norm2"):
        params[name] = {"scale": 1 + 0.3 * torch.randn(c, generator=g),
                        "bias": 0.3 * torch.randn(c, generator=g)}
    params = tree_map(lambda t: t.to(cuda), params)
    w = wb.block_weights(params, (7, 7), torch.bfloat16, True)
    x = torch.randn((2, hp, wp, c), generator=g)
    x[:, vh:] = 5.0
    x[:, :, vw:] = -5.0
    x = x.to(cuda, torch.bfloat16)
    sh, sw = twin.effective_shift(hp, wp, (7, 7), shift)
    kw = dict(heads=heads, window=(7, 7), shift=(sh, sw),
              mask=(torch.from_numpy(twin.shift_attention_mask(
                  hp, wp, 7, 7, sh, sw)).to(cuda) if sh or sw else None),
              padmask=torch.from_numpy(twin.valid_token_mask(
                  vh, vw, hp, wp, 7, 7, sh, sw)).to(cuda))
    plan = wb.block_plan("window_block_rows", 49, c, heads, 4 * c,
                         torch.bfloat16)
    assert plan.body == "tc"
    before = wb.LAUNCHES["window_block_rows"]
    got = wb.window_block_rows(x, w, **kw)
    assert wb.LAUNCHES["window_block_rows"] == before + 1
    _check(got, wb.window_block_rows_plain(x, w, **kw), x)
    smem, dyn, regs = wb.kernel_attributes(plan, torch.bfloat16, c // heads)
    assert dyn >= plan.smem_bytes and regs > 0


@pytest.mark.cuda
@pytest.mark.parametrize("stage,c,heads", [(0, 128, 4), (1, 256, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_on_a_band_slab_matches_plain(cuda, dtype, stage, c, heads):
    """K1 as the band-owned spatial path launches it: the last of 4 bands
    of a 1024^2 image (window rows padded to a multiple of 4, past the
    reference grid), shift (0, 3) with the H-roll outside the kernel, and
    the band's mask slab, whose keys outside the reference grid carry
    -1e9 (parallel/spatial_shmap.py); at stage 1's and stage 2's widths."""
    from mastermetastyletransfer_tpu_torch.config import ModelConfig
    from mastermetastyletransfer_tpu_torch.parallel import spatial_shmap

    aux, meta = spatial_shmap._build_aux(1024, 1024, ModelConfig(), 4, 3,
                                         cuda)
    geo = meta[f"s{stage}"]
    mask, padmask = aux[f"s{stage}_mask"], aux[f"s{stage}_pm1"]
    assert geo["nwh_pad"] * 7 > geo["pad_h_ref"] and geo["sw"] == 3
    assert mask.min().item() <= -1e9
    g = torch.Generator().manual_seed(stage)
    acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                           shift_size=(3, 3))
    params = tree_map(lambda t: t.to(cuda), init_style_swin_block(
        g, acfg, use_norm=True, exclude_mlp=False, mlp_ratio=4.0))
    w = wb.block_weights(params, (7, 7), dtype, True)
    x = torch.randn((2, geo["rows_loc"], geo["Wp"], c),
                    generator=g).to(cuda, dtype)
    kw = dict(heads=heads, window=(7, 7), shift=(0, geo["sw"]), mask=mask,
              padmask=padmask)
    before = wb.LAUNCHES["window_block_rows"]
    got = wb.window_block_rows(x, w, **kw)
    assert wb.LAUNCHES["window_block_rows"] == before + 1
    _check(got, wb.window_block_rows_plain(x, w, **kw), x)


# ---------------------------------------------------------------------------
# The style transformer's kernels (ops/style_block.py)
# ---------------------------------------------------------------------------

ST_C, ST_HEADS = 256, 8


def _style_case(cuda, dtype, n_windows):
    """Weights, window tensors (2, 4, 49, 256) of a 9x9 token grid padded
    to 14x14 with shift (4, 4), its shift mask and its pad mask."""
    from mastermetastyletransfer_tpu_torch.ops.attention import (
        init_dual_value_window_attention, init_window_attention,
    )
    from mastermetastyletransfer_tpu_torch.ops.mlp import init_mlp

    g = torch.Generator().manual_seed(2)
    acfg = AttentionConfig(dim=ST_C, num_heads=ST_HEADS, window_size=(7, 7),
                           shift_size=(4, 4))
    params = {"attn": init_window_attention(g, acfg),
              "dual": init_dual_value_window_attention(g, acfg),
              "norm1": {"scale": 1 + 0.3 * torch.randn(ST_C, generator=g),
                        "bias": 0.3 * torch.randn(ST_C, generator=g)}}
    for name in ("mlp_scale", "mlp_shift", "last_mlp"):
        params[name] = init_mlp(g, ST_C, 4 * ST_C, init="xavier_uniform")
    params = tree_map(lambda t: t.to(cuda), params)
    xs = [(0.5 * torch.randn((2, 4, 49, ST_C), generator=g)).to(cuda, dtype)
          for _ in range(n_windows)]
    mask = torch.from_numpy(
        twin.shift_attention_mask(14, 14, 7, 7, 4, 4)).to(cuda)
    padmask = torch.from_numpy(
        twin.valid_token_mask(9, 9, 14, 14, 7, 7, 4, 4)).to(cuda)
    return params, xs, dict(heads=ST_HEADS, mask=mask, padmask=padmask)


@pytest.mark.cuda
@pytest.mark.parametrize("use_ln1", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_scale_shift_matches_plain(cuda, dtype, use_ln1):
    params, (key, scale, shift), kw = _style_case(cuda, dtype, 3)
    w = sb.encoder_weights(params["attn"], params["mlp_scale"],
                           params["mlp_shift"],
                           params["norm1"] if use_ln1 else None, (7, 7),
                           dtype)
    before = sb.LAUNCHES["encoder_scale_shift"]
    got_s, got_h = sb.encoder_scale_shift(key, scale, shift, w, **kw)
    assert sb.LAUNCHES["encoder_scale_shift"] == before + 1
    ref_s, ref_h = sb.encoder_scale_shift_plain(key, scale, shift, w, **kw)
    _check(got_s, ref_s, scale)
    _check(got_h, ref_h, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_tail_matches_plain(cuda, dtype):
    params, xs, kw = _style_case(cuda, dtype, 5)
    w = sb.decoder_tail_weights(params["dual"], params["last_mlp"], (7, 7),
                                dtype)
    before = sb.LAUNCHES["decoder_tail"]
    got = sb.decoder_tail(*xs, w, **kw)
    assert sb.LAUNCHES["decoder_tail"] == before + 1
    _check(got, sb.decoder_tail_plain(*xs, w, **kw), xs[4])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_style_kernels_on_a_band_slab_match_plain(cuda, dtype, n):
    """K2 (the Key block without norms, the self block with them), K3 and
    K4 as the band-owned spatial path launches them: the last band of n of
    a 1024^2 image's style-transformer grid (19 window rows padded to 20,
    past the reference grid), (2, 20 / n x 19, 49, 256) windows, the band's
    slab of the shift mask, whose keys outside the reference grid carry
    -1e9, and of the validity mask (parallel/spatial_shmap.py)."""
    from mastermetastyletransfer_tpu_torch.config import ModelConfig
    from mastermetastyletransfer_tpu_torch.ops.attention import (
        init_dual_value_window_attention, init_window_attention,
    )
    from mastermetastyletransfer_tpu_torch.ops.mlp import init_mlp
    from mastermetastyletransfer_tpu_torch.parallel import spatial_shmap

    aux, meta = spatial_shmap._build_aux(1024, 1024, ModelConfig(), n, n - 1,
                                         cuda)
    geo = meta["st"]
    mask, padmask = aux["st_mask"], aux["st_pm"]
    assert geo["nwh_pad"] * 7 > geo["pad_h_ref"] and mask.min() <= -1e9
    kw = dict(heads=ST_HEADS, mask=mask, padmask=padmask)
    g = torch.Generator().manual_seed(n)
    acfg = AttentionConfig(dim=ST_C, num_heads=ST_HEADS, window_size=(7, 7),
                           shift_size=(4, 4))
    params = tree_map(lambda t: t.to(cuda), {
        "block": init_style_swin_block(g, acfg, use_norm=True,
                                       exclude_mlp=False, mlp_ratio=4.0),
        "attn": init_window_attention(g, acfg),
        "dual": init_dual_value_window_attention(g, acfg),
        **{m: init_mlp(g, ST_C, 4 * ST_C, init="xavier_uniform")
           for m in ("mlp_scale", "mlp_shift", "last_mlp")}})
    xs = [torch.randn((2, mask.shape[0], 49, ST_C), generator=g)
          .to(cuda, dtype) for _ in range(5)]
    for use_norm in (False, True):
        w = wb.block_weights(params["block"], (7, 7), dtype, use_norm)
        before = wb.LAUNCHES["window_block_windows"]
        got = wb.window_block_windows(xs[0], w, **kw)
        assert wb.LAUNCHES["window_block_windows"] == before + 1
        _check(got, wb.window_block_windows_plain(xs[0], w, **kw), xs[0])
    w = sb.encoder_weights(params["attn"], params["mlp_scale"],
                           params["mlp_shift"], None, (7, 7), dtype)
    before = sb.LAUNCHES["encoder_scale_shift"]
    got_s, got_h = sb.encoder_scale_shift(*xs[:3], w, **kw)
    assert sb.LAUNCHES["encoder_scale_shift"] == before + 1
    ref_s, ref_h = sb.encoder_scale_shift_plain(*xs[:3], w, **kw)
    _check(got_s, ref_s, xs[1])
    _check(got_h, ref_h, xs[2])
    w = sb.decoder_tail_weights(params["dual"], params["last_mlp"], (7, 7),
                                dtype)
    before = sb.LAUNCHES["decoder_tail"]
    got = sb.decoder_tail(*xs, w, **kw)
    assert sb.LAUNCHES["decoder_tail"] == before + 1
    _check(got, sb.decoder_tail_plain(*xs, w, **kw), xs[4])


# K2 and K3 on the tensor-core bodies at the style transformer's width (C =
# 256) at head dims 16, 32 and 64, and K2 at C = 128 (two blocks an SM).
TC_STYLE_WIDTHS = [(256, 16), (256, 8), (256, 4)]


def _tc_windows(cuda, g, c, masks):
    """(2, 4, 49, c) bf16 windows of a 9x9 grid padded to 14x14, shift
    (4, 4), the pad tokens holding garbage; with ``masks`` the shift mask
    and the pad mask, else neither."""
    x = torch.randn((2, 4, 49, c), generator=g)
    kw = dict(mask=None, padmask=None)
    if masks:
        pm = torch.from_numpy(twin.valid_token_mask(9, 9, 14, 14, 7, 7, 4, 4))
        x = torch.where(pm[None, :, :, None] == 0, 5.0, x)
        kw = dict(mask=torch.from_numpy(twin.shift_attention_mask(
            14, 14, 7, 7, 4, 4)).to(cuda), padmask=pm.to(cuda))
    return x, kw


@pytest.mark.cuda
@pytest.mark.parametrize("masks", [True, False])
@pytest.mark.parametrize("norms", [False, True])
@pytest.mark.parametrize("c,heads", TC_STYLE_WIDTHS + [(128, 4)])
def test_k2_tensor_core_body_matches_plain(cuda, c, heads, norms, masks):
    """K2 at bf16 runs the tensor-core body (block_plan): the encoder Key
    block's form (no LN1, no LN2) and the decoder self block's (both), at
    head dims 16, 32 and 64, with and without the shift and pad masks,
    against the plain version; its kernel reports the plan's shared
    memory."""
    g = torch.Generator().manual_seed(c + heads + 2 * norms + masks)
    acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                           shift_size=(4, 4))
    params = init_style_swin_block(g, acfg, use_norm=True, exclude_mlp=False,
                                   mlp_ratio=4.0)
    for name in ("norm1", "norm2"):
        params[name] = {"scale": 1 + 0.3 * torch.randn(c, generator=g),
                        "bias": 0.3 * torch.randn(c, generator=g)}
    params = tree_map(lambda t: t.to(cuda), params)
    w = wb.block_weights(params, (7, 7), torch.bfloat16, norms)
    x, kw = _tc_windows(cuda, g, c, masks)
    x = x.to(cuda, torch.bfloat16)
    plan = wb.block_plan("window_block_windows", 49, c, heads, 4 * c,
                         torch.bfloat16)
    assert plan.body == "tc"
    before = wb.LAUNCHES["window_block_windows"]
    got = wb.window_block_windows(x, w, heads=heads, **kw)
    assert wb.LAUNCHES["window_block_windows"] == before + 1
    _check(got, wb.window_block_windows_plain(x, w, heads=heads, **kw), x)
    smem, dyn, regs = wb.kernel_attributes(plan, torch.bfloat16, c // heads)
    assert smem == 0 and dyn >= plan.smem_bytes > 0 and regs > 0


def _k3_case(cuda, c, heads, use_ln1, masks):
    """K3's bf16 weights (a non-trivial LN1 where use_ln1), its Key, Scale
    and Shift windows as _tc_windows makes them, and its keywords."""
    from mastermetastyletransfer_tpu_torch.ops.attention import (
        init_window_attention,
    )
    from mastermetastyletransfer_tpu_torch.ops.mlp import init_mlp

    g = torch.Generator().manual_seed(3 * c + heads + 2 * use_ln1 + masks)
    acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                           shift_size=(4, 4))
    params = {"attn": init_window_attention(g, acfg),
              "norm1": {"scale": 1 + 0.3 * torch.randn(c, generator=g),
                        "bias": 0.3 * torch.randn(c, generator=g)},
              **{m: init_mlp(g, c, 4 * c, init="xavier_uniform")
                 for m in ("mlp_scale", "mlp_shift")}}
    params = tree_map(lambda t: t.to(cuda), params)
    w = sb.encoder_weights(params["attn"], params["mlp_scale"],
                           params["mlp_shift"],
                           params["norm1"] if use_ln1 else None, (7, 7),
                           torch.bfloat16)
    key, scale, shift = [
        _tc_windows(cuda, g, c, masks)[0].to(cuda, torch.bfloat16)
        for _ in range(3)]
    kw = dict(heads=heads, **_tc_windows(cuda, g, c, masks)[1])
    return w, [key, scale, shift], kw


@pytest.mark.cuda
@pytest.mark.parametrize("masks", [True, False])
@pytest.mark.parametrize("use_ln1", [False, True])
@pytest.mark.parametrize("c,heads", TC_STYLE_WIDTHS)
def test_k3_tensor_core_body_matches_plain(cuda, c, heads, use_ln1, masks):
    """K3 at bf16 runs its tensor-core body (style_plan) at head dims 16,
    32 and 64, with LN1 and without, with and without the shift and pad
    masks, against the plain version; its kernel reports the plan's shared
    memory."""
    w, (key, scale, shift), kw = _k3_case(cuda, c, heads, use_ln1, masks)
    plan = sb.style_plan(49, c, heads, 4 * c, torch.bfloat16)
    assert plan.body == "tc"
    before = sb.LAUNCHES["encoder_scale_shift"]
    got_s, got_h = sb.encoder_scale_shift(key, scale, shift, w, **kw)
    assert sb.LAUNCHES["encoder_scale_shift"] == before + 1
    ref_s, ref_h = sb.encoder_scale_shift_plain(key, scale, shift, w, **kw)
    _check(got_s, ref_s, scale)
    _check(got_h, ref_h, shift)
    smem, dyn, regs = sb.kernel_attributes(plan, torch.bfloat16, c // heads)
    assert smem == 0 and dyn >= plan.smem_bytes > 0 and regs > 0


def _k4_case(cuda, c, heads, masks):
    """K4's bf16 weights, its q, k, Scale, Shift and Query windows as
    _tc_windows makes them, and its keywords."""
    from mastermetastyletransfer_tpu_torch.ops.attention import (
        init_dual_value_window_attention,
    )
    from mastermetastyletransfer_tpu_torch.ops.mlp import init_mlp

    g = torch.Generator().manual_seed(5 * c + heads + masks)
    acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                           shift_size=(4, 4))
    params = tree_map(lambda t: t.to(cuda), {
        "dual": init_dual_value_window_attention(g, acfg),
        "last_mlp": init_mlp(g, c, 4 * c, init="xavier_uniform")})
    w = sb.decoder_tail_weights(params["dual"], params["last_mlp"], (7, 7),
                                torch.bfloat16)
    xs = [_tc_windows(cuda, g, c, masks)[0].to(cuda, torch.bfloat16)
          for _ in range(5)]
    kw = dict(heads=heads, **_tc_windows(cuda, g, c, masks)[1])
    return w, xs, kw


@pytest.mark.cuda
@pytest.mark.parametrize("masks", [True, False])
@pytest.mark.parametrize("c,heads", TC_STYLE_WIDTHS)
def test_k4_tensor_core_body_matches_plain(cuda, c, heads, masks):
    """K4 at bf16 runs its tensor-core body (tail_plan) at head dims 16, 32
    and 64, with and without the shift and pad masks (the pad tokens of
    every input hold garbage), against the plain version; its kernel
    reports the plan's shared memory."""
    w, xs, kw = _k4_case(cuda, c, heads, masks)
    plan = sb.tail_plan(49, c, heads, 4 * c, torch.bfloat16)
    assert plan.body == "tc"
    before = sb.LAUNCHES["decoder_tail"]
    got = sb.decoder_tail(*xs, w, **kw)
    assert sb.LAUNCHES["decoder_tail"] == before + 1
    _check(got, sb.decoder_tail_plain(*xs, w, **kw), xs[4])
    smem, dyn, regs = sb.kernel_attributes(plan, torch.bfloat16, c // heads,
                                           "decoder_tail")
    assert smem == 0 and dyn >= plan.smem_bytes > 0 and regs > 0


@pytest.mark.cuda
def test_f32_k2_and_k3_keep_the_scalar_bodies(cuda):
    """At f32 K2 and K3 plan the scalar body, and their kernels launch and
    report no dynamic shared memory beyond the scalar layout's."""
    for entry in ("window_block_windows", "window_block_rows"):
        assert wb.block_plan(entry, 49, 256, 8, 1024,
                             torch.float32).body == "scalar"
    plan = sb.style_plan(49, 256, 8, 1024, torch.float32)
    assert plan.body == "scalar"
    params, (key, scale, shift), kw = _style_case(cuda, torch.float32, 3)
    w = sb.encoder_weights(params["attn"], params["mlp_scale"],
                           params["mlp_shift"], None, (7, 7), torch.float32)
    sb.encoder_scale_shift(key, scale, shift, w, **kw)
    torch.cuda.synchronize()
    smem, dyn, regs = sb.kernel_attributes(plan, torch.float32, 32)
    assert dyn >= sb.smem_bytes(49, 256, 8, torch.float32) and regs > 0


@pytest.mark.cuda
def test_f32_k4_and_k11_keep_the_scalar_bodies(cuda):
    """At f32 K4 and K11 plan the scalar body, and their scalar kernels
    launch and report the scalar layout's dynamic shared memory."""
    plan = sb.tail_plan(49, 256, 8, 1024, torch.float32)
    assert plan.body == "scalar"
    params, xs, kw = _style_case(cuda, torch.float32, 5)
    w = sb.decoder_tail_weights(params["dual"], params["last_mlp"], (7, 7),
                                torch.float32)
    sb.decoder_tail(*xs, w, **kw)
    torch.cuda.synchronize()
    smem, dyn, regs = sb.kernel_attributes(plan, torch.float32, 32,
                                           "decoder_tail")
    assert dyn >= sb.smem_bytes(49, 256, 8, torch.float32) and regs > 0
    pair = bpr.pair_plan(49, C, HEADS, 4 * C, torch.float32)
    assert pair.body == "scalar"
    (w0, w1), x, pkw = _pair_case(cuda, torch.float32, 14, 14, 12, 12)
    bpr.window_block_pair_rows(x, w0, w1, **pkw)
    torch.cuda.synchronize()
    smem, dyn, regs = bpr.kernel_attributes(pair, torch.float32, C // HEADS)
    assert dyn >= bpr.smem_bytes(pair, 49, C, HEADS, torch.float32)
    assert regs > 0


@pytest.mark.cuda
def test_tc_entries_refuse_a_wrong_plan(cuda, monkeypatch):
    """K4's and K11's C entries check the plan they are given against the
    layout and refuse a mismatch (a shared-memory size 16 bytes off) with
    cudaErrorInvalidValue, launching nothing; the wrappers raise."""
    w, xs, kw = _k4_case(cuda, 256, 8, True)
    good = sb.tail_plan(49, 256, 8, 1024, torch.bfloat16)
    bad = good._replace(smem_bytes=good.smem_bytes + 16)
    monkeypatch.setitem(sb._PLANS, "decoder_tail", lambda *a: bad)
    before = sb.LAUNCHES["decoder_tail"]
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        sb.decoder_tail(*xs, w, **kw)
    assert sb.LAUNCHES["decoder_tail"] == before
    (w0, w1), x, pkw = _pair_case(cuda, torch.bfloat16, 14, 14, 12, 12)
    good = bpr.pair_plan(49, C, HEADS, 4 * C, torch.bfloat16)
    monkeypatch.setattr(bpr, "pair_plan", lambda *a: good._replace(
        smem_bytes=good.smem_bytes + 16))
    before = bpr.LAUNCHES["window_block_pair_rows"]
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        bpr.window_block_pair_rows(x, w0, w1, **pkw)
    assert bpr.LAUNCHES["window_block_pair_rows"] == before


@pytest.mark.cuda
def test_style_wrappers_reject_what_the_kernels_do_not_take(cuda):
    params, xs, kw = _style_case(cuda, torch.float32, 5)
    w = sb.decoder_tail_weights(params["dual"], params["last_mlp"], (7, 7),
                                torch.float32)
    with pytest.raises(TypeError):        # inputs of another type
        sb.decoder_tail(*[x.to(torch.bfloat16) for x in xs], w, **kw)
    with pytest.raises(ValueError):       # not contiguous
        sb.decoder_tail(xs[0].transpose(1, 2), *xs[1:], w, **kw)
    with pytest.raises(ValueError):       # another shape
        sb.decoder_tail(xs[0][:, :3].contiguous(), *xs[1:], w, **kw)


# ---------------------------------------------------------------------------
# The decoder's phase-space kernels (ops/phase_conv.py): K5, K6, K7
# ---------------------------------------------------------------------------

def _check_conv(got, ref):
    """Stencil tolerance: both sides sum the same products in f32 and
    round once, so at bfloat16 two units in the last place of the element
    plus 2^-8 of the largest |output|; at float32 1e-4 of it."""
    torch.cuda.synchronize()
    bf16 = got.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = max(1.0, ref.abs().max().item())
    if bf16:
        ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
        tol = 2 * torch.where(ref == 0, 0.0, ulp) + 2.0 ** -8 * scale
    else:
        tol = TOL_F32 * scale
    assert (err <= tol).all(), (err.max().item(), (err / tol).max().item())


# An odd height and a pixel count (2 x 7 x 13 = 182) that is not a multiple
# of the kernel's 256-pixel tile.
PH, PW = 7, 13


def _phase_case(cuda, dtype, kind, shape=(2, PH, PW)):
    """(pp, pk, bias, table) of one stencil call over a (B, H, W) grid: "up"
    the upsample kernel (Cin 128 -> 4 x 64), "phase" the L1 phase-space
    kernel (4 x 64 -> 4 x 64), "dense" every (tap, input phase) block of
    4 x 64 -> 4 x 32 set, "l2" the L2 up-conv kernel (4 x 32 -> 16 x 32)."""
    from mastermetastyletransfer_tpu_torch.ops import conv as tconv
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    g = torch.Generator().manual_seed(3)
    if kind == "up":
        x = torch.randn((*shape, 128), generator=g)
        k = tconv._phase_kernel(0.05 * torch.randn((3, 3, 128, 64),
                                                   generator=g))
        pp, table, groups = tconv._edge_pad(x), tconv._UPSAMPLE_TABLE, 4
    elif kind == "phase":
        x = torch.randn((*shape, 256), generator=g)
        k = tconv._phase_space_kernel(0.05 * torch.randn((3, 3, 64, 64),
                                                         generator=g))
        pp, table, groups = tconv._edge_pad(x), tconv._phase_space_table(), 4
    elif kind == "dense":
        x = torch.randn((*shape, 256), generator=g)
        k = 0.03 * torch.randn((2, 2, 256, 128), generator=g)
        table = pc.GroupTable(tconv._L1_OFFSETS, (0xFFFF,) * 4, 4)
        pp, groups = tconv._edge_pad(x), 4
    else:
        x = torch.randn((*shape, 128), generator=g)
        k, _ = tconv._phase2_kernel(0.1 * torch.randn((3, 3, 32, 32),
                                                      generator=g), True)
        pp = tconv._phase2_pad(x, 2, 32, True)
        table, groups = tconv._phase2_table(True), 16
    bias = torch.randn(k.shape[-1] // groups, generator=g).repeat(groups)
    return (pp.to(cuda, dtype).contiguous(), k.to(cuda, dtype).contiguous(),
            bias.to(cuda), table)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["up", "phase", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil_phase_conv_matches_plain(cuda, dtype, kind):
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    pp, pk, bias, table = _phase_case(cuda, dtype, kind)
    before = pc.LAUNCHES["stencil_phase_conv"]
    got = pc.stencil_phase_conv(pp, pk, bias, table)
    assert pc.LAUNCHES["stencil_phase_conv"] == before + 1
    assert got.shape == (2, PH, PW, pk.shape[-1])
    _check_conv(got, pc.stencil_phase_conv_plain(pp, pk, bias, table))


# (H, W) around the tensor-core body's 8 x 16 pixel tile: 1, tile - 1,
# tile + 1; at B = 1.
RAGGED = [(1, 1), (7, 15), (9, 17), (1, 17), (9, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw", RAGGED)
@pytest.mark.parametrize("kind", ["up", "phase", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil_phase_conv_ragged_tiles(cuda, dtype, kind, hw):
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    pp, pk, bias, table = _phase_case(cuda, dtype, kind, (1, *hw))
    got = pc.stencil_phase_conv(pp, pk, bias, table)
    assert got.shape == (1, *hw, pk.shape[-1])
    _check_conv(got, pc.stencil_phase_conv_plain(pp, pk, bias, table))


@pytest.mark.cuda
def test_tensor_core_body_reports_its_attributes(cuda):
    """bf16 K5 and both K12 entries run the tensor-core body: its
    instantiations report dynamic shared memory once they have launched;
    the scalar-FMA body (K5 at f32) uses none."""
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    for kind in ("up", "phase"):
        pp, pk, bias, table = _phase_case(cuda, torch.bfloat16, kind)
        pc.stencil_phase_conv(pp, pk, bias, table)
        plan = pc.stencil_plan(table, "stencil", 2, PH, PW, pp.shape[-1],
                               pk.shape[-1] // 4, torch.bfloat16)
        smem, dyn, regs = pc.kernel_attributes(plan.kernel, torch.bfloat16)
        assert dyn >= plan.smem_bytes > 0 and regs > 0
    for dtype in (torch.float32, torch.bfloat16):
        for entry in ("stencil_phase2_rgb", "stencil_phase2_rgb128"):
            pp, pk, bias, bases = _rgb_case(cuda, dtype, entry)
            getattr(pc, entry)(pp, pk, bias, bases)
            plan = pc.stencil_plan(
                pc.rgb_table(tuple(int(v) for v in bases)),
                entry.replace("stencil_phase2_", ""),
                2, PH, PW, pp.shape[-1], pk.shape[-1] // 16, dtype)
            smem, dyn, regs = pc.kernel_attributes(plan.kernel, dtype)
            assert dyn >= plan.smem_bytes > 0 and regs > 0
        assert pc.kernel_attributes("stencil", dtype)[1] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("padcols", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil_phase2_conv_matches_plain(cuda, dtype, padcols):
    from mastermetastyletransfer_tpu_torch.ops import conv as tconv
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    pp, pk, bias, table = _phase_case(cuda, dtype, "l2")
    if padcols:
        cm = tconv._phase2_pad_maps(PW, 4, False)
        before = pc.LAUNCHES["stencil_phase2_conv_padcols"]
        got = pc.stencil_phase2_conv_padcols(pp, pk, bias, table, cm)
        assert pc.LAUNCHES["stencil_phase2_conv_padcols"] == before + 1
        assert got.shape == (2, PH, PW + 2, 512)
        _check_conv(got, pc.stencil_phase2_conv_padcols_plain(
            pp, pk, bias, table, cm))
        # the pad columns are exact copies of the kernel's own interior
        assert torch.equal(tconv._phase2_pad_rows(got, 4, 32),
                           tconv._phase2_pad(got[:, :, 1:-1], 4, 32, False))
    else:
        before = pc.LAUNCHES["stencil_phase2_conv"]
        got = pc.stencil_phase2_conv(pp, pk, bias, table)
        assert pc.LAUNCHES["stencil_phase2_conv"] == before + 1
        _check_conv(got, pc.stencil_phase2_conv_plain(pp, pk, bias, table))


# K6 at B = 1 on grids of 1, tile - 1 and tile + 1 rows by 1, tile - 1 and
# tile + 1 columns of the tensor-core body's 8 x 16 tile.
K6_RAGGED = [(h, w) for h in (1, 7, 9) for w in (1, 15, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw", K6_RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil_phase2_conv_ragged_tiles(cuda, dtype, hw):
    """Both K6 entries (the pad columns where W >= 2, which they need)
    against their plain versions on the tensor-core body: bf16 with the L2
    up-conv table compiled in, f32 its FMA form."""
    from mastermetastyletransfer_tpu_torch.ops import conv as tconv
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    pp, pk, bias, table = _phase_case(cuda, dtype, "l2", (1, *hw))
    got = pc.stencil_phase2_conv(pp, pk, bias, table)
    assert got.shape == (1, *hw, 512)
    _check_conv(got, pc.stencil_phase2_conv_plain(pp, pk, bias, table))
    if hw[1] >= 2:
        cm = tconv._phase2_pad_maps(hw[1], 4, False)
        got = pc.stencil_phase2_conv_padcols(pp, pk, bias, table, cm)
        assert got.shape == (1, hw[0], hw[1] + 2, 512)
        _check_conv(got, pc.stencil_phase2_conv_padcols_plain(
            pp, pk, bias, table, cm))
        torch.cuda.synchronize()
        # the pad columns are exact copies of the kernel's own interior
        for col, maps in ((0, cm[0]), (-1, cm[1])):
            want = pc.pad_border(lambda s: got[:, :, 1 + s], maps, 4, 32,
                                 False)
            assert torch.equal(got[:, :, col], want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_runs_the_tensor_core_body(cuda, dtype):
    """K6 runs the tensor-core body (at bf16 its compiled L2 up-conv
    table, at f32 the FMA form): its instantiation reports the dynamic
    shared memory of the plan it ran."""
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    pp, pk, bias, table = _phase_case(cuda, dtype, "l2")
    pc.stencil_phase2_conv(pp, pk, bias, table)
    plan = pc.stencil_plan(table, "phase2", 2, PH, PW, pp.shape[-1], 32,
                           dtype)
    assert plan.kernel == ("stencil2_tc16_l2up" if dtype == torch.bfloat16
                           else "stencil2_tc8")
    smem, dyn, regs = pc.kernel_attributes(plan.kernel, dtype)
    assert dyn >= plan.smem_bytes > 0 and regs > 0


@pytest.mark.cuda
def test_two_host_threads_launch_bit_equal(cuda):
    """F5: the shared-memory opt-in is per (kernel, device) and only
    rises, so two host threads launching one instantiation at two sizes --
    K1 and K2 (one kernel) at C = 128 and 256, K3 and K4 at 128 and 256, K5
    at conv1's and conv2's tables; K11 at two grids -- each 200 times,
    alternately and in
    opposite orders, never see a launch refused, and every output equals,
    bit for bit, the same call on one thread (these kernels sum in a fixed
    order)."""
    import threading

    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    calls = {}
    for c, heads in ((128, 4), (256, 8)):
        w, x, mask, padmask = _block_case(cuda, torch.bfloat16, c, heads)
        calls[f"k1_{c}"] = (lambda w=w, x=x, heads=heads, mask=mask,
                            padmask=padmask: wb.window_block_rows(
                                x, w, heads=heads, window=(7, 7),
                                shift=(3, 3), mask=mask, padmask=padmask))
        # K2 on the same kernel as K1, at the other entry
        xw = twin.window_partition(torch.roll(x, (-3, -3), (1, 2)), 7, 7)
        xw = xw.reshape(2, 9, 49, c).contiguous()
        calls[f"k2_{c}"] = (lambda w=w, xw=xw, heads=heads, mask=mask,
                            padmask=padmask: wb.window_block_windows(
                                xw, w, heads=heads, mask=mask,
                                padmask=padmask))
    for kind in ("up", "phase"):
        args = _phase_case(cuda, torch.bfloat16, kind)
        calls[f"k5_{kind}"] = lambda args=args: pc.stencil_phase_conv(*args)
    # K3 and K4 at two widths: each tensor-core kernel at two shared-memory
    # sizes
    for c, heads in ((256, 8), (128, 4)):
        w, xs, kw = _k3_case(cuda, c, heads, False, True)
        calls[f"k3_{c}"] = (lambda xs=xs, w=w, kw=kw: torch.stack(
            sb.encoder_scale_shift(*xs, w, **kw)))
        w, xs, kw = _k4_case(cuda, c, heads, True)
        calls[f"k4_{c}"] = (lambda xs=xs, w=w, kw=kw: sb.decoder_tail(
            *xs, w, **kw))
    # K11 at two grids of one width: its kernel, whose tickets wait on
    # flags, launched from both threads at once
    for grid in ((14, 14, 12, 12), (21, 21, 17, 16)):
        (w0, w1), x, pkw = _pair_case(cuda, torch.bfloat16, *grid)
        calls[f"k11_{grid[0]}"] = (
            lambda x=x, w0=w0, w1=w1, pkw=pkw: bpr.window_block_pair_rows(
                x, w0, w1, **pkw))
    want = {name: fn() for name, fn in calls.items()}
    torch.cuda.synchronize()
    names = list(calls)
    results, errors = {}, []

    def work(tag, order):
        try:
            outs = [(order[i % len(order)], calls[order[i % len(order)]]())
                    for i in range(200)]
            torch.cuda.synchronize()
            results[tag] = outs
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=("a", names)),
               threading.Thread(target=work, args=("b", names[::-1]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not errors, errors[0]
    assert set(results) == {"a", "b"}
    for outs in results.values():
        assert len(outs) == 200
        for name, got in outs:
            assert torch.equal(got, want[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_phase_align_is_exact(cuda, dtype):
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    g = torch.Generator().manual_seed(4)
    big = torch.randn((2, PH + 1, PW + 1, 256), generator=g).to(cuda, dtype)
    before = pc.LAUNCHES["phase_align"]
    got = pc.phase_align(big, 64)
    assert pc.LAUNCHES["phase_align"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, pc.phase_align_plain(big, 64))


@pytest.mark.cuda
def test_phase_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    pp, pk, bias, table = _phase_case(cuda, torch.float32, "phase")
    with pytest.raises(TypeError):        # weights of another type
        pc.stencil_phase_conv(pp, pk.to(torch.bfloat16), bias, table)
    with pytest.raises(ValueError):       # not contiguous
        pc.stencil_phase_conv(pp.transpose(1, 2), pk, bias, table)
    with pytest.raises(ValueError):       # C' not a multiple of 32
        pc.stencil_phase_conv(pp, pk[..., :240].contiguous(),
                              bias[:240].contiguous(), table)
    with pytest.raises(ValueError):       # 16 groups for K5
        pc.stencil_phase_conv(pp, pk, bias, table._replace(
            offsets=table.offsets * 4, blocks=table.blocks * 4))
    big = torch.zeros((2, 5, 5, 96), device=cuda)
    with pytest.raises(ValueError):       # C' = 24
        pc.phase_align(big, 24)


# ---------------------------------------------------------------------------
# The training kernels K8, K9 (ops/window_attention.py) and K10
# (ops/ln_mlp.py), forward and backward; the backward passes of K5 and K7;
# the evaluation kernels' refusal under autograd. The kernel path (the
# autograd Function on CUDA tensors) against torch.autograd of the plain
# forward on the same inputs. Gradients: at float32 1e-4 of the largest
# |grad| of the tensor; at bfloat16 two units in the last place plus 2^-6
# of that largest |grad|. A bias of the projections is scaled by the
# largest |grad| of all of them (the key bias's own gradient is zero up to
# rounding).
# ---------------------------------------------------------------------------

AB, ANW = 2, 4
# The attention cases: (images, windows, C, heads, grid, shift) -- a small
# one, and the training step's three shapes at 256^2: the Swin's stage 1
# (16 images, 100 windows of a 70 x 70 grid, C 128, 4 heads) and stage 2
# (25 windows of 35 x 35, C 256, 8 heads), the style transformer's (8
# contents, shift 4).
ATTN_SHAPES = {"small": (AB, ANW, C, HEADS, 14, 3),
               "swin_stage1": (16, 100, 128, 4, 70, 3),
               "swin_stage2": (16, 25, 256, 8, 35, 3),
               "style_transformer": (8, 25, 256, 8, 35, 4)}
ATTN_CASES = ([("small", torch.float32), ("small", torch.bfloat16)]
              + [(s, torch.bfloat16) for s in ATTN_SHAPES if s != "small"])


def _grad_check(got, ref, scale, dtype):
    """A gradient of a ``dtype`` computation against its reference."""
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if dtype == torch.float32:
        tol = TOL_F32 * scale
    else:
        ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
        tol = TOL_BF16_ULPS * torch.where(ref == 0, 0.0, ulp) \
            + TOL_BF16_UPDATE * scale
    assert (err <= tol).all(), (err.max().item(), (err / tol).max().item())


def _compare_grads(names, got, ref, dtype):
    vec = [r.abs().max().item() for n, r in zip(names, ref)
           if n.startswith("b")]
    for n, g, r in zip(names, got, ref):
        scale = (max(vec) if n.startswith("b")
                 else r.float().abs().max().item())
        _grad_check(g, r, scale, dtype)


def _attn_case(cuda, dtype, nv, shared=False, shape="small"):
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa

    b, nw, c, heads, grid, shift = ATTN_SHAPES[shape]
    g = torch.Generator().manual_seed(5 + nv)

    def proj():
        return [(torch.randn((c, c), generator=g) * c ** -0.5).to(cuda),
                (torch.randn(c, generator=g) * 0.1).to(cuda)]

    xs = [torch.randn((b, nw, 49, c), generator=g).to(cuda, dtype)
          for _ in range(2 + nv)]
    ws = [t for _ in range(4 if nv == 1 else 3) for t in proj()]
    if shared:
        ws[2:4] = ws[0:2]
    bias = (torch.randn((heads, 49, 49), generator=g) * 0.1).to(cuda)
    mask = torch.from_numpy(
        twin.shift_attention_mask(grid, grid, 7, 7, shift, shift)).to(cuda)
    gs = [torch.randn((b, nw, 49, c), generator=g).to(cuda, dtype)
          for _ in range(nv)]
    return xs, ws, bias, mask, gs


def _leaves(tensors):
    return [t.detach().clone().requires_grad_() for t in tensors]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", ATTN_CASES)
def test_window_attention_fwd_bwd_match_plain(cuda, dtype, shape):
    """K8 forward and backward, at a small shape at both types and at the
    training step's three attention shapes at bf16 (the backward's
    tensor-core body)."""
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa

    heads = ATTN_SHAPES[shape][3]
    xs, ws, bias, mask, (g,) = _attn_case(cuda, dtype, 1, shape=shape)
    names = ["q", "k", "v", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp",
             "rel_bias"]
    kern = _leaves(xs + ws + [bias])
    before = dict(wa.LAUNCHES)
    out = wa._WindowAttention.apply(*kern, mask, heads)
    got = torch.autograd.grad(out, kern, g)
    assert wa.LAUNCHES["window_attention"] == \
        before["window_attention"] + 1
    assert wa.LAUNCHES["window_attention_bwd"] == \
        before["window_attention_bwd"] + 1
    plain = _leaves(xs + ws + [bias])
    ref_out = wa.window_attention_plain(
        *plain[:3], *(wa.Proj(plain[i], plain[i + 1]) for i in (3, 5, 7, 9)),
        plain[11], mask, heads)
    ref = torch.autograd.grad(ref_out, plain, g)
    _check(out, ref_out, torch.zeros_like(ref_out))
    _compare_grads(names, got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("shape,dtype", ATTN_CASES)
def test_window_attention_dual_fwd_bwd_match_plain(cuda, dtype, shared,
                                                   shape):
    """K9 forward and backward, with its two value projections or one
    shared (the style encoder's form, whose gradient autograd sums), at a
    small shape at both types and at the training step's three attention
    shapes at bf16 (the backward's tensor-core body)."""
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa

    heads = ATTN_SHAPES[shape][3]
    xs, ws, bias, mask, gs = _attn_case(cuda, dtype, 2, shared, shape)
    names = ["q", "k", "vs", "vh", "wvs", "bvs", "wvh", "bvh", "wp", "bp",
             "rel_bias"]
    kern = _leaves(xs + ws + [bias])
    if shared:
        kern[6:8] = kern[4:6]
    before = dict(wa.LAUNCHES)
    outs = wa._WindowAttentionDual.apply(*kern, mask, heads)
    got = torch.autograd.grad(outs, kern, gs)
    assert wa.LAUNCHES["window_attention_dual_bwd"] == \
        before["window_attention_dual_bwd"] + 1
    plain = _leaves(xs + ws + [bias])
    if shared:
        plain[6:8] = plain[4:6]
    ref_outs = wa.window_attention_dual_plain(
        *plain[:4], *(wa.Proj(plain[i], plain[i + 1]) for i in (4, 6, 8)),
        plain[10], mask, heads)
    ref = torch.autograd.grad(ref_outs, plain, gs)
    for o, r in zip(outs, ref_outs):
        _check(o, r, torch.zeros_like(r))
    _compare_grads(names, got, ref, dtype)


def _attn_bwd_call(cuda, nv, shape, dtype=torch.bfloat16):
    """One K8 (nv 1) or K9 (nv 2) backward kernel call as a function of
    nothing, on the case's inputs."""
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa

    heads = ATTN_SHAPES[shape][3]
    xs, ws, bias, mask, gs = _attn_case(cuda, dtype, nv, shape=shape)
    projs = [wa.Proj(ws[i], ws[i + 1]) for i in range(0, len(ws), 2)]
    if nv == 1:
        return lambda: wa.window_attention_bwd_kernel(
            gs[0], *xs, *projs, bias, mask, heads)
    return lambda: wa.window_attention_dual_bwd_kernel(
        *gs, *xs, *projs, bias, mask, heads)


def _kernel_names(fn, stem):
    """The kernel names of one call of fn() in torch.profiler. The profiler
    now and then returns a session that holds none of the call's kernels
    (seen on the card, about once in 50 such sessions): profile again, up
    to three sessions, until a kernel whose name holds ``stem`` shows."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        if any(stem in n for n in names):
            break
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("shape", ["swin_stage1", "style_transformer"])
def test_attention_backward_runs_its_plans_body(cuda, nv, shape):
    """At bf16 the backward launches the tensor-core body (by name, in
    torch.profiler) and not the scalar one, in the plan's form, whose
    kernel reports the plan's shared memory and at most 128 registers; at
    f32 the scalar body."""
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa

    _, _, c, heads, _, _ = ATTN_SHAPES[shape]
    for dtype in (torch.bfloat16, torch.float32):
        fn = _attn_bwd_call(cuda, nv, shape, dtype)
        fn()
        torch.cuda.synchronize()
        names = _kernel_names(fn, "attn_bwd")
        tc = [n for n in names if "attn_bwd_tc_kernel" in n]
        scalar = [n for n in names if "attn_bwd_kernel" in n]
        plan = wa.attn_bwd_plan(49, c, heads, nv, dtype)
        if dtype == torch.bfloat16:
            assert plan.body == "tc" and len(tc) == 1 and not scalar, names
            smem, dyn, regs, local = wa.kernel_attributes(plan, dtype, nv,
                                                          True)
            assert smem == 0 and dyn >= plan.smem_bytes > 0
            assert 0 < regs <= 128 and local >= 0
        else:
            assert plan.body == "scalar" and len(scalar) == 1 and not tc, \
                names


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [1, 2])
def test_attention_backward_is_bit_equal_call_to_call(cuda, nv):
    """The tensor-core backward at the style transformer's shape gives the
    same bits on two calls: every sum -- the column sums, the bias and
    relative-bias partials, the weight gradients -- runs in a fixed
    order, with no atomics."""
    fn = _attn_bwd_call(cuda, nv, "style_transformer")
    a, b = fn(), fn()
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_attention_backward_two_host_threads_bit_equal(cuda):
    """F5 for the tensor-core backward: two host threads launch K8's and
    K9's backward at two shapes each (two kernels, two shared-memory sizes
    of K8's), 200 times each, alternately and in opposite orders; no launch
    is refused and every output equals, bit for bit, the same call on one
    thread."""
    import threading

    calls = {f"k{7 + nv}_{shape}": _attn_bwd_call(cuda, nv, shape)
             for nv in (1, 2) for shape in ("small", "style_transformer")}
    want = {name: fn() for name, fn in calls.items()}
    torch.cuda.synchronize()
    names = list(calls)
    results, errors = {}, []

    def work(tag, order):
        try:
            outs = [(order[i % len(order)], calls[order[i % len(order)]]())
                    for i in range(200)]
            torch.cuda.synchronize()
            results[tag] = outs
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=("a", names)),
               threading.Thread(target=work, args=("b", names[::-1]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not errors, errors[0]
    assert set(results) == {"a", "b"}
    for outs in results.values():
        assert len(outs) == 200
        for name, got in outs:
            for x, y in zip(got, want[name]):
                assert torch.equal(x, y), name


@pytest.mark.cuda
def test_attention_backward_refuses_a_wrong_plan(cuda, monkeypatch):
    """The backward's C entries check the tensor-core plan they are given
    against the layout and refuse a mismatch (a shared-memory size 16
    bytes off, or a form the body lacks) with cudaErrorInvalidValue,
    launching nothing; the wrappers raise."""
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa

    for nv in (1, 2):
        fn = _attn_bwd_call(cuda, nv, "small")
        plan = wa.attn_bwd_plan(49, C, HEADS, nv, torch.bfloat16)
        for change in (dict(smem_bytes=plan.smem_bytes + 16),
                       dict(kp=plan.kp * 2)):
            bad = plan._replace(**change)
            monkeypatch.setattr(wa, "attn_bwd_plan",
                                lambda *a, bad=bad: bad)
            before = dict(wa.LAUNCHES)
            with pytest.raises(RuntimeError, match="CUDA error 1 "):
                fn()
            assert wa.LAUNCHES == before
            monkeypatch.undo()


def _attn_fwd_call(cuda, nv, shape, dtype=torch.bfloat16):
    """One K8 (nv 1) or K9 (nv 2) forward kernel call as a function of
    nothing, on the case's inputs."""
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa

    heads = ATTN_SHAPES[shape][3]
    xs, ws, bias, mask, _ = _attn_case(cuda, dtype, nv, shape=shape)
    projs = [wa.Proj(ws[i], ws[i + 1]) for i in range(0, len(ws), 2)]
    fwd = (wa.window_attention_fwd_kernel if nv == 1
           else wa.window_attention_dual_fwd_kernel)
    return lambda: fwd(*xs, *projs, bias, mask, heads)


def _attn_fwd_plain(cuda, nv, shape, dtype=torch.bfloat16):
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa

    heads = ATTN_SHAPES[shape][3]
    xs, ws, bias, mask, _ = _attn_case(cuda, dtype, nv, shape=shape)
    projs = [wa.Proj(ws[i], ws[i + 1]) for i in range(0, len(ws), 2)]
    if nv == 1:
        return (wa.window_attention_plain(*xs, *projs, bias, mask, heads),)
    return wa.window_attention_dual_plain(*xs, *projs, bias, mask, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("shape", ["swin_stage1", "swin_stage2",
                                   "style_transformer"])
def test_attention_forward_runs_its_plans_body(cuda, nv, shape):
    """At bf16 the forward launches its tensor-core body (by name, in
    torch.profiler) and not the scalar one, in the plan's form, whose
    kernel reports the plan's shared memory, at most 128 registers and its
    spills (local memory); at f32 the scalar body."""
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa

    _, _, c, heads, _, _ = ATTN_SHAPES[shape]
    for dtype in (torch.bfloat16, torch.float32):
        fn = _attn_fwd_call(cuda, nv, shape, dtype)
        fn()
        torch.cuda.synchronize()
        names = _kernel_names(fn, "attn_fwd")
        tc = [n for n in names if "attn_fwd_tc_kernel" in n]
        scalar = [n for n in names if "attn_fwd_kernel" in n]
        plan = wa.attn_fwd_plan(49, c, heads, nv, dtype)
        if dtype == torch.bfloat16:
            assert plan.body == "tc" and len(tc) == 1 and not scalar, names
            smem, dyn, regs, local = wa.kernel_attributes(plan, dtype, nv,
                                                          False)
            assert smem == 0 and dyn >= plan.smem_bytes > 0
            assert 0 < regs <= 128 and local >= 0
        else:
            assert plan.body == "scalar" and len(scalar) == 1 and not tc, \
                names


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("shape", ["small", "swin_stage1", "swin_stage2",
                                   "style_transformer"])
def test_attention_forward_forms_match_plain(cuda, monkeypatch, nv, shape):
    """The forward's tensor-core body in each of its forms that fits the
    shape (ATTN_FWD_FORMS: two blocks of 8 warps an SM at C = 128 with one
    value stream, one block of 16 warps at every shape) against the plain
    forward, bf16: two units in the last place plus 2^-6 of the largest
    |output|."""
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa

    _, _, c, heads, _, _ = ATTN_SHAPES[shape]
    ref = _attn_fwd_plain(cuda, nv, shape)
    ran = 0
    for form in wa.ATTN_FWD_FORMS:
        monkeypatch.setattr(wa, "ATTN_FWD_FORMS", (form,))
        wa.attn_fwd_plan.cache_clear()
        if wa.attn_fwd_plan(49, c, heads, nv, torch.bfloat16).body == "tc":
            got = _attn_fwd_call(cuda, nv, shape)()
            for a, r in zip(got if nv == 2 else (got,), ref):
                _check(a, r, torch.zeros_like(r))
            ran += 1
        monkeypatch.undo()
        wa.attn_fwd_plan.cache_clear()
    assert ran == (2 if nv == 1 and c == 128 else 1)


@pytest.mark.cuda
def test_attention_forward_refuses_a_wrong_plan(cuda, monkeypatch):
    """The forward's C entries check the tensor-core plan they are given
    against the layout and refuse a mismatch (a shared-memory size 16
    bytes off, a ring the form lacks, another head-group width) with
    cudaErrorInvalidValue, launching nothing; the wrappers raise."""
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa

    for nv in (1, 2):
        plan = wa.attn_fwd_plan(49, C, HEADS, nv, torch.bfloat16)
        assert plan.body == "tc"
        fn = _attn_fwd_call(cuda, nv, "small")
        for change in (dict(smem_bytes=plan.smem_bytes + 16),
                       dict(stages=plan.stages + 1),
                       dict(panel=64)):
            bad = plan._replace(**change)
            monkeypatch.setattr(wa, "attn_fwd_plan",
                                lambda *a, bad=bad: bad)
            before = dict(wa.LAUNCHES)
            with pytest.raises(RuntimeError, match="CUDA error 1 "):
                fn()
            assert wa.LAUNCHES == before
            monkeypatch.undo()


@pytest.mark.cuda
def test_attention_forward_two_host_threads_bit_equal(cuda):
    """F5 for the tensor-core forward: two host threads launch K8's and
    K9's forward at two shapes each (K8 in both of its forms: two blocks an
    SM at C = 128, one at 256), 200 times each, alternately and in
    opposite orders; no launch is refused and every output equals, bit for
    bit, the same call on one thread."""
    import threading

    calls = {f"k{7 + nv}_{shape}": _attn_fwd_call(cuda, nv, shape)
             for nv in (1, 2) for shape in ("small", "style_transformer")}
    want = {name: fn() for name, fn in calls.items()}
    torch.cuda.synchronize()
    names = list(calls)
    results, errors = {}, []

    def work(tag, order):
        try:
            outs = [(order[i % len(order)], calls[order[i % len(order)]]())
                    for i in range(200)]
            torch.cuda.synchronize()
            results[tag] = outs
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=("a", names)),
               threading.Thread(target=work, args=("b", names[::-1]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not errors, errors[0]
    assert set(results) == {"a", "b"}
    for outs in results.values():
        assert len(outs) == 200
        for name, got in outs:
            got = got if isinstance(got, tuple) else (got,)
            ref = want[name] if isinstance(want[name], tuple) else (
                want[name],)
            for x, y in zip(got, ref):
                assert torch.equal(x, y), name


def _mlp_case(cuda, dtype, c, use_norm, seed=9):
    """K10's inputs: x and the output's gradient (3, 37, c) -- 111 rows,
    no multiple of either body's row tiles -- and its weights (hidden 4c),
    with or without the norm."""
    g = torch.Generator().manual_seed(seed)
    hidden = 4 * c
    x = torch.randn((3, 37, c), generator=g).to(cuda, dtype)
    gy = torch.randn((3, 37, c), generator=g).to(cuda, dtype)
    ws = [(torch.randn((c, hidden), generator=g) * c ** -0.5).to(cuda),
          (torch.randn(hidden, generator=g) * 0.1).to(cuda),
          (torch.randn((hidden, c), generator=g) * hidden ** -0.5).to(cuda),
          (torch.randn(c, generator=g) * 0.1).to(cuda)]
    if use_norm:
        ws += [(1 + 0.1 * torch.randn(c, generator=g)).to(cuda),
               (0.1 * torch.randn(c, generator=g)).to(cuda)]
    return x, gy, ws, [None] * (0 if use_norm else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [96, 128, 256])
@pytest.mark.parametrize("use_norm", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_mlp_residual_fwd_bwd_match_plain(cuda, dtype, use_norm, c):
    """K10 forward and backward, with and without its LayerNorm, at the
    Swin's stage-1 width (C = 128, hidden 512), the style transformer's
    (C = 256, hidden 1024) and C = 96 (hidden 384: the backward's ring of 4
    x 32 rows, its form where C % 64 != 0), over a row count that is no
    multiple of the kernels' row tiles; at bf16 the tensor-core bodies
    (mlp_plan), whose kernels report the plan's shared memory."""
    from mastermetastyletransfer_tpu_torch.ops import ln_mlp as lm

    x, gy, ws, pad = _mlp_case(cuda, dtype, c, use_norm)
    kern = _leaves([x] + ws)
    before = dict(lm.LAUNCHES)
    out = lm._LnMlpResidual.apply(*kern, *pad)
    got = torch.autograd.grad(out, kern, gy)
    assert lm.LAUNCHES == {k: v + 1 for k, v in before.items()}
    plain = _leaves([x] + ws)
    ref_out = lm.ln_mlp_residual_plain(*plain, *pad)
    ref = torch.autograd.grad(ref_out, plain, gy)
    _check(out, ref_out, x)
    for a, r in zip(got, ref):
        _grad_check(a, r, r.float().abs().max().item(), dtype)
    for backward in (False, True):
        plan = lm.mlp_plan(111, c, 4 * c, backward, dtype)
        assert plan.body == ("tc" if dtype == torch.bfloat16 else "scalar")
        if backward and plan.body == "tc":
            assert (plan.kp, plan.stages) == ((64, 2) if c % 64 == 0
                                              else (32, 4))
        smem, dyn, regs, local = lm.kernel_attributes(plan, dtype, backward)
        assert dyn >= lm.smem_bytes(plan, c, 4 * c, dtype, backward) > 0
        assert regs > 0 and local >= 0
        if plan.body == "tc":
            assert smem == 0


@pytest.mark.cuda
def test_ln_mlp_entries_refuse_a_wrong_plan(cuda, monkeypatch):
    """K10's C entries check the tensor-core plan they are given against
    the layout and refuse a mismatch (a shared-memory size 16 bytes off, or
    a ring the body lacks) with cudaErrorInvalidValue, launching nothing;
    the wrappers raise."""
    from mastermetastyletransfer_tpu_torch.ops import ln_mlp as lm

    x, gy, ws, _ = _mlp_case(cuda, torch.bfloat16, 256, True)
    plans = {b: lm.mlp_plan(111, 256, 1024, b, torch.bfloat16)
             for b in (False, True)}
    for change in (dict(smem_bytes=16), dict(stages=1)):
        bad = {b: p._replace(**{k: getattr(p, k) + v
                                for k, v in change.items()})
               for b, p in plans.items()}
        monkeypatch.setattr(lm, "mlp_plan", lambda r, c, h, b, t: bad[b])
        before = dict(lm.LAUNCHES)
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            lm.ln_mlp_residual_fwd_kernel(x, *ws)
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            lm.ln_mlp_residual_bwd_kernel(gy, x, *ws[:3], *ws[4:])
        assert lm.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_kernel_gradients_are_deterministic(cuda, dtype):
    """The weight, bias and relative-bias gradients are sums over every
    window or row, reduced in a fixed order: two runs give the same bits,
    K8's and K10's (at bf16 the tensor-core bodies and weight-gradient
    product)."""
    from mastermetastyletransfer_tpu_torch.ops import ln_mlp as lm
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa

    xs, ws, bias, mask, (g,) = _attn_case(cuda, dtype, 1)
    x, gy, mws, _ = _mlp_case(cuda, dtype, 256, True)
    runs = []
    for _ in range(2):
        kern = _leaves(xs + ws + [bias])
        out = wa._WindowAttention.apply(*kern, mask, HEADS)
        grads = torch.autograd.grad(out, kern, g)
        kern = _leaves([x] + mws)
        out = lm._LnMlpResidual.apply(*kern)
        runs.append(grads + torch.autograd.grad(out, kern, gy))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["up", "phase", "align"])
def test_decoder_kernel_backward_matches_plain(cuda, kind):
    """K5 (the upsample and L1 forms) and K7 on the card carry gradients:
    their Functions' plain backward against autograd of the plain forward,
    float32 with TF32 off."""
    from mastermetastyletransfer_tpu_torch.models.master import _TF32_OFF
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    with _TF32_OFF:
        if kind == "align":
            g = torch.Generator().manual_seed(4)
            big = torch.randn((2, PH + 1, PW + 1, 256), generator=g).to(cuda)
            gy = torch.randn((2, PH, PW, 256), generator=g).to(cuda)
            (a,) = _leaves([big])
            (got,) = torch.autograd.grad(pc.phase_align(a, 64), a, gy)
            (b,) = _leaves([big])
            (ref,) = torch.autograd.grad(pc.phase_align_plain(b, 64), b, gy)
            assert torch.equal(got, ref)
            return
        pp, pk, bias, table = _phase_case(cuda, torch.float32, kind)
        gy = torch.randn((2, PH, PW, pk.shape[-1]),
                         generator=torch.Generator().manual_seed(6)).to(cuda)
        kern = _leaves([pp, pk, bias])
        out = pc.stencil_phase_conv(*kern, table)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, kern, gy)
        # the conv without its ReLU, fed the cotangent through the kernel's
        # own ReLU mask: an output of nearly 0 that the two forwards round
        # to opposite signs routes the gradient differently, no error of
        # the backward
        plain = _leaves([pp, pk, bias])
        ref = torch.autograd.grad(
            pc.stencil_phase_conv_plain(*plain, table, relu=False), plain,
            gy * (out.detach() > 0))
        for a, r in zip(got, ref):
            _grad_check(a, r, r.abs().max().item(), torch.float32)


@pytest.mark.cuda
def test_eval_kernels_refuse_autograd_on_the_card(cuda):
    """An evaluation kernel (K2 here; K1, K3, K4 and K6 with pad columns
    share the guard) raises under autograd and launches nothing; under
    no_grad it runs."""
    w, x, mask, padmask = _inputs(cuda, torch.float32, True)
    xw = x[:, :14, :14].reshape(2, 4, 49, C).contiguous()
    xw.requires_grad_()
    before = wb.LAUNCHES["window_block_windows"]
    with pytest.raises(RuntimeError, match="no backward"):
        wb.window_block_windows(xw, w, heads=HEADS)
    assert wb.LAUNCHES["window_block_windows"] == before
    with torch.no_grad():
        wb.window_block_windows(xw, w, heads=HEADS)
    assert wb.LAUNCHES["window_block_windows"] == before + 1


# ---------------------------------------------------------------------------
# The Swin block pair (ops/block_pair.py): K11
# ---------------------------------------------------------------------------

def _pair_case(cuda, dtype, hp, wp, vh, vw, c=C, heads=HEADS):
    """Two blocks' weights (non-trivial norms), a (2, hp, wp, c) image of
    which vh x vw tokens are valid, and the K11 keywords at shift 3."""
    g = torch.Generator().manual_seed(7)
    acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                           shift_size=(3, 3))
    ws = []
    for _ in range(2):
        params = init_style_swin_block(g, acfg, use_norm=True,
                                       exclude_mlp=False, mlp_ratio=4.0)
        for name in ("norm1", "norm2"):
            params[name] = {"scale": 1 + 0.3 * torch.randn(c, generator=g),
                            "bias": 0.3 * torch.randn(c, generator=g)}
        ws.append(wb.block_weights(tree_map(lambda t: t.to(cuda), params),
                                   (7, 7), dtype, True))
    x = torch.randn((2, hp, wp, c), generator=g).to(cuda, dtype)
    sh, sw = twin.effective_shift(hp, wp, (7, 7), (3, 3))
    kw = dict(heads=heads, window=(7, 7), shift=(sh, sw),
              mask1=torch.from_numpy(twin.shift_attention_mask(
                  hp, wp, 7, 7, sh, sw)).to(cuda),
              padmask0=torch.from_numpy(twin.valid_token_mask(
                  vh, vw, hp, wp, 7, 7, 0, 0)).to(cuda),
              padmask1=torch.from_numpy(twin.valid_token_mask(
                  vh, vw, hp, wp, 7, 7, sh, sw)).to(cuda))
    return ws, x, kw


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(21, 21, 17, 16), (14, 35, 12, 30),
                                  (14, 14, 14, 14)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_pair_matches_plain_and_k1_twice(cuda, dtype, grid):
    """K11 against its plain version, and bit for bit against K1's row
    entry applied twice: both run the same per-window body (the scalar one
    at f32, the tensor-core one at bf16) with the same plan."""
    (w0, w1), x, kw = _pair_case(cuda, dtype, *grid)
    before = bpr.LAUNCHES["window_block_pair_rows"]
    got = bpr.window_block_pair_rows(x, w0, w1, **kw)
    assert bpr.LAUNCHES["window_block_pair_rows"] == before + 1
    _check(got, bpr.window_block_pair_rows_plain(x, w0, w1, **kw), x)
    y0 = wb.window_block_rows(x, w0, heads=kw["heads"], window=(7, 7),
                              shift=(0, 0), padmask=kw["padmask0"])
    y1 = wb.window_block_rows(y0, w1, heads=kw["heads"], window=(7, 7),
                              shift=kw["shift"], mask=kw["mask1"],
                              padmask=kw["padmask1"])
    torch.cuda.synchronize()
    assert torch.equal(got, y1)


# K11's tensor-core body: stage 1's width (two blocks of 8 warps an SM),
# stage 2's (one of 16), and head dims 16 and 64 in either form, on a grid
# of 2 x 2 windows, whose block 1 wraps (its last window row and column
# read row and column 0), and on a ragged 3 x 5 one.
K11_WIDTHS = [(128, 4), (256, 8), (64, 4), (256, 4)]
K11_GRIDS = [(14, 14, 12, 12), (21, 35, 16, 30)]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", K11_GRIDS)
@pytest.mark.parametrize("c,heads", K11_WIDTHS)
def test_k11_tensor_core_body_matches_plain(cuda, c, heads, grid):
    """K11 at bf16 runs K1's tensor-core body per ticket in K1's form for
    the width (pair_plan), against the plain version and bit for bit
    against K1 applied twice; its kernel reports the plan's shared
    memory."""
    (w0, w1), x, kw = _pair_case(cuda, torch.bfloat16, *grid, c=c,
                                 heads=heads)
    plan = bpr.pair_plan(49, c, heads, 4 * c, torch.bfloat16)
    assert plan == wb.block_plan("window_block_rows", 49, c, heads, 4 * c,
                                 torch.bfloat16)
    assert plan.body == "tc" and plan.blocks_per_sm == (2 if c <= 128 else 1)
    before = bpr.LAUNCHES["window_block_pair_rows"]
    got = bpr.window_block_pair_rows(x, w0, w1, **kw)
    assert bpr.LAUNCHES["window_block_pair_rows"] == before + 1
    _check(got, bpr.window_block_pair_rows_plain(x, w0, w1, **kw), x)
    y0 = wb.window_block_rows(x, w0, heads=heads, window=(7, 7),
                              shift=(0, 0), padmask=kw["padmask0"])
    y1 = wb.window_block_rows(y0, w1, heads=heads, window=(7, 7),
                              shift=kw["shift"], mask=kw["mask1"],
                              padmask=kw["padmask1"])
    torch.cuda.synchronize()
    assert torch.equal(got, y1)
    smem, dyn, regs = bpr.kernel_attributes(plan, torch.bfloat16, c // heads)
    assert smem == 0 and dyn >= plan.smem_bytes > 0 and regs > 0


@pytest.mark.cuda
def test_k11_block1_load_policy(cuda):
    """The y0 load of K11's block 1 (csrc/block_pair.cu's probe): one
    thread block reads a y0 tile, waits on a flag as block 1 waits, and
    reads it again after another thread block (on another SM) overwrote it
    and published as block 0 publishes. Through L2 only (__ldcg, the
    policy K11's block 1 runs) the second reading is the fresh tile, every
    element, with the reader's fences or without. With them (K11's
    protocol: each __threadfence() drops the SM's L1 lines) no policy
    reads a stale element; without them the forced wrong policies -- a
    plain load and the read-only path -- read the first reading's lines
    again, so the policy is what keeps block 1 right should its fence
    move."""
    g = torch.Generator().manual_seed(11)
    stale = {}
    for fence in (True, False):
        for policy in bpr.LOAD_POLICIES:
            for _ in range(5):
                old = torch.randn((49, 128), generator=g).to(
                    cuda, torch.bfloat16)
                fresh = (old.float() + 1.0 + torch.rand(
                    (49, 128), generator=g).to(cuda)).to(torch.bfloat16)
                y = old.clone()
                first, second = bpr.load_probe(y, fresh, policy, fence)
                torch.cuda.synchronize()
                assert torch.equal(first, old) and torch.equal(y, fresh)
                n = (second != fresh).sum().item()
                stale[policy, fence] = stale.get((policy, fence), 0) + n
    print("stale elements of 5 x 6272 per (policy, fence):", stale)
    assert all(stale[p, True] == 0 for p in bpr.LOAD_POLICIES)
    assert stale["l2", False] == 0
    assert stale["plain", False] > 0 and stale["read_only", False] > 0


@pytest.mark.cuda
def test_block_pair_swin_s_width_matches_plain(cuda):
    """swin_S's stage-2 width (C = 192, 6 heads) takes the form block_plan
    gives it (one block of 16 warps an SM)."""
    (w0, w1), x, kw = _pair_case(cuda, torch.bfloat16, 14, 14, 10, 10,
                                 c=192, heads=6)
    plan = bpr.pair_plan(49, 192, 6, 768, torch.bfloat16)
    assert (plan.body, plan.blocks_per_sm) == ("tc", 1)
    _check(bpr.window_block_pair_rows(x, w0, w1, **kw),
           bpr.window_block_pair_rows_plain(x, w0, w1, **kw), x)


# ---------------------------------------------------------------------------
# The RGB-tail kernel (ops/phase_conv.py): K12
# ---------------------------------------------------------------------------

def _rgb_case(cuda, dtype, entry):
    """conv8 on an L2 tensor of 16 x 32 channels at (2, PH, PW): pp, the
    composed kernel (in 8-lane slots for the rgb128 entry), its f32 bias and
    the bases."""
    from mastermetastyletransfer_tpu_torch.ops import conv as tconv

    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, PH, PW, 512), generator=g)
    k, bases = tconv._phase2_kernel(0.1 * torch.randn((3, 3, 32, 3),
                                                      generator=g), False)
    bias = torch.randn(3, generator=g).repeat(16)
    if entry == "stencil_phase2_rgb128":
        k, bias = tconv._slots128(k, 3), tconv._slots128(bias, 3)
    pp = tconv._phase2_pad(x, 4, 32, False)
    return (pp.to(cuda, dtype).contiguous(), k.to(cuda, dtype).contiguous(),
            bias.to(cuda), bases)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["dense", "l2"])
@pytest.mark.parametrize("entry", ["stencil_phase2_rgb",
                                   "stencil_phase2_rgb128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rgb_tail_matches_plain(cuda, dtype, entry, table):
    from mastermetastyletransfer_tpu_torch.ops import conv as tconv
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    pp, pk, bias, bases = _rgb_case(cuda, dtype, entry)
    tab = tconv._phase2_table(False) if table == "l2" else None
    before = pc.LAUNCHES[entry]
    got = getattr(pc, entry)(pp, pk, bias, bases, table=tab)
    assert pc.LAUNCHES[entry] == before + 1
    _check_conv(got, getattr(pc, entry + "_plain")(pp, pk, bias, bases))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", RAGGED)
@pytest.mark.parametrize("table", ["dense", "l2"])
@pytest.mark.parametrize("entry", ["stencil_phase2_rgb",
                                   "stencil_phase2_rgb128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rgb_tail_ragged_tiles(cuda, dtype, entry, table, hw):
    """K12 over a (1, H, W) grid around the 8 x 16 tile: pp random (the
    kernel takes any L2 input), the kernel zero outside the table's blocks
    for the L2 table."""
    from mastermetastyletransfer_tpu_torch.ops import conv as tconv
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    _, pk, bias, bases = _rgb_case(cuda, dtype, entry)
    g = torch.Generator().manual_seed(10)
    pp = torch.randn((1, hw[0] + 2, hw[1] + 2, 512),
                     generator=g).to(cuda, dtype)
    tab = tconv._phase2_table(False) if table == "l2" else None
    got = getattr(pc, entry)(pp, pk, bias, bases, table=tab)
    _check_conv(got, getattr(pc, entry + "_plain")(pp, pk, bias, bases))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["stencil_phase2_rgb",
                                   "stencil_phase2_rgb128"])
def test_rgb_tail_backward_matches_plain(cuda, entry):
    """K12 on the card carries gradients: its Function's plain backward
    against autograd of the plain forward, float32 with TF32 off."""
    from mastermetastyletransfer_tpu_torch.models.master import _TF32_OFF
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    with _TF32_OFF:
        pp, pk, bias, bases = _rgb_case(cuda, torch.float32, entry)
        kern = _leaves([pp, pk, bias])
        out = getattr(pc, entry)(*kern, bases)
        assert out.grad_fn is not None
        gy = torch.randn(out.shape,
                         generator=torch.Generator().manual_seed(9)).to(cuda)
        got = torch.autograd.grad(out, kern, gy)
        plain = _leaves([pp, pk, bias])
        ref = torch.autograd.grad(
            getattr(pc, entry + "_plain")(*plain, bases), plain, gy)
        for a, r in zip(got, ref):
            _grad_check(a, r, r.abs().max().item(), torch.float32)


# ---------------------------------------------------------------------------
# The patch-embed kernel (ops/patch_embed.py): K13
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_patch_embed_matches_plain(cuda, dtype, use_ln):
    g = torch.Generator().manual_seed(10)
    # 10 rows: the last 2 (below the last whole patch row) are dropped
    img = torch.randn((2, 10, 140, 3), generator=g).to(cuda, dtype)
    k = (0.1 * torch.randn((4, 4, 3, 96), generator=g)).to(cuda)
    vecs = [(0.1 * torch.randn(96, generator=g)).to(cuda) for _ in range(3)]
    vecs[1] = vecs[1] + 1
    args = (img, k, *(vecs if use_ln else vecs[:1]))
    before = tpe.LAUNCHES["patch_embed"]
    got = tpe.patch_embed(*args)
    assert tpe.LAUNCHES["patch_embed"] == before + 1
    assert got.shape == (2, 2, 35, 96)
    ref = tpe.patch_embed_plain(*args)
    _check(got, ref, torch.zeros_like(ref))


@pytest.mark.cuda
def test_pair_and_patch_embed_refuse_autograd_on_the_card(cuda):
    """K11 and K13 have no backward: under autograd they raise and launch
    nothing; under no_grad they run."""
    (w0, w1), x, kw = _pair_case(cuda, torch.float32, 14, 14, 14, 14)
    img = torch.rand((1, 8, 8, 3), device=cuda)
    k = torch.randn((4, 4, 3, 32), device=cuda)
    bias = torch.zeros(32, device=cuda)
    for counts, entry, call, leaf in (
            (bpr.LAUNCHES, "window_block_pair_rows",
             lambda t: bpr.window_block_pair_rows(t, w0, w1, **kw), x),
            (tpe.LAUNCHES, "patch_embed",
             lambda t: tpe.patch_embed(img, t, bias), k)):
        before = counts[entry]
        with pytest.raises(RuntimeError, match="no backward"):
            call(leaf.clone().requires_grad_())
        assert counts[entry] == before
        with torch.no_grad():
            call(leaf)
        assert counts[entry] == before + 1
