"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor tests/conftest.py's fixtures, so that it also runs on a
machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance, element by element, as chip_smoke.py states it: at float32
1e-4 of the largest magnitude of the plain output (order of sums); at
bfloat16 two units in the last place of the plain output element (a value
near a rounding boundary may land on either side) plus 2^-6 of the block's
largest update |out - x| (intermediates rounded on either side of a
boundary).
"""

import pytest
import torch

from mastermetastyletransfer_tpu_torch.config import AttentionConfig
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    init_style_swin_block,
)
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
