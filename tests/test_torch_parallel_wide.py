"""The port's whole band-owned stylize against JAX's single-device
``master_apply`` and JAX's band path at the same band count, as
tests/test_torch_parallel_stylize.py, on 64x96 images (W pads to 14 and
28 window columns): the kernels off, n = 2 and 4, k = 1 and 3; per-pixel
MAE <= 1e-5 of the mean output magnitude, max-abs <= 2e-4. And at bf16
with the kernels (their plain versions here): each rank calls the kernel
entries of JAX's band gate as chip_smoke.py's table says, and the output
is within chip_smoke.py's bf16 noise verdict of the single-device bf16
``master_apply``. And the style transformer's other branches, in one
configuration, against JAX's."""

import pytest
import torch

from mastermetastyletransfer_tpu_torch.models.master import master_apply
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    init_style_transformer,
)

import chip_smoke
from tests import torch_parallel_jax as tpj
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def case():
    return tpj.stylize_case((64, 96), pallas=False)


@pytest.mark.parametrize("k", tpj.KS)
@pytest.mark.parametrize("n", tpj.BANDS)
def test_band_stylize_matches_jax(case, n, k):
    got = case["port"][(n, k)]
    tpj.assert_close(got, case["jax_master"][k], "master_apply")
    tpj.assert_close(got, case["jax_shmap"][(n, k)], "band path")
    for rank_calls in case["calls"][n]:
        assert not any(rank_calls[f"k{k}"].values())   # f32, kernels off


@pytest.mark.parametrize("n", tpj.BANDS)
def test_bf16_bands_within_the_noise_of_one_device(case, n):
    cfg = chip_smoke.slice_config("bfloat16", True)
    c, s = case["c"], case["s"]
    ct, st = torch.from_numpy(c), torch.from_numpy(s)
    with torch.inference_mode():
        single = master_apply(case["pt"], ct, st, cfg, k=1).numpy()
        ref32 = master_apply(case["pt"], ct, st,
                             chip_smoke.reference_config("float32"),
                             k=1).numpy()
    got, calls = tpj.port_bands(case["pt"], cfg, c, s, n,
                                [("bf16", 1, "shmap")])
    want = {e: v for e, v in chip_smoke.spatial_per_call(
        "bfloat16", True, 1, n).items() if v}
    for rank_calls in calls:
        assert {e: v for e, v in rank_calls["bf16"].items() if v} == want
    verdict = chip_smoke.bf16_noise_verdict(got["bf16"], single, ref32)
    assert verdict["ok"], verdict


def test_other_transformer_branches_match_jax(case):
    """The style transformer's other branches on bands, in one
    configuration: the exclude-MLP decoder self block (JAX's plain band
    attention and residual), LN1 on the encoder, Scale and Shift from the
    unprocessed Key, the Key IN before its linear, the INs' affine (with
    weights away from the identity); n = 4, k = 2."""
    cj, ct = tpj.configs(False)
    flags = dict(decoder_exclude_MLP_after_Fcs_self_MHA=True,
                 encoder_use_norm=True,
                 encoder_if_use_processed_Key_in_Scale_and_Shift_calculation=(
                     False),
                 decoder_use_Key_instance_norm_after_linear_transformation=(
                     False),
                 decoder_use_instance_norm_with_affine=True)
    cj = cj.replace(transformer=cj.transformer.replace(**flags))
    ct = ct.replace(transformer=ct.transformer.replace(**flags))
    g = torch.Generator().manual_seed(7)
    pt = dict(case["pt"], style_transformer=init_style_transformer(
        g, ct.transformer))
    for name in ("in_q", "in_k"):
        pt["style_transformer"]["decoder"][name] = {
            "scale": 1 + 0.3 * torch.randn(256, generator=g),
            "bias": 0.3 * torch.randn(256, generator=g)}
    pj = tpj.jax_tree(pt)
    c, s = case["c"], case["s"]
    got, _ = tpj.port_bands(pt, ct, c, s, 4, [("k2", 2, "shmap")])
    tpj.assert_close(got["k2"], tpj.jax_master(pj, cj, c, s, 2),
                     "master_apply")
    tpj.assert_close(got["k2"], tpj.jax_shmap(pj, cj, c, s, 2, 4),
                     "band path")
