"""The port's whole band-owned stylize against JAX's single-device
``master_apply`` and JAX's band path, as tests/test_torch_parallel_wide.py,
with the Swin and style-transformer kernels on (``use_pallas``) and their
branches taken: JAX runs its kernels in interpret mode, which takes them
at f32 on the CPU; the port's band gate takes them at bf16 only (JAX's
hardware gate), so each rank here widens it to f32
(spatial_shmap.KERNEL_DTYPES), and every K1-K4 entry JAX's gate picks is
called as often as chip_smoke.py's table says, running its plain version
on the CPU. 64x96, n = 2 and 4, k = 1 and 3; per-pixel MAE <= 1e-5
of the mean output magnitude, max-abs <= 2e-4
(tests/torch_parallel_jax.py)."""

import pytest

from tests import torch_parallel_jax as tpj
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def case():
    return tpj.stylize_case((64, 96), pallas=True,
                            kernel_dtypes=("bfloat16", "float32"))


@pytest.mark.parametrize("k", tpj.KS)
@pytest.mark.parametrize("n", tpj.BANDS)
def test_band_stylize_matches_jax(case, n, k):
    got = case["port"][(n, k)]
    tpj.assert_close(got, case["jax_master"][k], "master_apply")
    tpj.assert_close(got, case["jax_shmap"][(n, k)], "band path")
    for rank_calls in case["calls"][n]:
        assert rank_calls[f"k{k}"] == tpj.band_kernel_calls(k, n)
