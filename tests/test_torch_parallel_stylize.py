"""The port's whole band-owned stylize (parallel/spatial_shmap.py
``make_spatial_stylize_shmap``) against JAX's single-device
``master_apply`` and JAX's own band path at the same band count, on the
CPU: 64x64 images, the Swin and style-transformer kernels off, n = 2 and
4 bands, k = 1 and 3; the hybrid (data 2, space 2) mesh at batch 2; the
port's ``make_spatial_stylize`` against JAX's (GSPMD there, the band path
here; both with the plain decoder). Per-pixel MAE <= 1e-5 of the mean
output magnitude, max-abs <= 2e-4 (tests/torch_parallel_jax.py). The
kernels on, and 64x96: tests/test_torch_parallel_{pallas,wide,
wide_pallas}.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from mastermetastyletransfer_tpu.parallel.spatial import (
    make_spatial_stylize as jmake_spatial_stylize,
)
from mastermetastyletransfer_tpu.parallel import make_mesh as jmake_mesh

from tests import torch_parallel_jax as tpj
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def case():
    """At batch 2, which the hybrid mesh splits."""
    return tpj.stylize_case((64, 64), pallas=False, b=2)


@pytest.mark.parametrize("k", tpj.KS)
@pytest.mark.parametrize("n", tpj.BANDS)
def test_band_stylize_matches_jax(case, n, k):
    got = case["port"][(n, k)]
    tpj.assert_close(got, case["jax_master"][k], "master_apply")
    tpj.assert_close(got, case["jax_shmap"][(n, k)], "band path")
    for rank_calls in case["calls"][n]:
        assert not any(rank_calls[f"k{k}"].values())   # f32, kernels off


def test_hybrid_mesh_matches_jax(case):
    """(data 2, space 2) at batch 2: the batch splits over data, the bands
    over space, the statistics sum over space alone."""
    cj, ct = tpj.configs(False)
    c, s = case["c"], case["s"]
    got, _ = tpj.port_bands(case["pt"], ct, c, s, 4, [("k1", 1, "shmap")],
                            hybrid=True)
    tpj.assert_close(got["k1"], case["jax_master"][1], "master_apply")
    tpj.assert_close(got["k1"], tpj.jax_shmap(case["pj"], cj, c, s, 1, 4,
                                              hybrid=True), "band path")


def test_make_spatial_stylize_matches_jax(case):
    """The entry of parallel/spatial.py: JAX's is GSPMD on its plain
    decoder, the port's the band path with the plain decoder forced."""
    cj, ct = tpj.configs(False)
    c, s = case["c"], case["s"]
    got, _ = tpj.port_bands(case["pt"], ct, c, s, 2, [("k1", 1, "spatial")])
    want = np.asarray(jmake_spatial_stylize(
        cj, jmake_mesh(2, axis_names=("space",)), k=1)(
            case["pj"], jnp.asarray(c), jnp.asarray(s)))
    tpj.assert_close(got["k1"], want, "make_spatial_stylize")
    tpj.assert_close(got["k1"], case["jax_master"][1], "master_apply")
