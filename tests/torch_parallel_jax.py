"""The JAX side of the whole band stylize's tests
(tests/test_torch_parallel_stylize*.py), shared by them: the model's JAX
weights and their port copy, JAX's references (the single-device
``master_apply`` and the band-owned ``make_spatial_stylize_shmap`` at the
same band count, on the 8-device CPU mesh of tests/conftest.py, kernels in
interpret mode where ``use_pallas``), and the port's outputs from gloo
ranks (tests/torch_parallel_workers.py).

Bounds: max-abs <= 2e-4 (JAX's own band test's, tests/test_spatial_shmap.py:
112) and per-pixel MAE <= 1e-5 of the mean output magnitude (at least 1).
On these standard-normal inputs (JAX's band test's) f32's order of sums
alone moves the MAE past an absolute 1e-5 at k = 3: there the port's
single-device master_apply sits at 1.13e-5 from JAX's master_apply, and
JAX's own band path at n = 4 at 8.2e-6 (mean |output| 2.6; measured by
scripts/torch_band_noise.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.models import master as jmaster
from mastermetastyletransfer_tpu.parallel import make_mesh as jmake_mesh
from mastermetastyletransfer_tpu.parallel import spatial_shmap as jss
from mastermetastyletransfer_tpu.parallel.spatial import make_hybrid_mesh
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.parallel.launch import spawn_ranks
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    params_from_jax, tree_map,
)

import chip_smoke
from tests import torch_parallel_workers as workers

MAE, MAX_ABS = 1e-5, 2e-4
BANDS, KS = (2, 4), (1, 3)


def model():
    """Params of ModelConfig (swin_B widths) as JAX takes them (numpy
    leaves, JAX's tree) and the port's copy through params_from_jax. They
    are drawn by the port's initializer, JAX's tree and shapes
    (tests/test_torch_models.py checks the two trees), which takes a
    second where JAX's takes fifteen on the CPU."""
    pj = jax_tree(init_master_model(tcfg.ModelConfig(),
                                    torch.Generator().manual_seed(0),
                                    device="cpu"))
    return pj, params_from_jax(pj)


def jax_tree(pt):
    """A port params tree as JAX takes it: numpy copies of the leaves (not
    views: a tensor sent to a spawned rank moves to shared memory, and a
    view of its old storage would read freed memory)."""
    return tree_map(lambda t: t.numpy().copy(), pt)


def configs(pallas: bool):
    """(JAX's config, the port's) with the Swin and style-transformer
    kernels on or off (the decoder's as ModelConfig has them: off)."""
    cj = jcfg.ModelConfig()
    cj = cj.replace(swin=cj.swin.replace(use_pallas=pallas),
                    transformer=cj.transformer.replace(use_pallas=pallas))
    return cj, tcfg.ModelConfig.from_dict(cj.to_dict())


def images(h, w, b, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, w, 3)).astype(np.float32)
                 for _ in range(2))


def jax_master(pj, cj, c, s, k):
    return np.asarray(jax.jit(functools.partial(
        jmaster.master_apply, cfg=cj, k=k))(pj, jnp.asarray(c),
                                            jnp.asarray(s)))


def jax_shmap(pj, cj, c, s, k, n, hybrid=False):
    if hybrid:
        mesh, data_axis = make_hybrid_mesh(2, n // 2), "data"
    else:
        mesh, data_axis = jmake_mesh(n, axis_names=("space",)), None
    return np.asarray(jss.make_spatial_stylize_shmap(
        cj, mesh, k=k, data_axis=data_axis)(pj, jnp.asarray(c),
                                            jnp.asarray(s)))


def port_bands(pt, ct, c, s, n, runs, hybrid=False, kernel_dtypes=None):
    """The port's band stylize of each run (label, k, entry) in n gloo
    ranks: {label: output}, and each rank's kernel-entry calls.
    ``kernel_dtypes``: torch_parallel_workers.band_stylize's."""
    res = spawn_ranks(workers.band_stylize, n, backend="gloo", device="cpu",
                      args=(pt, c, s, [(label, ct, k, entry)
                                       for label, k, entry in runs], hybrid,
                            kernel_dtypes))
    return res[0]["outputs"], [r["calls"] for r in res]


def stylize_case(hw, pallas: bool, b: int = 1, seed: int = 0,
                 kernel_dtypes=None):
    """Everything one file's tests compare: JAX's master_apply per k, JAX's
    band path per (n, k), the port's band path per (n, k)."""
    pj, pt = model()
    cj, ct = configs(pallas)
    c, s = images(*hw, b, seed)
    out = {"jax_master": {k: jax_master(pj, cj, c, s, k) for k in KS},
           "jax_shmap": {}, "port": {}, "calls": {}}
    for n in BANDS:
        port, calls = port_bands(pt, ct, c, s, n,
                                 [(f"k{k}", k, "shmap") for k in KS],
                                 kernel_dtypes=kernel_dtypes)
        for k in KS:
            out["jax_shmap"][(n, k)] = jax_shmap(pj, cj, c, s, k, n)
            out["port"][(n, k)] = port[f"k{k}"]
        out["calls"][n] = calls
    out.update(pj=pj, pt=pt, c=c, s=s)
    return out


def band_kernel_calls(k: int, n: int) -> dict:
    """The K1-K4 entries a rank calls in one band stylize at a kernel dtype
    (chip_smoke.py's table less the decoder's kernels, none at n > 1)."""
    names = [name for _, name in workers.BAND_ENTRIES]
    return {e: v for e, v in chip_smoke.spatial_per_call(
        "bfloat16", True, k, n).items() if e in names}


def assert_close(got, want, what=""):
    """The whole stylize's bounds: per-pixel MAE against the output's
    magnitude, and max-abs."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    mae_tol = MAE * max(1.0, float(np.abs(want).mean()))
    assert err.mean() <= mae_tol and err.max() <= MAX_ABS, (
        what, float(err.mean()), mae_tol, float(err.max()))
