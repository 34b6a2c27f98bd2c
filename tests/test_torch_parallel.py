"""The port's band-owned spatial path (parallel/) against the JAX package's
(parallel/spatial_shmap.py, mesh.py) on the CPU: the pieces.

The port's ranks run over gloo, each a process started by the port's own
launcher (parallel/launch.py) from tests/torch_parallel_workers.py, which
imports no JAX; JAX runs here, in the parent, on its 8-device CPU mesh
(tests/conftest.py). Shapes: 64x64 and 64x96 images at n = 2 and n = 4
bands (n = 4 pads the window-row count, so the band grid's refgrid mask
slabs are exercised), ModelConfig's swin_B widths, 7x7 windows, shifts
(3, 3) and (4, 4). Per case:

* the band collectives (roll, un-roll, repartition at every stage
  boundary of the geometry), band by band, equal to JAX's under
  shard_map;
* the geometry: every band's mask slab and the meta equal to JAX's
  ``_build_aux``, and ``spatial_shmap_unsupported``'s reasons JAX's, word
  for word;
* the band Swin against JAX's ``swin_backbone_apply``, max-abs 1e-5;
* the band-local plain decoder (halo rows, reflection at the image's edge
  bands, a band of one row too) against the port's whole-image plain
  decoder, max-abs 1e-5;
* make_mesh's refusals (JAX's messages), shard_batch, replicate; a rank
  that raises ends the run with its traceback.

One band (a world-1 gloo group in this process): the kernel entries the
band path calls at bf16 against chip_smoke.py's launch table (JAX's band
gate: K1 for the 4 Swin blocks, K2 2k, K3 k, K4 k, the decoder's K5-K7),
none of K1-K4 at f32; at both types the band path equals the port's
single-device ``master_apply`` bit for bit (the same per-window plain
versions). The whole stylize
against JAX, and at bf16 over bands:
tests/test_torch_parallel_stylize*.py.
"""

import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.multiprocessing import ProcessRaisedException

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.models.swin import (
    init_swin_backbone, swin_backbone_apply,
)
from mastermetastyletransfer_tpu.parallel import make_mesh as jmake_mesh
from mastermetastyletransfer_tpu.parallel import spatial_shmap as jss
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.models.decoder import init_cnn_decoder
from mastermetastyletransfer_tpu_torch.models.master import (
    init_master_model, master_apply,
)
from mastermetastyletransfer_tpu_torch.parallel import make_mesh
from mastermetastyletransfer_tpu_torch.parallel import spatial_shmap as tss
from mastermetastyletransfer_tpu_torch.parallel.launch import spawn_ranks
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax

import chip_smoke
from tests import torch_parallel_workers as workers
from tests.torch_threads import one_torch_thread  # noqa: F401

SHAPES = ((64, 64), (64, 96))
BANDS = (2, 4)
TOL = 1e-5


def _cfgs():
    cj = jcfg.ModelConfig()
    return cj, tcfg.ModelConfig.from_dict(cj.to_dict())


@pytest.fixture(scope="module")
def swin():
    """JAX Swin params and the port's copy."""
    cj, _ = _cfgs()
    pj = jax.device_get(init_swin_backbone(jax.random.PRNGKey(0), cj.swin))
    return pj, params_from_jax(pj)


def _images(h, w, seed=0, b=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, h, w, 3)).astype(np.float32)


def _geometry_cases(h, w, n):
    """Every band-collective call the band path makes at this geometry, as
    (name, kind, arg, h_valid, rows in), and a random input of each."""
    _, ct = _cfgs()
    _, meta = tss._aux_arrays(h, w, ct, n)
    rng = np.random.default_rng(h + w + n)
    cases, x = [], {}
    for key, g in meta.items():
        for name, kind, arg, hv, rows in (
                (f"{key}_in", "repart", g["rows_loc"], g["hs"], g["hs"] // n),
                (f"{key}_out", "repart", g["hs"] // n, g["hs"],
                 g["rows_loc"]),
                (f"{key}_roll", "roll", g["sh"], None, g["rows_loc"]),
                (f"{key}_unroll", "unroll", g["sh"], None, g["rows_loc"])):
            cases.append((name, kind, arg, hv))
            x[name] = rng.standard_normal((2, n * rows, 5, 3)).astype(
                np.float32)
    return cases, x


def _jax_collective(kind, arg, hv, n, x):
    mesh = jmake_mesh(n, axis_names=("space",))
    spec = P(None, "space", None, None)

    def f(xl):
        if kind == "roll":
            return jss._band_roll_h(xl, arg, "space", n)
        if kind == "unroll":
            return jss._band_unroll_h(xl, arg, "space", n)
        return jss._band_repartition(xl, arg, "space", n, h_valid=hv)

    return np.asarray(jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=spec, out_specs=spec))(jnp.asarray(x)))


@pytest.fixture(scope="module")
def ranks(swin):
    """Per (shape, n): one spawn of n gloo ranks for the collectives, the
    band Swin and the band decoder (and, at n = 4, the mesh checks)."""
    _, ct = _cfgs()
    dec = init_cnn_decoder(torch.Generator().manual_seed(3), ct.decoder)
    rng = np.random.default_rng(5)
    out = {"decoder_params": dec}
    for (h, w) in SHAPES:
        for n in BANDS:
            cases, x = _geometry_cases(h, w, n)
            # the feature map of this image, and one of a band of one row,
            # each in f32 and f64
            feats = [rng.standard_normal((2, h // 8, w // 8, 256)),
                     rng.standard_normal((1, n, 3, 256))]
            feats = [f.astype(t) for f in feats
                     for t in (np.float32, np.float64)]
            res = spawn_ranks(workers.band_pieces, n, backend="gloo",
                              device="cpu",
                              args=(x, cases, swin[1], dec, ct,
                                    _images(h, w), feats))
            out[(h, w, n)] = dict(
                cases=cases, x=x, feats=feats, model=res[0]["model"],
                collectives=[r["collectives"] for r in res])
            if n == 4:
                out["mesh"] = [r["mesh"] for r in res]
    return out


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("hw", SHAPES)
def test_band_collectives_equal_jax_shard_map(ranks, hw, n):
    r = ranks[(*hw, n)]
    for name, kind, arg, hv in r["cases"]:
        want = _jax_collective(kind, arg, hv, n, r["x"][name])
        got = np.concatenate([band[name] for band in r["collectives"]], 1)
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the geometry makes n = 4 gather from three bands somewhere
    if n == 4:
        assert any(kind == "repart" and arg > 2 * (x.shape[1] // n)
                   for (name, kind, arg, _), x in
                   zip(r["cases"], r["x"].values()))


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("hw", SHAPES)
def test_aux_slabs_and_meta_equal_jax(hw, n):
    cj, ct = _cfgs()
    h, w = hw
    jaux, _, jmeta = jss._build_aux(h, w, cj, n)
    taux, tmeta = tss._aux_arrays(h, w, ct, n)
    assert tmeta == jmeta
    assert taux.keys() == jaux.keys()
    # the band grid pads the window-row count past the reference grid's
    assert tmeta["s0"]["nwh_pad"] > -(-tmeta["s0"]["hs"] // 7)
    for name, a in jaux.items():
        a = np.asarray(a)
        np.testing.assert_array_equal(taux[name], a, err_msg=name)
        rows = a.shape[0] // n
        for index in range(n):
            slab, _ = tss._build_aux(h, w, ct, n, index, torch.device("cpu"))
            want = a[index * rows:(index + 1) * rows]
            np.testing.assert_array_equal(
                slab[name].numpy(), want.reshape((-1,) + a.shape[2:]),
                err_msg=f"{name} band {index}")
    if n == 4:   # the refgrid keys: window rows padded past the reference
        assert (jaux["s0_mask"] <= -1e9).any()
        assert (taux["st_refpad"] == 0).any()


def test_unsupported_reasons_are_jax_words():
    cj, ct = _cfgs()
    cases = [(256, 256, 8), (250, 256, 8), (256, 256, 3), (64, 64, 4),
             (64, 96, 2), (72, 64, 3), (48, 64, 2), (64, 60, 2)]
    variants = [
        lambda c: c,
        lambda c: c.replace(transformer=c.transformer.replace(
            decoder_use_regular_MHA_instead_of_Swin_at_the_end=True)),
        lambda c: c.replace(transformer=c.transformer.replace(
            decoder_shift_size=(3, 3))),
    ]
    reasons = set()
    for v in variants:
        for h, w, n in cases:
            want = jss.spatial_shmap_unsupported(v(cj), h, w, n)
            assert tss.spatial_shmap_unsupported(v(ct), h, w, n) == want
            reasons.add(want)
    assert len(reasons) == 6      # None and each of the five reasons


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("hw", SHAPES)
def test_band_swin_matches_jax(swin, ranks, hw, n):
    """Both patch-embed routes: the space-to-depth GEMM and the strided
    convolution."""
    cj, _ = _cfgs()
    for impl, got in zip(("s2d", "conv"), ranks[(*hw, n)]["model"]["swin"]):
        scfg = cj.swin.replace(patch_embed_impl=impl)
        want = np.asarray(jax.jit(lambda p, x: swin_backbone_apply(
            p, x, scfg))(swin[0], jnp.asarray(_images(*hw))))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0,
                                   err_msg=impl)


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("hw", SHAPES)
def test_band_decoder_matches_whole_image(ranks, hw, n):
    """Halo rows from the neighbours, reflection only in the first and
    last band; the second case has bands of one feature row. In float64
    the band decoder is the whole one to 1e-10 (the halo logic is exact);
    in float32 within 1e-5 of the output's largest magnitude (standard
    normal features give outputs of magnitude ~15, and the CPU's
    convolutions sum a band's shape in another order than the whole
    image's)."""
    _, ct = _cfgs()
    ct = tss.plain_decoder(ct)
    r = ranks[(*hw, n)]
    for feats, got in zip(r["feats"], r["model"]["decoder"]):
        want = workers.whole_decoder(ranks["decoder_params"], feats, ct)
        assert got.shape == want.shape == (feats.shape[0], 8 * feats.shape[1],
                                           8 * feats.shape[2], 3)
        assert got.dtype == feats.dtype
        tol = (1e-10 if feats.dtype == np.float64
               else TOL * max(1.0, float(np.abs(want).max())))
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_make_mesh_refusals_are_jax_words(ranks):
    """The port's world is 4 ranks, JAX's 8 devices: the same messages."""
    jax_errors = {}
    for label, kw in (("too_many", dict(num_devices=9)),
                      ("no_shape", dict(num_devices=8,
                                        axis_names=("data", "space"))),
                      ("bad_shape", dict(num_devices=8,
                                         axis_names=("data", "space"),
                                         shape=(8, 2)))):
        with pytest.raises(ValueError) as e:
            jmake_mesh(**kw)
        jax_errors[label] = str(e.value)
    for rank in ranks["mesh"]:
        errs = rank["errors"]
        assert errs["too_many"] == jax_errors["too_many"].replace(
            "9", "5").replace("8", "4")
        assert errs["no_shape"] == jax_errors["no_shape"]
        assert errs["bad_shape"] == jax_errors["bad_shape"].replace(
            "8", "4")
        assert "does not divide" in errs["indivisible"]
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh(1, ("space",), device_type="cpu")


def test_shard_batch_and_replicate(ranks):
    x = np.arange(16 * 3).reshape(16, 3)
    for rank, r in enumerate(ranks["mesh"]):
        np.testing.assert_array_equal(r["shard"]["x"].numpy(),
                                      x[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(r["shard"]["y"][0].numpy(),
                                      np.arange(8)[2 * rank:2 * rank + 2])
        rep = workers.np_tree(r["replicated"])
        np.testing.assert_array_equal(rep["w"], np.zeros(3))
        np.testing.assert_array_equal(rep["v"]["u"], np.full((2, 2), 10.0))
        assert r["hybrid"] == (rank // 2, rank % 2, [[0, 1], [2, 3]])


def test_a_failing_rank_ends_the_run():
    t0 = time.perf_counter()
    with pytest.raises(ProcessRaisedException, match="fails on purpose"):
        spawn_ranks(workers.raise_on, 3, backend="gloo", device="cpu",
                    args=(1,))
    assert time.perf_counter() - t0 < 60


# ---------------------------------------------------------------------------
# One band, in this process: the kernel gate and the single-device path
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one():
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "rv"),
            world_size=1, rank=0)
        try:
            yield make_mesh(1, ("space",), device_type="cpu")
        finally:
            dist.destroy_process_group()


DECODER_ENTRIES = tuple(
    (mod, name) for mod, name in (
        (chip_smoke.pc, "stencil_phase_conv"),
        (chip_smoke.pc, "stencil_phase2_conv"),
        (chip_smoke.pc, "stencil_phase2_conv_padcols"),
        (chip_smoke.pc, "phase_align")))


@pytest.mark.parametrize("k", [1, 3])
def test_one_band_kernel_gate_and_launch_table(world_of_one, monkeypatch, k):
    """bf16 with the kernels: every kernel entry JAX's band gate picks is
    called, as often as chip_smoke.py's table says (on the card each call
    is one launch); the output equals the single-device master_apply's bit
    for bit. f32 with the kernels: no K1-K4 (JAX's hardware gate), the
    decoder's kernels as configured; the band path runs the kernels' plain
    versions, as the single-device path does on the CPU, and equals it bit
    for bit."""
    cfg = chip_smoke.slice_config("bfloat16", True)
    params = init_master_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    c, s = (torch.from_numpy(a) for a in (_images(64, 64, 1, 1),
                                          _images(64, 64, 2, 1)))
    for mod, name in workers.BAND_ENTRIES + DECODER_ENTRIES:
        monkeypatch.setattr(mod, name, getattr(mod, name))
    counts = workers.count_calls(workers.BAND_ENTRIES + DECODER_ENTRIES)
    got = tss.make_spatial_stylize_shmap(cfg, world_of_one, k=k)(
        params, c, s)
    want = {e: v for e, v in chip_smoke.spatial_per_call(
        "bfloat16", True, k, 1).items() if v}
    assert {e: v for e, v in counts.items() if v} == want
    with torch.inference_mode():
        ref = master_apply(params, c, s, cfg, k=k)
    assert torch.equal(got, ref)

    cfg32 = chip_smoke.slice_config("float32", True)
    for key in counts:
        counts[key] = 0
    got = tss.make_spatial_stylize_shmap(cfg32, world_of_one, k=k)(
        params, c, s)
    assert all(counts[name] == 0 for _, name in workers.BAND_ENTRIES)
    assert counts["stencil_phase_conv"] > 0
    with torch.inference_mode():
        ref = master_apply(params, c, s, cfg32, k=k)
    assert torch.equal(got, ref)
