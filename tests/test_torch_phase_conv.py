"""The decoder's phase-space path of the port (ops/conv.py, ops/phase_conv.py,
models/decoder.py) against the JAX package, float32 on the CPU.

* The composed kernels, their stencil tables and the pad maps against JAX's
  (1e-6; the tables against the nonzero blocks of JAX's kernels).
* The index gathers (``_phase2_pad``, the interleaves, ``l2_to_l1``, the K7
  plain version) bit-equal to JAX's.
* The plain versions of K5, K6 and K6 padcols against JAX's Pallas kernels
  in interpret mode, at Cin 128 / C' 32, at an even height (the kernel)
  and an odd one (JAX's XLA fallback): max-abs <= 1e-4 of the largest
  |output| (sums in another order).
* The whole decoder against JAX's with ``use_pallas`` at (2, 8, 8, 256),
  for each RGB tail, ``phase_exit=6``, train mode and the plain nine convs:
  max-abs <= 1e-4 (the TOL of tests/test_torch_models.py).
* The composed kernels are built once per weight tensor, again after an
  in-place change, and once under concurrent callers.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.models import decoder as jdec
from mastermetastyletransfer_tpu.ops import conv as jconv
from mastermetastyletransfer_tpu.ops import pallas_conv as jpc
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.models import decoder as tdec
from mastermetastyletransfer_tpu_torch.ops import conv as tconv
from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    params_from_jax, tree_map,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# Composed kernels, tables, pads
# ---------------------------------------------------------------------------

def _nonzero_blocks(k: np.ndarray, groups: int, nchunks: int):
    """Per output group, the bitmask of (tap, input chunk) blocks of k that
    hold a nonzero weight."""
    _, _, cin, n = k.shape
    blocks = k.reshape(4, nchunks, cin // nchunks, groups, n // groups)
    nz = np.abs(blocks).max(axis=(2, 4)) > 0        # (tap, chunk, group)
    return tuple(int(sum(1 << (t * nchunks + c) for t in range(4)
                         for c in range(nchunks) if nz[t, c, g]))
                 for g in range(groups))


def test_phase_kernels_and_tables_match_jax():
    w = _np(0, (3, 3, 32, 16))
    wj, wt = _both(w)
    k_up = tconv._phase_kernel(wt).numpy()
    np.testing.assert_allclose(k_up, np.asarray(jconv._phase_kernel(wj)),
                               rtol=0, atol=1e-6)
    assert _nonzero_blocks(k_up, 4, 1) == tconv._UPSAMPLE_TABLE.blocks
    k_ps = tconv._phase_space_kernel(wt).numpy()
    np.testing.assert_allclose(
        k_ps, np.asarray(jconv._phase_space_kernel(wj)), rtol=0, atol=1e-6)
    table = tconv._phase_space_table()
    assert _nonzero_blocks(k_ps, 4, 4) == table.blocks
    assert table.offsets == ((0, 0), (0, 1), (1, 0), (1, 1))


@pytest.mark.parametrize("up", [True, False])
def test_phase2_kernel_bases_present_match_jax(up):
    wj, wt = _both(_np(1, (3, 3, 16, 8)))
    kt, bases_t = tconv._phase2_kernel(wt, up)
    kj, bases_j = jconv._phase2_kernel(wj, up)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0, atol=1e-6)
    assert bases_t == list(bases_j)
    # JAX's present table, as phase2_conv3x3 builds it
    ax = [jconv._phase2_axis_slots(a, up) for a in range(4)]
    dys = [sorted({dy for (dy, _) in slots}) for _, slots in ax]
    present = tuple(tuple((dy, dx) for dy in dys[a] for dx in dys[b])
                    for a in range(4) for b in range(4))
    table = tconv._phase2_table(up)
    assert table.present == present
    assert sum(len(p) for p in present) == 36
    assert table.offsets == tuple((bases_j[a], bases_j[b])
                                  for a in range(4) for b in range(4))
    assert _nonzero_blocks(kt.numpy(), 16, table.nchunks) == table.blocks


@pytest.mark.parametrize("nph,c,up", [(4, 32, False), (2, 64, True),
                                      (4, 32, True), (2, 16, True)])
@pytest.mark.parametrize("hw", [(6, 10), (5, 7)])
def test_phase2_pad_bit_equal_jax(nph, c, up, hw):
    xj, xt = _both(_np(2, (2, *hw, nph * nph * c)))
    want = np.asarray(jconv._phase2_pad(xj, nph, c, up))
    np.testing.assert_array_equal(
        np.asarray(jconv._phase2_pad_ref(xj, nph, c, up)), want)
    np.testing.assert_array_equal(
        tconv._phase2_pad(xt, nph, c, up).numpy(), want)
    np.testing.assert_array_equal(
        tconv._phase2_pad_ref(xt, nph, c, up).numpy(), want)
    if nph == 4 and not up:
        # rows added to a column-padded tensor give the same corners
        cols = tconv._phase2_pad(xt, 4, c, False)[:, 1:-1]
        np.testing.assert_array_equal(
            tconv._phase2_pad_rows(cols, 4, c).numpy(), want)


def test_interleaves_and_align_bit_equal_jax():
    xj, xt = _both(_np(3, (2, 5, 7, 128)))
    for tf, jf in ((tconv.phase_interleave, jconv.phase_interleave),
                   (tconv.phase_interleave2, jconv.phase_interleave2),
                   (tconv.l2_to_l1, jconv.l2_to_l1)):
        np.testing.assert_array_equal(tf(xt).numpy(), np.asarray(jf(xj)))
    bj, bt = _both(_np(4, (2, 9, 9, 128)))
    np.testing.assert_array_equal(pc.phase_align_plain(bt, 32).numpy(),
                                  np.asarray(jpc.phase_align(bj, 32, True)))
    bases = [1, 0, 1, 0]
    np.testing.assert_array_equal(
        tconv._align2(bt[..., :112], 8, 8, 7, bases).numpy(),
        np.asarray(jconv._align2(bj[..., :112], 8, 8, 7, bases)))


# ---------------------------------------------------------------------------
# The plain versions of K5 and K6 against JAX's Pallas kernels
# ---------------------------------------------------------------------------

def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert got.shape == want.shape
    assert err <= TOL * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("form", ["up", "l1"])
@pytest.mark.parametrize("h", [6, 5])
def test_stencil_phase_conv_plain_matches_pallas(form, h):
    """K5 at Cin 128, C' 32: the upsample kernel over a coarse tensor and
    the L1 phase-space kernel over a phase tensor."""
    cin = 128 if form == "up" else 32
    wj, wt = _both(_np(5, (3, 3, cin, 32), 0.1))
    bias = _np(6, (32,))
    xj, xt = _both(_np(7, (2, h, 7, 128)))
    if form == "up":
        kj, kt = jconv._phase_kernel(wj), tconv._phase_kernel(wt)
        table = tconv._UPSAMPLE_TABLE
    else:
        kj, kt = jconv._phase_space_kernel(wj), tconv._phase_space_kernel(wt)
        table = tconv._phase_space_table()
    ppj = jnp.pad(xj, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    ppt = tconv._edge_pad(xt)
    np.testing.assert_array_equal(ppt.numpy(), np.asarray(ppj))
    want = jpc.stencil_phase_conv(ppj, kj, jnp.tile(bias, 4), True, True)
    got = pc.stencil_phase_conv_plain(ppt, kt, torch.from_numpy(bias)
                                      .repeat(4), table)
    _close(got, want)
    # the wrapper takes the plain version for a CPU tensor
    _close(pc.stencil_phase_conv(ppt, kt, torch.from_numpy(bias).repeat(4),
                                 table), want)


@pytest.mark.parametrize("padcols", [False, True])
@pytest.mark.parametrize("h", [6, 5])
def test_stencil_phase2_conv_plain_matches_pallas(padcols, h):
    """K6 at the L2 up-conv: L1 input 4 x 32 (Cin 128) -> 16 x 32."""
    w = 7
    wj, wt = _both(_np(8, (3, 3, 32, 32), 0.1))
    bias = _np(9, (32,))
    xj, xt = _both(_np(10, (2, h, w, 128)))
    kj, bases = jconv._phase2_kernel(wj, True)
    kt, _ = tconv._phase2_kernel(wt, True)
    ppj = jconv._phase2_pad(xj, 2, 32, True)
    ppt = tconv._phase2_pad(xt, 2, 32, True)
    table = tconv._phase2_table(True)
    b16j, b16t = jnp.tile(bias, 16), torch.from_numpy(bias).repeat(16)
    if padcols:
        perms = jconv._phase2_col_perms(4, 32, w, jnp.float32)
        want = jpc.stencil_phase2_conv_padcols(ppj, kj, b16j, perms,
                                               tuple(bases), table.present,
                                               True, True)
        cm = tconv._phase2_pad_maps(w, 4, False)
        got = pc.stencil_phase2_conv_padcols_plain(ppt, kt, b16t, table, cm)
        _close(got, want)
        _close(pc.stencil_phase2_conv_padcols(ppt, kt, b16t, table, cm),
               want)
    else:
        want = jpc.stencil_phase2_conv(ppj, kj, b16j, tuple(bases),
                                       table.present, True, True)
        _close(pc.stencil_phase2_conv_plain(ppt, kt, b16t, table), want)
        _close(pc.stencil_phase2_conv(ppt, kt, b16t, table), want)


# ---------------------------------------------------------------------------
# The whole decoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoder():
    pj = jax.device_get(jdec.init_cnn_decoder(jax.random.PRNGKey(0),
                                              jcfg.DecoderConfig()))
    return pj, params_from_jax(pj)


@pytest.mark.parametrize("kw", [
    dict(use_pallas=True),
    dict(use_pallas=True, rgb_tail="l1"),
    dict(use_pallas=True, rgb_tail="l2gemm"),
    dict(use_pallas=True, phase_exit=6),
    dict(use_pallas=True, deterministic=False),
    dict(fuse_upsample=False, use_pallas=True),
], ids=["l2", "l1", "l2gemm", "exit6", "train", "nine_convs"])
def test_decoder_matches_jax(decoder, kw):
    pj, pt = decoder
    kw = dict(kw)
    det = kw.pop("deterministic", True)
    cj = jcfg.DecoderConfig(**kw)
    ct = tcfg.DecoderConfig.from_dict(cj.to_dict())
    assert ct == tcfg.DecoderConfig(**kw)
    xj, xt = _both(_np(11, (2, 8, 8, 256), 0.5))
    want = np.asarray(jdec.cnn_decoder_apply(pj, xj, cj, deterministic=det))
    got = tdec.cnn_decoder_apply(pt, xt, ct, deterministic=det)
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_decoder_route_reaches_each_kernel(decoder, monkeypatch):
    """The route of the main path, counted at the wrappers on the CPU: per
    call K5 five times, K7 once, K6 with pad columns once, K6 without them
    never; with the kernels off, none of them."""
    _, pt = decoder
    calls = dict.fromkeys(pc.LAUNCHES, 0)
    for name in calls:
        fn = getattr(pc, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(pc, name, counted)
    x = torch.from_numpy(_np(12, (1, 8, 8, 256)))
    cfg = tcfg.ModelConfig().with_kernels().decoder
    assert cfg.use_pallas
    tdec.cnn_decoder_apply(pt, x, cfg)
    assert calls == {"stencil_phase_conv": 5, "stencil_phase2_conv": 0,
                     "stencil_phase2_conv_padcols": 1, "phase_align": 1,
                     "stencil_phase2_rgb": 0, "stencil_phase2_rgb128": 0}
    calls.update(dict.fromkeys(calls, 0))
    tdec.cnn_decoder_apply(pt, x, cfg.replace(use_pallas=False))
    assert set(calls.values()) == {0}


def test_decoder_composes_its_kernels_once_per_weights(decoder, monkeypatch):
    """A second call with the same weights composes no phase kernel; an
    in-place change to a kernel composes that conv's again, and the output
    follows the change."""
    pt = tree_map(torch.clone, decoder[1])
    built = []
    for name in ("_phase_kernel", "_phase_space_kernel", "_phase2_kernel"):
        fn = getattr(tconv, name)

        def counted(*a, _fn=fn, _name=name, **k):
            built.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(tconv, name, counted)
    x = torch.from_numpy(_np(14, (1, 8, 8, 256)))
    cfg = tcfg.DecoderConfig(use_pallas=True)
    first = tdec.cnn_decoder_apply(pt, x, cfg)
    assert sorted(built) == sorted(["_phase_kernel"] * 2
                                   + ["_phase_space_kernel"] * 4
                                   + ["_phase2_kernel"] * 2)
    built.clear()
    assert torch.equal(tdec.cnn_decoder_apply(pt, x, cfg), first)
    assert built == []
    pt["conv2"]["kernel"].mul_(0.5)
    again = tdec.cnn_decoder_apply(pt, x, cfg)
    assert built == ["_phase_space_kernel"]
    fresh = tdec.cnn_decoder_apply(tree_map(torch.clone, pt), x, cfg)
    assert torch.equal(again, fresh) and not torch.equal(again, first)


def test_derived_builds_once_under_concurrent_callers():
    w = torch.ones(3)
    builds, results, errors = [], [], []

    def build():
        builds.append(1)
        time.sleep(0.001)
        return w * 2

    def caller():
        try:
            for _ in range(50):
                results.append(tconv._derived(w, "twice", build))
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(results) == 16 * 50
    assert all(r is results[0] for r in results)
