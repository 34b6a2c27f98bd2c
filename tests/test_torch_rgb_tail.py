"""The RGB-tail kernel module K12 (ops/phase_conv.py's ``stencil_phase2_rgb``
and ``stencil_phase2_rgb128``) and its routes in ops/conv.py and
models/decoder.py against the JAX package, float32 on the CPU.

* Both plain versions against JAX's Pallas kernels in interpret mode, at
  the decoder's conv8 (an L2 input of 16 x 32 channels, C' = 3), with every
  weight block and with the L2 table's nonzero blocks only: max-abs 1e-5.
* Their backward passes (the autograd Functions, plain on the CPU) against
  ``jax.vjp`` of ``stencil_phase2_rgb{,128}_vjp``: max-abs 1e-4.
* The routes: ``master_apply`` with ``rgb_tail="l2k128"`` against JAX's at
  64^2 (per-pixel MAE <= 1e-5, max-abs <= 1e-4, the TOL of
  tests/test_torch_models.py), with the route counted at the wrappers; the
  same with ``_RGB_KERNEL_ON`` set on both sides; and the decoder alone
  with ``l2k128`` with and without ``use_pallas`` (the JAX route does not
  test it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.models import decoder as jdec
from mastermetastyletransfer_tpu.models import master as jmaster
from mastermetastyletransfer_tpu.ops import conv as jconv
from mastermetastyletransfer_tpu.ops import pallas_conv as jpc
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.models import decoder as tdec
from mastermetastyletransfer_tpu_torch.models import master as tmaster
from mastermetastyletransfer_tpu_torch.ops import conv as tconv
from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _conv8(h=6, w=7, relu=False):
    """pp (2, h+2, w+2, 512) of an L2 tensor of 32 channels, padded as the
    decoder pads it, conv8's composed kernel (2, 2, 512, 48) and bias, the
    bases; each as (JAX, torch)."""
    x = _np(1, (2, h, w, 16 * 32))
    w3 = _np(2, (3, 3, 32, 3), 0.1)
    bias = _np(3, (3,), 0.5)
    kj, bases = jconv._phase2_kernel(jnp.asarray(w3), False)
    kt, _ = tconv._phase2_kernel(torch.from_numpy(w3), False)
    ppj = jconv._phase2_pad(jnp.asarray(x), 4, 32, False)
    ppt = tconv._phase2_pad(torch.from_numpy(x), 4, 32, False)
    return (ppj, ppt), (kj, kt), bias, tuple(int(b) for b in bases)


def _slots(k, b):
    """JAX's k128 route: the kernel's and bias's 16 x 3 lanes in 8-lane
    slots (ops/conv.py:569-591 there)."""
    kw = np.zeros((*k.shape[:3], 16, 8), np.float32)
    kw[..., :3] = np.asarray(k).reshape(*k.shape[:3], 16, 3)
    b128 = np.zeros((16, 8), np.float32)
    b128[:, :3] = b
    return kw.reshape(*k.shape[:3], 128), b128.reshape(128)


@pytest.mark.parametrize("table", ["dense", "l2"])
@pytest.mark.parametrize("entry", ["rgb", "rgb128"])
def test_rgb_plain_matches_pallas(entry, table):
    (ppj, ppt), (kj, kt), bias, bases = _conv8()
    tab = tconv._phase2_table(False) if table == "l2" else None
    if entry == "rgb":
        want = jpc.stencil_phase2_rgb(ppj, kj, jnp.tile(bias, 16), bases,
                                      False, True)
        b16 = torch.from_numpy(bias).repeat(16)
        got = pc.stencil_phase2_rgb(ppt, kt, b16, bases, table=tab)
        plain = pc.stencil_phase2_rgb_plain(ppt, kt, b16, bases)
        assert got.shape == (2, 24, 28, 3)
    else:
        k128, b128 = _slots(kj, bias)
        want = jpc.stencil_phase2_rgb128(ppj, jnp.asarray(k128),
                                         jnp.asarray(b128), bases, False,
                                         True)
        got = pc.stencil_phase2_rgb128(ppt, torch.from_numpy(k128),
                                       torch.from_numpy(b128), bases,
                                       table=tab)
        plain = pc.stencil_phase2_rgb128_plain(
            ppt, torch.from_numpy(k128), torch.from_numpy(b128), bases)
        assert got.shape == (2, 6, 7, 128)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.detach().numpy(), plain.numpy())


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("entry", ["rgb", "rgb128"])
def test_rgb_backward_matches_jax_vjp(entry, relu):
    (ppj, ppt), (kj, kt), bias, bases = _conv8(h=4, w=5)
    if entry == "rgb":
        kj_, bj_ = kj, jnp.tile(bias, 16)
        kt_, bt_ = kt, torch.from_numpy(bias).repeat(16)
        fn_j, fn_t = jpc.stencil_phase2_rgb_vjp, pc.stencil_phase2_rgb
    else:
        k128, b128 = _slots(kj, bias)
        kj_, bj_ = jnp.asarray(k128), jnp.asarray(b128)
        kt_, bt_ = torch.from_numpy(k128), torch.from_numpy(b128)
        fn_j, fn_t = jpc.stencil_phase2_rgb128_vjp, pc.stencil_phase2_rgb128
    y, vjp = jax.vjp(lambda a, b, c: fn_j(a, b, c, bases, relu, True),
                     ppj, kj_, bj_)
    g = _np(4, y.shape)
    want = vjp(jnp.asarray(g))
    leaves = [t.clone().requires_grad_() for t in (ppt, kt_, bt_)]
    out = fn_t(*leaves, bases, relu, table=tconv._phase2_table(False))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=0,
                               atol=1e-5)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for gt, wj in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wj), rtol=0,
                                   atol=1e-4)


@pytest.fixture(scope="module")
def model():
    pj = jax.device_get(jmaster.init_master_model(jax.random.PRNGKey(0),
                                                  jcfg.ModelConfig()))
    return pj, params_from_jax(pj)


def _count(monkeypatch):
    calls = dict.fromkeys(pc.LAUNCHES, 0)
    for name in calls:
        fn = getattr(pc, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(pc, name, counted)
    return calls


@pytest.mark.parametrize("route", ["l2k128", "rgb_kernel_on"])
def test_master_apply_rgb_tail_matches_jax(model, monkeypatch, route):
    """The decoder's kernels on (plain versions here, JAX's in interpret
    mode; the Swin and style-transformer kernels, which this route does not
    change, off on both sides); the RGB conv through K12's rgb128 entry, or
    through its rgb entry with ``_RGB_KERNEL_ON`` set in both packages."""
    pj, pt = model
    cj = jcfg.ModelConfig()
    cj = cj.replace(decoder=cj.decoder.replace(use_pallas=True))
    if route == "l2k128":
        cj = cj.replace(decoder=cj.decoder.replace(rgb_tail="l2k128"))
    else:
        monkeypatch.setattr(jconv, "_RGB_KERNEL_ON", True)
        monkeypatch.setattr(tconv, "_RGB_KERNEL_ON", True)
    ct = tcfg.ModelConfig.from_dict(cj.to_dict())
    assert ct.decoder.rgb_tail == cj.decoder.rgb_tail
    rng = np.random.default_rng(5)
    c, s = (rng.random((1, 64, 64, 3), dtype=np.float32) for _ in range(2))
    ref = np.asarray(jmaster.master_apply(pj, jnp.asarray(c), jnp.asarray(s),
                                          cj, k=1))
    calls = _count(monkeypatch)
    got = tmaster.make_stylize_fn(ct, k=1, device="cpu")(
        pt, torch.from_numpy(c), torch.from_numpy(s))
    err = np.abs(got.numpy() - ref)
    assert err.mean() <= 1e-5 and err.max() <= TOL, (err.mean(), err.max())
    assert calls == {"stencil_phase_conv": 5, "stencil_phase2_conv": 0,
                     "stencil_phase2_conv_padcols": 1, "phase_align": 1,
                     "stencil_phase2_rgb": int(route != "l2k128"),
                     "stencil_phase2_rgb128": int(route == "l2k128")}


@pytest.mark.parametrize("use_pallas", [True, False])
def test_decoder_l2k128_matches_jax(model, monkeypatch, use_pallas):
    """The l2k128 RGB conv takes K12's rgb128 entry with the stencil
    kernels off too, as the JAX route does."""
    pj, pt = model
    cj = jcfg.DecoderConfig(use_pallas=use_pallas, rgb_tail="l2k128")
    ct = tcfg.DecoderConfig.from_dict(cj.to_dict())
    x = _np(6, (2, 8, 8, 256), 0.5)
    want = np.asarray(jdec.cnn_decoder_apply(pj["decoder"], jnp.asarray(x),
                                             cj))
    calls = _count(monkeypatch)
    got = tdec.cnn_decoder_apply(pt["decoder"], torch.from_numpy(x), ct)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert calls["stencil_phase2_rgb128"] == 1
    assert calls["stencil_phase2_conv_padcols"] == int(use_pallas)
