"""The port's models, inference and service against the JAX package at
swin_B widths and small images, float32 on the CPU. Weights are JAX-
initialised and shared through params_from_jax / the flat .npz scheme.

Tolerances: max-abs 1e-4 per stage (sums in another order, and the JAX
block kernel's Abramowitz-Stegun erf against the exact erf); the whole model
at per-pixel MAE <= 1e-5 and max-abs <= 1e-4 (PERF.md reports the JAX
float32 path exact to about 3e-6 against the reference).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu import inference as jinf
from mastermetastyletransfer_tpu.models import decoder as jdec
from mastermetastyletransfer_tpu.models import master as jmaster
from mastermetastyletransfer_tpu.models import style_transformer as jst
from mastermetastyletransfer_tpu.models import swin as jswin
from mastermetastyletransfer_tpu.utils.checkpoint import save_params_npz
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch import inference as tinf
from mastermetastyletransfer_tpu_torch.models import decoder as tdec
from mastermetastyletransfer_tpu_torch.models import master as tmaster
from mastermetastyletransfer_tpu_torch.models import style_transformer as tst
from mastermetastyletransfer_tpu_torch.models import swin as tswin
from mastermetastyletransfer_tpu_torch.serve import StylizeService
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    flatten_params, load_params_npz, params_from_jax, tree_map,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    """JAX params of the default (swin_B-width) model and their port copy."""
    cj = jcfg.ModelConfig()
    pj = jax.device_get(jmaster.init_master_model(jax.random.PRNGKey(0), cj))
    return pj, params_from_jax(pj)


def _cfgs(swin_kernel):
    cj = jcfg.ModelConfig()
    ct = tcfg.ModelConfig.from_dict(cj.to_dict())
    if swin_kernel:
        cj = cj.replace(swin=cj.swin.replace(use_pallas=True))
        ct = ct.replace(swin=ct.swin.replace(use_pallas=True))
    return cj, ct


def _x(seed, shape):
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_params_from_jax_and_npz(model, tmp_path):
    pj, pt = model
    flat_j, flat_t = flatten_params(pj), flatten_params(pt)
    assert flat_j.keys() == flat_t.keys()
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape, k
        np.testing.assert_array_equal(flat_t[k].numpy(), v, err_msg=k)
    path = str(tmp_path / "params.npz")
    save_params_npz(path, pj)
    zeros = tree_map(torch.zeros_like, pt)
    loaded = load_params_npz(path, zeros)
    for k, v in flatten_params(loaded).items():
        np.testing.assert_array_equal(v.numpy(), flat_j[k], err_msg=k)


def test_config_from_jax_json():
    cj = jcfg.ModelConfig(compute_dtype="bfloat16")
    cj = cj.replace(swin=jcfg.SwinConfig.for_variant("swin_S"))
    ct = tcfg.ModelConfig.from_json(cj.to_json())
    assert ct.compute_dtype == "bfloat16"
    assert ct.swin == tcfg.SwinConfig.for_variant("swin_S")
    assert ct.transformer.encoder_dim == cj.transformer.encoder_dim


@pytest.mark.parametrize("swin_kernel", [False, True])
def test_swin_backbone_matches_jax(model, swin_kernel):
    pj, pt = model
    cj, ct = _cfgs(swin_kernel)
    xj, xt = _x(1, (2, 64, 64, 3))
    ref = np.asarray(jswin.swin_backbone_apply(pj["swin"], xj, cj.swin))
    got = tswin.swin_backbone_apply(pt["swin"], xt, ct.swin)
    assert got.shape == (2, 8, 8, 256)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("k", [1, 3])
def test_style_transformer_matches_jax(model, k):
    pj, pt = model
    cj, ct = _cfgs(False)
    fcj, fct = _x(2, (2, 9, 9, 256))
    fsj, fst = _x(3, (2, 9, 9, 256))
    ref = np.asarray(jst.style_transformer_apply(
        pj["style_transformer"], fcj, fsj, cj.transformer, k=k))
    got = tst.style_transformer_apply(pt["style_transformer"], fct, fst,
                                      ct.transformer, k=k)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


def test_decoder_matches_jax(model):
    pj, pt = model
    cj, ct = _cfgs(False)
    xj, xt = _x(4, (2, 6, 7, 256))
    ref = np.asarray(jdec.cnn_decoder_apply(pj["decoder"], xj, cj.decoder))
    got = tdec.cnn_decoder_apply(pt["decoder"], xt, ct.decoder)
    assert got.shape == (2, 48, 56, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


def test_master_apply_matches_jax(model):
    """The whole slice: Swin blocks through the block kernel (the plain
    version here, K1 in interpret mode on the JAX side)."""
    pj, pt = model
    cj, ct = _cfgs(True)
    cjx, ctx = _x(5, (1, 64, 64, 3))
    sjx, stx = _x(6, (1, 64, 64, 3))
    ref = np.asarray(jmaster.master_apply(pj, cjx, sjx, cj, k=1))
    got = tmaster.make_stylize_fn(ct, k=1, device="cpu")(pt, ctx, stx)
    err = np.abs(got.numpy() - ref)
    assert err.mean() <= 1e-5 and err.max() <= TOL, (err.mean(), err.max())


def test_bucketed_stylize_matches_jax(model):
    pj, pt = model
    cj, ct = _cfgs(True)
    cjx, ctx = _x(7, (1, 40, 56, 3))
    sjx, stx = _x(8, (1, 64, 30, 3))
    ref = np.asarray(jinf.stylize(pj, cjx, sjx, cj, k=1, buckets=(64,)))
    got = tinf.stylize(pt, ctx, stx, ct, k=1, buckets=(64,), device="cpu")
    assert tinf.pick_bucket(40, 56, (64, 128)) == jinf.pick_bucket(40, 56, (64, 128))
    assert got.shape == (1, 40, 56, 3)
    err = np.abs(got.numpy() - ref)
    assert err.mean() <= 1e-5 and err.max() <= TOL, (err.mean(), err.max())


def test_stylize_service_concurrent_requests(model):
    _, pt = model
    _, ct = _cfgs(True)
    svc = StylizeService(pt, ct, size=64, k=1, max_batch=2, window_ms=20.0,
                         device="cpu")
    try:
        rng = np.random.default_rng(9)
        pairs = [(rng.random((64, 64, 3), dtype=np.float32),
                  rng.random((64, 64, 3), dtype=np.float32)) for _ in range(3)]
        results = {}

        def call(i):
            results[i] = svc.stylize(*pairs[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        fn = tmaster.make_stylize_fn(ct, k=1, device="cpu")
        for i, (c, s) in enumerate(pairs):
            assert results[i].shape == (64, 64, 3)
            want = fn(pt, c[None], s[None])[0].numpy()
            np.testing.assert_allclose(results[i], want, rtol=0, atol=TOL)
    finally:
        svc.close()
    assert not svc._thread.is_alive()


def test_http_roundtrip(model):
    import io
    import urllib.request
    from http.server import ThreadingHTTPServer

    from PIL import Image

    from mastermetastyletransfer_tpu_torch.serve import make_handler

    _, pt = model
    _, ct = _cfgs(True)
    svc = StylizeService(pt, ct, size=64, k=1, max_batch=1, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 make_handler({1: svc}, default_k=1))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz") as r:
            assert b'"ok"' in r.read()
        buf = io.BytesIO()
        Image.new("RGB", (40, 30), (200, 30, 90)).save(buf, "JPEG")
        img = buf.getvalue()
        body = b"".join(
            b"--XB\r\nContent-Disposition: form-data; name=\"%s\"\r\n\r\n"
            % name + img + b"\r\n" for name in (b"content", b"style"))
        body += b"--XB--\r\n"
        req = urllib.request.Request(
            url + "/stylize", data=body,
            headers={"Content-Type": "multipart/form-data; boundary=XB"})
        with urllib.request.urlopen(req) as r:
            assert r.headers["Content-Type"] == "image/jpeg"
            out = Image.open(io.BytesIO(r.read()))
            assert out.size == (64, 64)
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
