"""Style-locked serving in the port against the JAX package, on the CPU at
64^2 and swin_B widths: the stream API of models/master.py
(``encode_features``, ``encode_style_stream``,
``stylize_from_features_with_stream``, ``stylize_with_style_stream``),
``inference.blend_style_streams``, ``serve.LockedStyleService`` and the
``/stylize_locked`` route.

Weights are JAX-initialised and carried across by ``params_from_jax``;
inputs come from numpy with a seed. With the kernels on, the port runs
their plain versions and JAX its Pallas kernels in interpret mode (jitted,
which compiles each function once). Bounds: float32 per-pixel MAE <= 1e-5
against JAX (max-abs 1e-4, as tests/test_torch_models.py), the stream's
tensors max-abs 1e-4 (the style transformer's bound); bfloat16 per-pixel
MAE <= 2e-2 of the mean |JAX output| (tests/test_torch_precision.py's bf16
bound); the services within 1e-4 of the pair service. JAX's
``stylize_with_style_stream`` is ``encode_features`` then
``stylize_from_features_with_stream``; its output is computed that way
here, once, for both of the port's functions.
"""

import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu import inference as jinf
from mastermetastyletransfer_tpu.models import master as jmaster
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch import inference as tinf
from mastermetastyletransfer_tpu_torch import models as tmodels
from mastermetastyletransfer_tpu_torch.models import master as tmaster
from mastermetastyletransfer_tpu_torch.models import style_transformer as tst
from mastermetastyletransfer_tpu_torch.serve import (
    LockedStyleService, StylizeService, _MicroBatcher, make_handler,
)
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL_MAE, TOL = 1e-5, 1e-4
TOL_BF16_REL = 2e-2
SIZE = 64


@pytest.fixture(scope="module")
def model():
    pj = jax.device_get(jmaster.init_master_model(jax.random.PRNGKey(0),
                                                  jcfg.ModelConfig()))
    return pj, params_from_jax(pj)


def _cfgs(kernels: bool, dtype: str = "float32"):
    cj = jcfg.ModelConfig(compute_dtype=dtype)
    cj = cj.replace(swin=cj.swin.replace(use_pallas=kernels),
                    transformer=cj.transformer.replace(use_pallas=kernels),
                    decoder=cj.decoder.replace(use_pallas=kernels))
    ct = tcfg.ModelConfig.from_dict(cj.to_dict())
    assert ct == tcfg.ModelConfig(compute_dtype=dtype).with_kernels(kernels)
    return cj, ct


def _images(seed, n):
    return np.random.default_rng(seed).random((n, SIZE, SIZE, 3),
                                              dtype=np.float32)


def _jax_stream_route(pj, cj, content, style, k):
    """JAX's style features, stream, content features and output."""
    feats = jax.jit(lambda p, x: jmaster.encode_features(p, x, cj))
    stream = jax.jit(lambda p, s: jmaster.encode_style_stream(p, s, cj, k=k))
    decode = jax.jit(lambda p, f, st:
                     jmaster.stylize_from_features_with_stream(p, f, st, cj))
    fs = feats(pj, jnp.asarray(style))
    st = stream(pj, jnp.asarray(style))
    fc = feats(pj, jnp.asarray(content))
    return dict(fs=np.asarray(fs), stream=jax.device_get(st),
                fc=np.asarray(fc), out=np.asarray(decode(pj, fc, st)))


def _port_stream_route(pt, ct, content, style, k):
    with torch.inference_mode():
        c, s = torch.from_numpy(content), torch.from_numpy(style)
        fs = tmaster.encode_features(pt, s, ct)
        st = tmaster.encode_style_stream(pt, s, ct, k=k)
        fc = tmaster.encode_features(pt, c, ct)
        return dict(fs=fs, stream=st, fc=fc,
                    out=tmaster.stylize_from_features_with_stream(pt, fc, st,
                                                                  ct),
                    out_direct=tmaster.stylize_with_style_stream(pt, c, st,
                                                                 ct))


def _mae_max(got: torch.Tensor, want: np.ndarray):
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    return float(err.mean()), float(err.max())


@pytest.mark.parametrize("kernels,k", [(True, 2), (False, 1)],
                         ids=["kernels-on-k2", "kernels-off-k1"])
def test_stream_functions_match_jax(model, kernels, k):
    """All four functions at f32; the batch-1 style stream serves a content
    batch of 2 on both sides."""
    pj, pt = model
    cj, ct = _cfgs(kernels)
    content, style = _images(1, 2), _images(2, 1)
    want = _jax_stream_route(pj, cj, content, style, k)
    got = _port_stream_route(pt, ct, content, style, k)
    for name in ("fs", "fc"):
        assert got[name].shape == want[name].shape
        assert _mae_max(got[name], want[name])[1] <= TOL, name
    assert isinstance(got["stream"], tst.WindowedStyleStream) == kernels
    assert len(got["stream"]) == len(want["stream"]) == k
    if kernels:
        assert got["stream"].hw == want["stream"].hw == (8, 8)
    for gt, wt in zip(got["stream"], want["stream"]):
        for g, w in zip(gt, wt):
            assert tuple(g.shape) == w.shape and g.shape[0] == 1
            assert _mae_max(g, w)[1] <= TOL
    for name in ("out", "out_direct"):
        assert got[name].shape == (2, SIZE, SIZE, 3)
        mae, mx = _mae_max(got[name], want["out"])
        assert mae <= TOL_MAE and mx <= TOL, (name, mae, mx)


def test_bf16_stream_functions_match_jax(model):
    pj, pt = model
    cj, ct = _cfgs(True, "bfloat16")
    pj = jmaster.cast_params(pj, jnp.bfloat16)
    pt = tmaster.cast_params(pt, torch.bfloat16)
    content, style = _images(3, 2), _images(4, 1)
    want = _jax_stream_route(pj, cj, content, style, 1)
    got = _port_stream_route(pt, ct, content, style, 1)
    assert got["stream"][0][0].dtype == torch.bfloat16
    scale = float(np.abs(want["out"]).mean())
    for name in ("out", "out_direct"):
        assert torch.isfinite(got[name]).all()
        mae = _mae_max(got[name], want["out"])[0]
        print(f"bf16 {name}: MAE {mae:.6g}, relative {mae / scale:.6g}")
        assert mae <= TOL_BF16_REL * scale, (name, mae, scale)


def test_stream_api_is_exported():
    for name in ("encode_features", "encode_style_stream",
                 "stylize_from_features_with_stream",
                 "stylize_with_style_stream"):
        assert getattr(tmodels, name) is getattr(tmaster, name)


def _port_streams(pt, ct, styles, k=1):
    with torch.inference_mode():
        return [tmaster.encode_style_stream(pt, torch.from_numpy(s), ct, k=k)
                for s in styles]


def _jax_windowed(stream):
    from mastermetastyletransfer_tpu.models.style_transformer import (
        WindowedStyleStream,
    )

    return WindowedStyleStream(
        [tuple(jnp.asarray(t.numpy()) for t in triple) for triple in stream],
        stream.hw)


def test_blend_style_streams_matches_jax(model):
    """The windowed k=2 streams of two styles (held to JAX's by
    test_stream_functions_match_jax) blended at (0.3, 0.5), normalized to
    sum 1, by the port and by JAX; (1, 0) gives stream a exactly, and its
    output equals stream a's bit for bit."""
    _, pt = model
    _, ct = _cfgs(True)
    st = _port_streams(pt, ct, [_images(5, 1), _images(6, 1)], k=2)
    want = jax.device_get(jinf.blend_style_streams(
        [_jax_windowed(s) for s in st], [0.3, 0.5]))
    got = tinf.blend_style_streams(st, [0.3, 0.5])
    assert isinstance(got, tst.WindowedStyleStream)
    assert got.hw == want.hw == st[0].hw and len(got) == 2
    for gt, wt in zip(got, want):
        for g, w in zip(gt, wt):
            assert g.dtype == torch.float32
            assert _mae_max(g, w)[1] <= 1e-6
    a = tinf.blend_style_streams(st, [1, 0])
    for ta, t0 in zip(a, st[0]):
        for x, y in zip(ta, t0):
            assert torch.equal(x, y)
    content = torch.from_numpy(_images(7, 1))
    with torch.inference_mode():
        outs = [tmaster.stylize_with_style_stream(pt, content, s, ct)
                for s in (a, st[0])]
    assert torch.equal(outs[0], outs[1])


def test_blend_style_streams_refusals(model):
    """JAX's two ValueErrors (weight count, zero sum) on both sides; the
    port also refuses streams of another feature size or another k."""
    pj, pt = model
    _, ct = _cfgs(True)
    st = _port_streams(pt, ct, [_images(8, 1), _images(9, 1)])
    for blend, streams in ((tinf.blend_style_streams, st),
                           (jinf.blend_style_streams,
                            [[tuple(jnp.asarray(t.numpy()) for t in triple)
                              for triple in s] for s in st])):
        with pytest.raises(ValueError, match="weights"):
            blend(streams, [1.0])
        with pytest.raises(ValueError, match="sum to zero"):
            blend(streams, [1.0, -1.0])
    small = np.random.default_rng(10).random((1, 56, 56, 3), np.float32)
    (other_hw,) = _port_streams(pt, ct, [small])
    assert other_hw.hw == (7, 7) and st[0].hw == (8, 8)
    with pytest.raises(ValueError, match="feature sizes"):
        tinf.blend_style_streams([st[0], other_hw], [1, 1])
    (other_k,) = _port_streams(pt, ct, [_images(8, 1)], k=2)
    with pytest.raises(ValueError, match="k=1 and k=2"):
        tinf.blend_style_streams([st[0], other_k], [1, 1])


def _pair_reference(pt, ct, contents, style, k):
    fn = tmaster.make_stylize_fn(ct, k=k, device="cpu")
    return np.stack([fn(pt, c[None], style[None])[0].numpy()
                     for c in contents])


def test_locked_service_matches_pair_service(model):
    """Ten concurrent requests, five each to two locked styles at k = 1
    and 2, with the interpreter switching threads often: each answer is
    the pair route's for its own content and style; an unserved style or
    k raises KeyError."""
    _, pt = model
    _, ct = _cfgs(True)
    styles = {"a": _images(11, 1)[0], "b": _images(12, 1)[0]}
    contents = _images(13, 5)
    svc = LockedStyleService(pt, ct, styles, size=SIZE, ks=(1, 2),
                             max_batch=2, window_ms=20.0, device="cpu")
    try:
        assert set(svc.build_s) == {(n, k) for n in "ab" for k in (1, 2)}
        jobs = [(i, name, k) for i in range(5) for name, k in
                (("a", 1), ("b", 2))]
        results, errors = {}, []

        def call(job):
            i, name, k = job
            try:
                results[job] = svc.stylize(contents[i], name, k=k,
                                           timeout=120)
            except Exception as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=call, args=(j,)) for j in jobs]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)   # interleave the workers and clients
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert not errors and len(results) == len(jobs)
        for name, k in (("a", 1), ("b", 2)):
            want = _pair_reference(pt, ct, contents, styles[name], k)
            got = np.stack([results[(i, name, k)] for i in range(5)])
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        with pytest.raises(KeyError):
            svc.stylize(contents[0], "nope", k=1)
        with pytest.raises(KeyError):
            svc.stylize(contents[0], "a", k=3)
    finally:
        svc.close()
    assert not any(t.is_alive() for t in svc._threads)


def test_micro_batcher_drains_replies_and_outlives_a_failure():
    """The services' worker: while a batch runs, the requests queued behind
    it drain max_batch at a time; each caller gets its own output; a failed
    batch's error reaches its caller and the worker serves the next
    request; ``close`` stops the worker."""
    sizes, entered, gate = [], threading.Event(), threading.Event()

    def run(payloads):
        entered.set()
        assert gate.wait(30)
        sizes.append(len(payloads))
        if "boom" in payloads:
            raise ValueError("boom")
        return [2 * p for p in payloads]

    batcher = _MicroBatcher(run, max_batch=3, window_s=0.05)
    results = {}

    def call(i):
        results[i] = batcher.submit(i, 30)

    threads = [threading.Thread(target=call, args=(0,))]
    threads[0].start()
    assert entered.wait(30)
    threads += [threading.Thread(target=call, args=(i,)) for i in range(1, 8)]
    for t in threads[1:]:
        t.start()
    deadline = time.time() + 30
    while batcher._q.qsize() < 7 and time.time() < deadline:
        time.sleep(0.01)
    gate.set()
    for t in threads:
        t.join(30)
    assert results == {i: 2 * i for i in range(8)}
    assert sizes == [1, 3, 3, 1]
    with pytest.raises(RuntimeError, match="ValueError: boom"):
        batcher.submit("boom", 30)
    assert batcher.submit(5, 30) == 10
    batcher.close(30)
    assert not batcher.thread.is_alive()


def _multipart(fields: dict) -> bytes:
    body = b"".join(
        b"--XB\r\nContent-Disposition: form-data; name=\"%s\"; "
        b"filename=\"x.png\"\r\n\r\n" % name.encode() + data + b"\r\n"
        for name, data in fields.items())
    return body + b"--XB--\r\n"


def _png(img01: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((img01 * 255).astype(np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def _post(url: str, body: bytes):
    req = urllib.request.Request(
        url, data=body,
        headers={"Content-Type": "multipart/form-data; boundary=XB"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_locked_http_route_and_healthz(model):
    """/stylize_locked takes the content alone; /healthz lists the locked
    styles; an unknown style, a k not served, a missing content part, and
    a server without locked styles each get a 400."""
    from http.server import ThreadingHTTPServer

    from PIL import Image

    _, pt = model
    _, ct = _cfgs(True)
    style = _images(14, 1)[0]
    pair = StylizeService(pt, ct, size=SIZE, k=1, max_batch=1, device="cpu")
    locked = LockedStyleService(pt, ct, {"s0": style}, size=SIZE, ks=(1,),
                                max_batch=1, device="cpu")
    servers = [ThreadingHTTPServer(("127.0.0.1", 0),
                                   make_handler({1: pair}, default_k=1,
                                                locked_service=svc))
               for svc in (locked, None)]
    for server in servers:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url, bare = (f"http://127.0.0.1:{s.server_address[1]}"
                     for s in servers)
        with urllib.request.urlopen(url + "/healthz") as r:
            info = json.loads(r.read())
        assert info["locked_styles"] == ["s0"] and info["lambdas"] == []
        assert info["device"] == "cpu"
        content = _images(15, 1)[0]
        body = _multipart({"content": _png(content)})
        code, ctype, data = _post(url + "/stylize_locked?style=s0&k=1", body)
        assert code == 200 and ctype == "image/jpeg"
        got = np.asarray(Image.open(io.BytesIO(data)), np.float32) / 255
        assert got.shape == (SIZE, SIZE, 3)
        # the route's output against the service on the decoded content,
        # up to the JPEG round trip
        from mastermetastyletransfer_tpu_torch.serve import _decode_to
        want = np.clip(locked.stylize(_decode_to(SIZE, _png(content)), "s0",
                                      k=1), 0, 1)
        assert float(np.abs(got - want).mean()) < 0.05
        for path, b in (("/stylize_locked?style=zz&k=1", body),
                        ("/stylize_locked?style=s0&k=2", body),
                        ("/stylize_locked?style=s0&k=x", body),
                        ("/stylize_locked?style=s0",
                         _multipart({"style": _png(content)}))):
            assert _post(url + path, b)[0] == 400, path
        assert _post(bare + "/stylize_locked?style=s0", body)[0] == 400
        assert _post(url + "/nowhere", body)[0] == 404
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
        pair.close()
        locked.close()
