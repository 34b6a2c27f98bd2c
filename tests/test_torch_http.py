"""The HTTP layer on the CPU: the same requests to the JAX package's
``make_handler`` (PIL's codecs) and to the port's (its own JPEG decoder
and encoder, its PNG, BMP and WebP readers), each behind a
``ThreadingHTTPServer`` on 127.0.0.1, at float32 with the same converted
weights, 64^2, k=1, the kernels off on both sides (their parity is other
files' business).

Bound: the two replies, decoded by PIL, differ by no more than the JPEG
noise at quality 95 measured here on the same output (PIL's quality-95
round trip of JAX's output quantised: its mean and its max over the
image); the port's reply against its service's own output on the same
decoded inputs within that noise plus one level of quantisation.
chip_smoke.py's ``http`` phase holds each reply's mean error on the card
to ``TOL_JPEG95_MEAN``, twice the noise measured here at its own weights
and requests at 512^2 (``test_jpeg_noise_at_the_http_phase_inputs``).
"""

import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu import serve as jserve
from mastermetastyletransfer_tpu.models import master as jmaster
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch import serve as tserve
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax
from scripts.make_jpeg_fixtures import smooth
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = 64


@pytest.fixture(scope="module")
def servers():
    pj = jax.device_get(jmaster.init_master_model(jax.random.PRNGKey(0),
                                                  jcfg.ModelConfig()))
    cj = jcfg.ModelConfig()
    ct = tcfg.ModelConfig.from_dict(cj.to_dict())
    jsvc = jserve.StylizeService(jax.tree_util.tree_map(jnp.asarray, pj), cj,
                                 size=SIZE, k=1, max_batch=2)
    tsvc = tserve.StylizeService(params_from_jax(pj), ct, size=SIZE, k=1,
                                 max_batch=2, device="cpu")
    httpd = {
        "jax": ThreadingHTTPServer(("127.0.0.1", 0), jserve.make_handler(
            {1: jsvc}, None, default_k=1)),
        "port": ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(
            {1: tsvc}, default_k=1)),
    }
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in httpd.values()]
    for t in threads:
        t.start()
    try:
        yield {"svc": {"jax": jsvc, "port": tsvc},
               "url": {name: f"http://127.0.0.1:{s.server_address[1]}"
                       for name, s in httpd.items()}}
    finally:
        for s in httpd.values():
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        tsvc.close()


def _multipart(fields: dict) -> bytes:
    body = b"".join(
        b"--XB\r\nContent-Disposition: form-data; name=\"%s\"; "
        b"filename=\"x\"\r\n\r\n" % name.encode() + data + b"\r\n"
        for name, data in fields.items())
    return body + b"--XB--\r\n"


def _post(url: str, body: bytes, ctype="multipart/form-data; boundary=XB"):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _encoded(img: np.ndarray, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == "JPEG"
        return np.asarray(im.convert("RGB")).astype(np.int64)


def _quantised(img01: np.ndarray) -> np.ndarray:
    return np.clip(img01 * 255, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("fmt", ["JPEG", "PNG", "BMP", "WEBP"])
def test_stylize_replies_match_jax_within_jpeg_noise(servers, fmt):
    rng = np.random.default_rng(len(fmt))
    content, style = smooth(rng, 80, 96), smooth(rng, 70, 60)
    kw = {"quality": 92} if fmt == "JPEG" else {}
    body = _multipart({"content": _encoded(content, fmt, **kw),
                       "style": _encoded(style, fmt, **kw)})
    replies = {}
    for name, url in servers["url"].items():
        code, ctype, data = _post(url + "/stylize", body)
        assert code == 200 and ctype == "image/jpeg", (name, data[:200])
        replies[name] = _pil(data)
    # JPEG noise at quality 95 on this output: PIL's round trip of JAX's
    # output on JAX's decoded inputs, quantised as the server does
    decoded = {name: [mod._decode_to(SIZE, _encoded(x, fmt, **kw))
                      for x in (content, style)]
               for name, mod in (("jax", jserve), ("port", tserve))}
    jax_out = _quantised(servers["svc"]["jax"].stylize(*decoded["jax"]))
    noise = np.abs(_pil(_encoded(jax_out, "JPEG", quality=95))
                   - jax_out.astype(np.int64))
    diff = np.abs(replies["port"] - replies["jax"])
    print(f"{fmt}: JPEG q95 noise mean {noise.mean():.3f} max {noise.max()} "
          f"levels; replies differ mean {diff.mean():.4f} max {diff.max()}")
    assert diff.mean() <= noise.mean() and diff.max() <= noise.max()
    # the port's reply against its own service's output on the same inputs
    port_out = servers["svc"]["port"].stylize(*decoded["port"])
    err = np.abs(replies["port"] - np.clip(port_out * 255, 0, 255))
    assert err.mean() <= noise.mean() + 1 and err.max() <= noise.max() + 1


def test_progressive_bodies_read_as_their_baseline_files(servers):
    """A progressive JPEG body decodes (``serve._decode_to``) to the array
    of the baseline file of the same image at the same quality (the same
    coefficients, coded in another order), and the port's server answers
    progressive bodies 200 with the very reply it gives the baseline
    ones."""
    rng = np.random.default_rng(9)
    images = smooth(rng, 80, 96), smooth(rng, 70, 60)
    bodies = {prog: [_encoded(x, "JPEG", quality=92, progressive=prog)
                     for x in images] for prog in (False, True)}
    assert all(b"\xff\xc2" in b for b in bodies[True])
    for size in (SIZE, 128):
        for base, prog in zip(bodies[False], bodies[True]):
            assert np.array_equal(tserve._decode_to(size, prog),
                                  tserve._decode_to(size, base))
    url = servers["url"]["port"] + "/stylize"
    replies = {}
    for prog, (content, style) in bodies.items():
        code, ctype, data = _post(url, _multipart({"content": content,
                                                   "style": style}))
        assert code == 200 and ctype == "image/jpeg", data[:200]
        replies[prog] = data
    assert replies[True] == replies[False]


def test_bad_requests_get_400(servers):
    """A body that is not multipart, a missing part and an unknown k are
    400 on both servers; an image body no reader reads (a truncated JPEG,
    an SGI image, a truncated WebP) is a 400 from the port, naming the reason
    (JAX answers those 500, PIL's exception)."""
    rng = np.random.default_rng(7)
    jpeg = _encoded(smooth(rng, 40, 40), "JPEG", quality=90)
    for name, url in servers["url"].items():
        assert _post(url + "/stylize", b"not multipart",
                     ctype="text/plain")[0] == 400, name
        assert _post(url + "/stylize",
                     _multipart({"content": jpeg}))[0] == 400, name
        assert _post(url + "/stylize?k=2",
                     _multipart({"content": jpeg, "style": jpeg}))[0] == 400
    url = servers["url"]["port"]
    sgi = _encoded(smooth(rng, 40, 40), "SGI")
    webp = _encoded(smooth(rng, 40, 40), "WEBP")
    for bad, why in ((jpeg[:len(jpeg) // 2], "JPEG"),
                     (sgi, "baseline JPEG"),
                     (webp[:len(webp) // 2], "WebP: truncated")):
        code, ctype, data = _post(url + "/stylize", _multipart(
            {"content": bad, "style": jpeg}))
        assert code == 400 and ctype == "text/plain", data
        assert why in data.decode() and "'content'" in data.decode()
    # the server keeps serving after them
    code, ctype, _ = _post(url + "/stylize", _multipart(
        {"content": jpeg, "style": jpeg}))
    assert code == 200 and ctype == "image/jpeg"


def test_bombs_get_400(servers):
    """Bodies that claim more than a request may make the server allocate
    (a JPEG or PNG frame above PIL's decompression-bomb limit, a JPEG frame
    its bytes could not code, a DC table symbol of 200, a progressive
    frame whose coefficient buffer is above the limit) are each a 400
    naming the reason, and the server keeps serving."""
    from tests.test_torch_codecs import (
        bomb_bodies, png_bomb, progressive_bomb,
    )

    url = servers["url"]["port"]
    jpeg = _encoded(smooth(np.random.default_rng(8), 40, 40), "JPEG",
                    quality=90)
    cases = dict(bomb_bodies(), png=(png_bomb(), "decompression bomb"),
                 progressive=(progressive_bomb(), "coefficient buffer"))
    for name, (bad, why) in cases.items():
        code, ctype, data = _post(url + "/stylize", _multipart(
            {"content": jpeg, "style": bad}))
        assert code == 400 and ctype == "text/plain", (name, data)
        assert why in data.decode() and "'style'" in data.decode(), name
    code, ctype, _ = _post(url + "/stylize", _multipart(
        {"content": jpeg, "style": jpeg}))
    assert code == 200 and ctype == "image/jpeg"


def test_healthz_as_jax(servers):
    infos = {}
    for name, url in servers["url"].items():
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert r.headers["Content-Type"] == "application/json"
            infos[name] = json.loads(r.read())
    assert infos["port"].pop("device") == "cpu"
    assert infos["port"] == infos["jax"]


def test_jpeg_noise_at_the_http_phase_inputs():
    """chip_smoke.py's ``http`` bound measured here: its weights (HTTP_SEED)
    and two of its requests (k = 1 and 3) at 512^2, f32 with the kernels
    off on the CPU; each output's JPEG noise at quality 95 (the mean error
    of the port's round trip in levels, what a reply's error is when its
    bytes are the encoder's on the service's output) under
    TOL_JPEG95_MEAN."""
    import chip_smoke as cs
    import torch

    from mastermetastyletransfer_tpu_torch.data.native_loader import (
        decode_jpeg, encode_jpeg,
    )
    from mastermetastyletransfer_tpu_torch.models.master import (
        init_master_model, make_stylize_fn,
    )

    cfg = cs.slice_config("float32", False)
    params = init_master_model(
        cfg, torch.Generator().manual_seed(cs.HTTP_SEED), device="cpu")
    reqs = cs.http_requests(cs.http_inputs())["stylize"]
    for k, path, fields in (reqs[0], reqs[cs.HTTP_PAIR_REQUESTS + 1]):
        content, style = (tserve._decode_to(cs.SIZE, fields[f])[None]
                          for f in ("content", "style"))
        out = make_stylize_fn(cfg, k=k, device="cpu")(params, content,
                                                      style)[0].numpy()
        q = _quantised(out)
        noise = np.abs(decode_jpeg(encode_jpeg(q, 95)).astype(np.int64) - q)
        print(f"{path}: JPEG q95 noise mean {noise.mean():.3f}, max "
              f"{noise.max()} levels")
        assert noise.mean() <= cs.TOL_JPEG95_MEAN, path
