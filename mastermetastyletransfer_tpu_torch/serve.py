"""Pair-serving endpoint for zero-shot stylization (JAX counterpart:
serve.py): a threaded HTTP server with micro-batching. Requests that arrive
within a short window are stacked into one device batch.

    python -m mastermetastyletransfer_tpu_torch.serve --checkpoint params.npz \
        --port 8500 --size 512 --ks 1,3

    POST /stylize[?k=N] with multipart fields "content" and "style" (images)
      -> image/jpeg;  GET /healthz -> {"status": "ok", ...}

The model runs on CUDA unless ``--device cpu`` is given. JPEG decoding and
encoding use PIL, imported only by the two codec functions: the service
itself (``StylizeService``) takes and returns numpy arrays.
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

import numpy as np
import torch

from mastermetastyletransfer_tpu_torch.config import ModelConfig
from mastermetastyletransfer_tpu_torch.models.master import make_stylize_fn
from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map


def _drain_batch(q: "queue.Queue", first, max_batch: int, window_s: float):
    """Coalesce requests arriving within the micro-batch window."""
    batch = [first]
    deadline = time.time() + window_s
    while len(batch) < max_batch:
        timeout = deadline - time.time()
        if timeout <= 0:
            break
        try:
            batch.append(q.get(timeout=timeout))
        except queue.Empty:
            break
    return batch


class StylizeService:
    """Micro-batching service over ``master_apply``. One worker thread owns
    the device; a partial micro-batch is padded to ``max_batch`` so that the
    device always sees one shape, as in the JAX package. ``close`` stops
    the worker."""

    _STOP = object()

    def __init__(self, params: dict, cfg: ModelConfig, *, size: int = 512,
                 k: int = 1, max_batch: int = 8, window_ms: float = 5.0,
                 device="cuda"):
        self.device = torch.device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.cfg = cfg
        self.size = size
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self._fn = make_stylize_fn(cfg, k=k, device=self.device)
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def warmup(self):
        """Run the micro-batch shape once (kernel build and first launch)."""
        z = np.zeros((self.max_batch, self.size, self.size, 3), np.float32)
        self._run(z, z)

    def _run(self, content: np.ndarray, style: np.ndarray) -> np.ndarray:
        out = self._fn(self.params, content, style)
        return out.cpu().numpy()

    def _loop(self):
        while True:
            first = self._q.get()
            if first is self._STOP:
                return
            batch = _drain_batch(self._q, first, self.max_batch, self.window_s)
            stop = any(item is self._STOP for item in batch)
            batch = [item for item in batch if item is not self._STOP]
            contents = np.concatenate([b[0] for b in batch])
            styles = np.concatenate([b[1] for b in batch])
            n = contents.shape[0]
            if n < self.max_batch:
                pad = np.zeros((self.max_batch - n,) + contents.shape[1:],
                               np.float32)
                contents = np.concatenate([contents, pad])
                styles = np.concatenate([styles, pad])
            try:
                outs = self._run(contents, styles)
                for i, (_, _, rq) in enumerate(batch):
                    rq.put(("ok", outs[i]))
            except Exception as e:  # the worker must outlive a failed batch
                for _, _, rq in batch:
                    rq.put(("error", f"{type(e).__name__}: {e}"))
            if stop:
                return

    def stylize(self, content: np.ndarray, style: np.ndarray,
                timeout: float = 60.0) -> np.ndarray:
        """Stylize one (H, W, 3) pair; blocks until its batch has run."""
        rq: queue.Queue = queue.Queue()
        self._q.put((np.asarray(content, np.float32)[None],
                     np.asarray(style, np.float32)[None], rq))
        status, payload = rq.get(timeout=timeout)
        if status != "ok":
            raise RuntimeError(payload)
        return payload

    def close(self, timeout: float = 60.0):
        """Stop the worker after the requests queued before this call."""
        self._q.put(self._STOP)
        self._thread.join(timeout)


def _decode_to(size: int, data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0


def _encode_jpeg(img01: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.clip(img01 * 255, 0, 255).astype(np.uint8)).save(
        buf, "JPEG", quality=95)
    return buf.getvalue()


def _parse_multipart(body: bytes, boundary: bytes) -> dict:
    """Binary-safe multipart/form-data parser for the content and style
    fields: splits on the full CRLF--boundary delimiter (RFC 2046), so part
    payloads are taken byte-exact."""
    parts = {}
    chunks = (b"\r\n" + body).split(b"\r\n--" + boundary)
    for chunk in chunks[1:]:
        if chunk.startswith(b"--"):
            break
        if chunk.startswith(b"\r\n"):
            chunk = chunk[2:]
        head, sep, payload = chunk.partition(b"\r\n\r\n")
        if not sep:
            continue
        for field in (b'name="content"', b'name="style"'):
            if field in head:
                parts[field.split(b'"')[1].decode()] = payload
    return parts


def make_handler(services: Dict[int, StylizeService], default_k: int):
    """services: {k: StylizeService}; same-k requests batch together."""
    from urllib.parse import parse_qs, urlparse

    any_service = services[default_k]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                info = {"status": "ok", "size": any_service.size,
                        "max_batch": any_service.max_batch,
                        "ks": sorted(services),
                        "device": str(any_service.device)}
                self._reply(200, json.dumps(info).encode(),
                            "application/json")
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/stylize":
                self._reply(404, b"not found", "text/plain")
                return
            try:
                k = int(parse_qs(url.query).get("k", [default_k])[0])
            except ValueError:
                self._reply(400, b"k must be an integer", "text/plain")
                return
            if k not in services:
                self._reply(400, f"k={k} not served (ks={sorted(services)})"
                            .encode(), "text/plain")
                return
            try:
                length = int(self.headers["Content-Length"])
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                parts = None
                if "multipart/form-data" in ctype and "boundary=" in ctype:
                    boundary = (ctype.split("boundary=")[1].split(";")[0]
                                .strip().strip('"').encode())
                    parts = _parse_multipart(body, boundary)
                if not parts or "content" not in parts or "style" not in parts:
                    self._reply(400, b"expected multipart/form-data with "
                                b"'content' and 'style' parts", "text/plain")
                    return
                out = services[k].stylize(
                    _decode_to(any_service.size, parts["content"]),
                    _decode_to(any_service.size, parts["style"]))
                self._reply(200, _encode_jpeg(out), "image/jpeg")
            except Exception as e:  # report, keep serving
                self._reply(500, f"{type(e).__name__}: {e}".encode(),
                            "text/plain")

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz params export (the JAX package's key scheme)")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--ks", default="1",
                    help="comma list of served style-transformer depths k")
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--use_kernels", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run the Swin blocks and the style transformer "
                         "through the hand-written kernels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights used without "
                         "--checkpoint")
    args = ap.parse_args(argv)

    from mastermetastyletransfer_tpu_torch.models.master import (
        init_master_model,
    )
    from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    cfg = ModelConfig(compute_dtype=args.compute_dtype).with_kernels(
        args.use_kernels)
    params = init_master_model(
        cfg, torch.Generator().manual_seed(args.seed), device=args.device)
    if args.checkpoint:
        params = load_params_npz(args.checkpoint, params)
    ks = sorted({int(k) for k in args.ks.split(",")})
    services = {k: StylizeService(params, cfg, size=args.size, k=k,
                                  max_batch=args.max_batch,
                                  device=args.device) for k in ks}
    print(f"warming up ({args.size}x{args.size}, ks={ks}, {args.device})...")
    for s in services.values():
        s.warmup()
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(services, default_k=ks[0]))
    print(f"serving on :{args.port}  (POST /stylize[?k=N], GET /healthz)")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        for s in services.values():
            s.close()


if __name__ == "__main__":
    main()
