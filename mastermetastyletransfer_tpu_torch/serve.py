"""Serving endpoint for zero-shot stylization (JAX counterpart: serve.py):
a threaded HTTP server with micro-batching. Requests that arrive within a
short window are stacked into one device batch.

    python -m mastermetastyletransfer_tpu_torch.serve --checkpoint params.npz \
        --port 8500 --size 512 --ks 1,3

    POST /stylize[?k=N] with multipart fields "content" and "style" (images)
      -> image/jpeg;  GET /healthz -> {"status": "ok", ...}

    Style-locked serving (one style, many contents): the style's Swin pass
    and its k encoder triples are computed once per (style, k) at startup,
    and each request pays only the content's half of the model:
      --locked_style vangogh=starry.jpg
      POST /stylize_locked?style=vangogh&k=1 with a multipart "content"

    The style-lambda sweep (lambda selects a parameter set; the reference's
    pretrained_model_lambda_is_{2,4}.pt):
      --lambda_checkpoint lambda2=l2.npz --lambda_checkpoint lambda4=l4.npz
      POST /sweep?k=1 (content and style) -> JSON {"lambda2": <base64
      JPEG>, ...}

The model runs on CUDA unless ``--device cpu`` is given. Request bodies
(and ``--locked_style`` files) are read without PIL by
``data.pipeline.decode_image``, which picks the reader as PIL's
``Image.open`` picks its plugin: JPEG (every kind PIL reads), GIF, WebP
and the compressed strips of TIFF by the port's native code
(native/jpeg.cpp, gif.cpp, webp.cpp, tiff.cpp), PNG, BMP, DIB, ICO,
Netpbm and TIFF's layout in numpy, each then resized with Pillow's
BILINEAR in numpy, so a request decodes to the JAX package's array. Replies are JPEG at quality 95 from the port's own encoder. A body
none of the readers reads gets a 400 naming the reason and what is read
(``data.pipeline.READ_FORMATS``). The services (``StylizeService``,
``LockedStyleService``, ``SweepService``) take and return numpy arrays.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mastermetastyletransfer_tpu_torch.config import ModelConfig
from mastermetastyletransfer_tpu_torch.data.native_loader import encode_jpeg
from mastermetastyletransfer_tpu_torch.data.pipeline import (
    _resize_bilinear, decode_image,
)
from mastermetastyletransfer_tpu_torch.inference import make_lambda_sweep_fn
from mastermetastyletransfer_tpu_torch.models.master import (
    encode_style_stream, make_stylize_fn, stylize_with_style_stream,
)
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


def _pad_batch(x: np.ndarray, n: int) -> np.ndarray:
    """x with zero images appended up to n along the batch axis, so that the
    device always sees one shape, as in the JAX package."""
    if x.shape[0] >= n:
        return x
    return np.concatenate(
        [x, np.zeros((n - x.shape[0],) + x.shape[1:], np.float32)])


class _MicroBatcher:
    """One request queue and its worker thread. The worker coalesces the
    requests that arrive within ``window_s`` of the first, up to
    ``max_batch``, calls ``run`` on their payloads (a list; it returns at
    least one output per payload, in order) and hands each caller its
    output, or the batch's error. ``close`` stops the worker after the
    requests queued before it."""

    _STOP = object()

    def __init__(self, run, max_batch: int, window_s: float):
        self._run = run
        self._max_batch = max_batch
        self._window_s = window_s
        self._q: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        while True:
            first = self._q.get()
            if first is self._STOP:
                return
            batch = _drain_batch(self._q, first, self._max_batch,
                                 self._window_s)
            stop = any(item is self._STOP for item in batch)
            batch = [item for item in batch if item is not self._STOP]
            try:
                outs = self._run([payload for payload, _ in batch])
                for (_, rq), out in zip(batch, outs):
                    rq.put(("ok", out))
            except Exception as e:  # the worker must outlive a failed batch
                for _, rq in batch:
                    rq.put(("error", f"{type(e).__name__}: {e}"))
            if stop:
                return

    def submit(self, payload, timeout: float):
        """Queue one request; blocks until its batch has run."""
        rq: queue.Queue = queue.Queue()
        self._q.put((payload, rq))
        status, out = rq.get(timeout=timeout)
        if status != "ok":
            raise RuntimeError(out)
        return out

    def close(self, timeout: float):
        self._q.put(self._STOP)
        self.thread.join(timeout)


class StylizeService:
    """Micro-batching service over ``master_apply``. One worker thread owns
    the device; a partial micro-batch is padded to ``max_batch`` so that the
    device always sees one shape, as in the JAX package. ``close`` stops
    the worker."""

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
        self._batcher = _MicroBatcher(self._run_requests, max_batch,
                                      self.window_s)
        self._thread = self._batcher.thread

    def warmup(self):
        """Run the micro-batch shape once (kernel build and first launch)."""
        z = np.zeros((self.max_batch, self.size, self.size, 3), np.float32)
        self._run(z, z)

    def _run(self, content: np.ndarray, style: np.ndarray) -> np.ndarray:
        out = self._fn(self.params, content, style)
        return out.cpu().numpy()

    def _run_requests(self, reqs: list) -> np.ndarray:
        return self._run(
            _pad_batch(np.stack([c for c, _ in reqs]), self.max_batch),
            _pad_batch(np.stack([s for _, s in reqs]), self.max_batch))

    def stylize(self, content: np.ndarray, style: np.ndarray,
                timeout: float = 60.0) -> np.ndarray:
        """Stylize one (H, W, 3) pair; blocks until its batch has run."""
        return self._batcher.submit((np.asarray(content, np.float32),
                                     np.asarray(style, np.float32)), timeout)

    def close(self, timeout: float = 60.0):
        """Stop the worker after the requests queued before this call."""
        self._batcher.close(timeout)


class LockedStyleService:
    """Style-locked serving: each style's Swin pass and its k style-
    transformer encoder triples are computed once per (style, k), here in
    the constructor (``encode_style_stream``; exact, since the encoder
    reads the style alone), so that each request pays only the content's
    Swin pass, the transformer's decoder half and the CNN decoder. The
    classic style-transfer serving workload (one style, many contents);
    the reference runs the whole pair model per request
    (codes/full_model.py:219-226).

    Requests micro-batch per (style, k): one queue and one worker thread
    per key, all behind one device lock; a partial micro-batch is padded to
    ``max_batch``, as in ``StylizeService``. ``build_s`` holds each
    stream's build time in seconds. ``close`` stops the workers."""

    def __init__(self, params: dict, cfg: ModelConfig, styles: dict, *,
                 size: int = 512, ks: Sequence[int] = (1,),
                 max_batch: int = 8, window_ms: float = 5.0, device="cuda"):
        self.device = torch.device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.cfg = cfg
        self.size = size
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.names = list(styles)
        self.ks = list(ks)
        self._lock = threading.Lock()
        self.streams, self.build_s = {}, {}
        for name, img in styles.items():
            style = torch.as_tensor(np.asarray(img, np.float32)[None],
                                    device=self.device)
            for k in self.ks:
                t0 = time.perf_counter()
                with torch.inference_mode():
                    self.streams[(name, k)] = encode_style_stream(
                        self.params, style, cfg, k=k)
                self._sync()
                self.build_s[(name, k)] = time.perf_counter() - t0
        self._batchers = {
            key: _MicroBatcher(
                lambda reqs, stream=stream: self._run(
                    _pad_batch(np.stack(reqs), max_batch), stream),
                max_batch, self.window_s)
            for key, stream in self.streams.items()}
        self._threads = [b.thread for b in self._batchers.values()]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self):
        """Run one micro-batch per k against the first style's stream,
        bypassing the queues (kernel build and first launch)."""
        z = np.zeros((self.max_batch, self.size, self.size, 3), np.float32)
        for k in self.ks:
            self._run(z, self.streams[(self.names[0], k)])

    def _run(self, contents: np.ndarray, stream) -> np.ndarray:
        with self._lock, torch.inference_mode():
            x = torch.as_tensor(contents, device=self.device)
            out = stylize_with_style_stream(self.params, x, stream, self.cfg)
            return out.cpu().numpy()

    def stylize(self, content: np.ndarray, name: str, *, k: int,
                timeout: float = 60.0) -> np.ndarray:
        """Stylize one (H, W, 3) content with the locked style ``name`` at
        depth k; KeyError for a (style, k) not served."""
        if (name, k) not in self._batchers:
            raise KeyError(f"locked style ({name!r}, k={k}) not served "
                           f"(styles: {self.names}, ks: {self.ks})")
        return self._batchers[(name, k)].submit(
            np.asarray(content, np.float32), timeout)

    def close(self, timeout: float = 60.0):
        """Stop the workers after the requests queued before this call."""
        for b in self._batchers.values():
            b.close(timeout)


class SweepService:
    """The style-lambda sweep over named parameter sets, moved to the
    device once and run set by set per call
    (``inference.make_lambda_sweep_fn``, one per served k), behind one
    device lock."""

    def __init__(self, param_sets: dict, cfg: ModelConfig, *, size: int,
                 ks: Sequence[int], device="cuda"):
        self.device = torch.device(device)
        self.names = list(param_sets)
        self.size = size
        self._sets = [tree_map(lambda t: t.to(self.device), param_sets[n])
                      for n in self.names]
        self._fns = {k: make_lambda_sweep_fn(cfg, k=k, device=self.device)
                     for k in ks}
        self._lock = threading.Lock()

    def warmup(self):
        z = np.zeros((self.size, self.size, 3), np.float32)
        for k in self._fns:
            self.sweep(z, z, k=k)

    def sweep(self, content: np.ndarray, style: np.ndarray, *,
              k: int) -> dict:
        """{name: (H, W, 3) stylization} of one pair under every set;
        KeyError for a k not served."""
        if k not in self._fns:
            raise KeyError(f"k={k} not served (available: {list(self._fns)})")
        with self._lock:
            outs = self._fns[k](self._sets,
                                np.asarray(content, np.float32)[None],
                                np.asarray(style, np.float32)[None])
            outs = outs.cpu().numpy()   # (sets, 1, H, W, 3)
        return {name: outs[i, 0] for i, name in enumerate(self.names)}


def _decode_to(size: int, data: bytes) -> np.ndarray:
    """An image body as float32 (size, size, 3) in [0, 1]: decoded,
    resized with Pillow's BILINEAR (JAX: PIL's convert("RGB").resize);
    ValueError for a body no reader reads."""
    pixels = _resize_bilinear(decode_image(data), size)
    return pixels.astype(np.float32) / 255.0


def _encode_jpeg(img01: np.ndarray) -> bytes:
    """A [0, 1] image as JPEG at quality 95 (values scaled by 255, clipped,
    truncated, as the JAX package hands them to PIL)."""
    return encode_jpeg(np.clip(img01 * 255, 0, 255).astype(np.uint8), 95)


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


class _BadImage(ValueError):
    """A request part no reader reads: the client's fault, a 400."""


def _decode_part(size: int, parts: dict, name: str) -> np.ndarray:
    try:
        return _decode_to(size, parts[name])
    except ValueError as e:
        raise _BadImage(f"part {name!r}: {e}") from e


def make_handler(services: Dict[int, StylizeService], default_k: int, *,
                 sweep_service: Optional[SweepService] = None,
                 locked_service: Optional[LockedStyleService] = None):
    """services: {k: StylizeService}; same-k requests batch together.
    ``sweep_service`` serves /sweep, ``locked_service`` /stylize_locked."""
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

        def _bad(self, msg: str):
            self._reply(400, msg.encode(), "text/plain")

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                info = {"status": "ok", "size": any_service.size,
                        "max_batch": any_service.max_batch,
                        "ks": sorted(services),
                        "lambdas": (sweep_service.names
                                    if sweep_service else []),
                        "locked_styles": (locked_service.names
                                          if locked_service else []),
                        "device": str(any_service.device)}
                self._reply(200, json.dumps(info).encode(),
                            "application/json")
            else:
                self._reply(404, b"not found", "text/plain")

        def _read_parts(self) -> dict:
            """The multipart fields of the body ({} if it is none)."""
            body = self.rfile.read(int(self.headers["Content-Length"]))
            ctype = self.headers.get("Content-Type", "")
            if "multipart/form-data" not in ctype or "boundary=" not in ctype:
                return {}
            boundary = (ctype.split("boundary=")[1].split(";")[0]
                        .strip().strip('"').encode())
            return _parse_multipart(body, boundary)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path not in ("/stylize", "/stylize_locked", "/sweep"):
                self._reply(404, b"not found", "text/plain")
                return
            query = parse_qs(url.query)
            try:
                k = int(query.get("k", [default_k])[0])
            except ValueError:
                self._bad("k must be an integer")
                return
            try:
                if url.path == "/stylize_locked":
                    self._locked(k, query)
                elif url.path == "/sweep":
                    self._sweep(k)
                else:
                    self._stylize(k)
            except _BadImage as e:
                self._bad(str(e))
            except Exception as e:  # report, keep serving
                self._reply(500, f"{type(e).__name__}: {e}".encode(),
                            "text/plain")

        def _stylize(self, k: int):
            if k not in services:
                self._bad(f"k={k} not served (ks={sorted(services)})")
                return
            parts = self._read_parts()
            if "content" not in parts or "style" not in parts:
                self._bad("expected multipart/form-data with 'content' and "
                          "'style' parts")
                return
            out = services[k].stylize(
                _decode_part(any_service.size, parts, "content"),
                _decode_part(any_service.size, parts, "style"))
            self._reply(200, _encode_jpeg(out), "image/jpeg")

        def _locked(self, k: int, query: dict):
            if locked_service is None:
                self._bad("no --locked_style styles loaded")
                return
            parts = self._read_parts()
            if "content" not in parts:
                self._bad("expected multipart/form-data with a 'content' "
                          "part")
                return
            name = query.get("style", [locked_service.names[0]])[0]
            content = _decode_part(locked_service.size, parts, "content")
            try:
                out = locked_service.stylize(content, name, k=k)
            except KeyError as e:
                self._bad(str(e))
                return
            self._reply(200, _encode_jpeg(out), "image/jpeg")

        def _sweep(self, k: int):
            import base64

            if sweep_service is None:
                self._bad("no --lambda_checkpoint sets loaded")
                return
            parts = self._read_parts()
            if "content" not in parts or "style" not in parts:
                self._bad("expected multipart/form-data with 'content' and "
                          "'style' parts")
                return
            try:
                outs = sweep_service.sweep(
                    _decode_part(sweep_service.size, parts, "content"),
                    _decode_part(sweep_service.size, parts, "style"), k=k)
            except KeyError as e:
                self._bad(str(e))
                return
            payload = {name: base64.b64encode(_encode_jpeg(img)).decode()
                       for name, img in outs.items()}
            self._reply(200, json.dumps(payload).encode(),
                        "application/json")

    return Handler


def _named(specs, flag: str) -> dict:
    """NAME=PATH arguments -> {NAME: PATH}."""
    out = {}
    for spec in specs:
        name, _, path = spec.partition("=")
        if not name or not path:
            raise SystemExit(f"{flag} wants NAME=PATH, got {spec!r}")
        out[name] = path
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz params export (the JAX package's key scheme)")
    ap.add_argument("--lambda_checkpoint", action="append", default=[],
                    metavar="NAME=PATH",
                    help="a named lambda-tagged .npz parameter set for "
                         "POST /sweep; repeatable (e.g. lambda2=l2.npz)")
    ap.add_argument("--locked_style", action="append", default=[],
                    metavar="NAME=IMAGE",
                    help="a named style image locked at startup for POST "
                         "/stylize_locked (its Swin pass and k encoder "
                         "triples computed once; requests send the content "
                         "alone); repeatable")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--ks", default="1",
                    help="comma list of served style-transformer depths k")
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run the Swin blocks, the style transformer and "
                         "the decoder through the hand-written kernels "
                         "(the JAX package's name for its fused kernels; "
                         "disable with --no-use_pallas)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights used without "
                         "--checkpoint")
    args = ap.parse_args(argv)
    args.lambda_checkpoint = _named(args.lambda_checkpoint,
                                    "--lambda_checkpoint")
    args.locked_style = _named(args.locked_style, "--locked_style")
    args.ks = sorted({int(k) for k in args.ks.split(",")})
    return args


def main(argv=None):
    args = parse_args(argv)

    from mastermetastyletransfer_tpu_torch.models.master import (
        init_master_model,
    )
    from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    cfg = ModelConfig(compute_dtype=args.compute_dtype).with_kernels(
        args.use_pallas)
    params = init_master_model(
        cfg, torch.Generator().manual_seed(args.seed), device=args.device)
    if args.checkpoint:
        params = load_params_npz(args.checkpoint, params)
    ks = args.ks
    services = {k: StylizeService(params, cfg, size=args.size, k=k,
                                  max_batch=args.max_batch,
                                  device=args.device) for k in ks}
    sweep_service = locked_service = None
    if args.lambda_checkpoint:
        sweep_service = SweepService(
            {name: load_params_npz(path, params)
             for name, path in args.lambda_checkpoint.items()},
            cfg, size=args.size, ks=ks, device=args.device)
    if args.locked_style:
        styles = {}
        for name, path in args.locked_style.items():
            with open(path, "rb") as f:
                styles[name] = _decode_to(args.size, f.read())
        locked_service = LockedStyleService(
            params, cfg, styles, size=args.size, ks=ks,
            max_batch=args.max_batch, device=args.device)
    print(f"warming up ({args.size}x{args.size}, ks={ks}, {args.device}"
          f"{', sweep ' + str(sweep_service.names) if sweep_service else ''}"
          f"{', locked ' + str(locked_service.names) if locked_service else ''}"
          ")...")
    for s in (*services.values(), sweep_service, locked_service):
        if s is not None:
            s.warmup()
    server = ThreadingHTTPServer(
        ("0.0.0.0", args.port),
        make_handler(services, default_k=ks[0], sweep_service=sweep_service,
                     locked_service=locked_service))
    print(f"serving on :{args.port}  (POST /stylize[?k=N], POST "
          "/stylize_locked[?style=NAME&k=N], POST /sweep[?k=N], GET "
          "/healthz)")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        for s in (*services.values(), locked_service):
            if s is not None:
                s.close()


if __name__ == "__main__":
    main()
