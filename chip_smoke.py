"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA sources (csrc/ -> build/, at first use), holds each
kernel entry against its plain PyTorch version at the shapes of the slice,
then drives the slice -- pair serving, ``StylizeService`` -> ``master_apply``
at swin_B widths, 512x512 images, k=1 -- through its entry points with
weights drawn from a seeded ``torch.Generator``. One JSON line per phase,
flushed as it goes; any failed phase raises and the exit code is not 0. The
last line is {"ok": true, "device": {...}}; before it come the card's name
and power limit as nvidia-smi gives them, and the kernel summary.

Needs only torch, numpy and the standard library, and one CUDA card.

Tolerances, kernel against plain version, element by element. float32:
1e-4 of the largest magnitude of the plain output (order of sums).
bfloat16: two units in the last place of the plain output element (the two
sides round the same f32 value to bf16, and a value near a rounding
boundary may land on either side) plus 2^-6 of the block's largest update
|out - x| (an intermediate rounded to bf16 on the other side of a boundary
moves the update by about 2^-8 of itself). Both entries are checked at
float32 on the slice's blocks as well. Slice: the kernel-path service
against the same service with the blocks in plain PyTorch, per-pixel MAE
relative to the mean output magnitude: 2e-2 at bfloat16 (independent
roundings of two bf16 paths through the whole model), 1e-4 at float32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from mastermetastyletransfer_tpu_torch.config import (
    AttentionConfig, ModelConfig,
)
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    init_style_swin_block,
)
from mastermetastyletransfer_tpu_torch.ops import _build
from mastermetastyletransfer_tpu_torch.ops import window_block as wb
from mastermetastyletransfer_tpu_torch.ops.windows import (
    effective_shift, shift_attention_mask, valid_token_mask, window_partition,
)
from mastermetastyletransfer_tpu_torch.serve import StylizeService
from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL_F32 = 1e-4
TOL_BF16_ULPS, TOL_BF16_UPDATE = 2, 2.0 ** -6
TOL_SLICE_MAE = {"bfloat16": 2e-2, "float32": 1e-4}
# The dtype each entry runs at on the main path.
MAIN_DTYPE = {"window_block_rows": "bfloat16",
              "window_block_windows": "float32"}

DEVICE = "cuda"
SIZE, MAX_BATCH, K = 512, 8, 1
REQUESTS, CLIENTS = 16, 4
F32_REQUESTS = 4
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase,
                      "elapsed_s": round(time.perf_counter() - T0, 3),
                      **fields}), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters runs, after one warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# 2. kernels at the slice's shapes
# ---------------------------------------------------------------------------

def kernel_error(got: torch.Tensor, ref: torch.Tensor, x: torch.Tensor):
    """(max-abs error, largest error / tolerance over the elements): the
    check passes when the second is <= 1. See the module docstring."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if x.dtype == torch.float32:
        tol = TOL_F32 * max(1.0, ref.abs().max().item())
    else:
        # |ref| = m 2^e with m in [0.5, 1): bf16 (8 significant bits) has
        # a unit in the last place of 2^(e - 8) there.
        ulp = torch.exp2((torch.frexp(ref)[1] - 8).float())
        ulp = torch.where(ref == 0, 0.0, ulp)
        tol = (TOL_BF16_ULPS * ulp
               + TOL_BF16_UPDATE * (ref - x.float()).abs().max())
    return err.max().item(), (err / tol).max().item()


def block_cost(b: int, nw: int, n: int, c: int, heads: int, hidden: int,
               dtype, has_mask: bool, has_padmask: bool):
    """(operations, bytes) one block call needs: every token of the padded
    grid goes through the block; each input byte is read once and each
    output byte written once."""
    tokens = b * nw * n
    flops = tokens * (2 * c * 3 * c + 2 * c * c + 2 * 2 * c * hidden)
    flops += b * nw * heads * 2 * (2 * n * n * (c // heads))
    item = torch.finfo(dtype).bits // 8
    weights = (3 * c * c + c * c + 2 * c * hidden) * item
    vectors = (3 * c + c + hidden + c + 4 * c) * 4 + heads * n * n * 4
    masks = (nw * n * n * 4 if has_mask else 0) + (nw * n * 4
                                                   if has_padmask else 0)
    return flops, 2 * tokens * c * item + weights + vectors + masks


def kernel_cases():
    """The blocks of the slice's Swin pass: batch 2 x max_batch images of
    512^2 -> stage 1 on 133x133 padded tokens (valid 128), stage 2 on 70x70
    (valid 64); shift 0 and window // 2."""
    b = 2 * MAX_BATCH
    for stage, (c, heads, hp, valid) in enumerate(((128, 4, 133, 128),
                                                   (256, 8, 70, 64))):
        for shift in ((0, 0), (3, 3)):
            yield dict(stage=stage + 1, b=b, c=c, heads=heads, hp=hp,
                       valid=valid, shift=shift)


def check_kernels(gen: torch.Generator):
    dev = torch.device(DEVICE)
    rows = []
    for case in kernel_cases():
        b, c, heads, hp, valid = (case[k] for k in
                                  ("b", "c", "heads", "hp", "valid"))
        sh, sw = effective_shift(hp, hp, (7, 7), case["shift"])
        acfg = AttentionConfig(dim=c, num_heads=heads, window_size=(7, 7),
                               shift_size=(sh, sw))
        params = init_style_swin_block(gen, acfg, use_norm=True,
                                       exclude_mlp=False, mlp_ratio=4.0)
        params = tree_map(lambda t: t.to(dev), params)
        mask = (torch.from_numpy(shift_attention_mask(hp, hp, 7, 7, sh, sw))
                .to(dev) if sh or sw else None)
        padmask = torch.from_numpy(
            valid_token_mask(valid, valid, hp, hp, 7, 7, sh, sw)).to(dev)
        x32 = torch.randn((b, hp, hp, c), generator=gen).to(dev)
        nw = (hp // 7) ** 2
        for entry, dtype in (("window_block_rows", torch.bfloat16),
                             ("window_block_rows", torch.float32),
                             ("window_block_windows", torch.float32)):
            w = wb.block_weights(params, (7, 7), dtype, use_norm=True)
            kw = dict(heads=heads, mask=mask, padmask=padmask)
            if entry == "window_block_rows":
                x = x32.to(dtype).contiguous()
                kw.update(window=(7, 7), shift=(sh, sw))
                kern, plain = wb.window_block_rows, wb.window_block_rows_plain
            else:
                xr = torch.roll(x32, (-sh, -sw), (1, 2)) if sh or sw else x32
                x = window_partition(xr, 7, 7).reshape(b, nw, 49, c)
                x = x.to(dtype).contiguous()
                kern = wb.window_block_windows
                plain = wb.window_block_windows_plain
            got = kern(x, w, **kw)
            ref = plain(x, w, **kw)
            torch.cuda.synchronize()
            err, err_over_tol = kernel_error(got, ref, x)
            if not err_over_tol <= 1.0:
                raise AssertionError(
                    f"{entry} stage {case['stage']} shift {(sh, sw)} "
                    f"{dtype}: max-abs {err}, error/tolerance "
                    f"{err_over_tol} > 1")
            del got, ref
            ms = cuda_ms(lambda: kern(x, w, **kw), 5)
            plain_ms = cuda_ms(lambda: plain(x, w, **kw), 3)
            flops, nbytes = block_cost(b, nw, 49, c, heads, 4 * c, dtype,
                                       mask is not None, True)
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            row = dict(entry=entry, stage=case["stage"], shift=[sh, sw],
                       ops_ms=t_ops, bytes_ms=t_bytes,
                       dtype=str(dtype).replace("torch.", ""),
                       shape=list(x.shape), max_abs_err=err,
                       err_over_tol=err_over_tol,
                       ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       gflop=flops / 1e9, mbytes=nbytes / 1e6)
            emit("kernels", **row)
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# 3. the slice: pair serving at 512^2
# ---------------------------------------------------------------------------

def slice_config(dtype: str, kernels: bool) -> ModelConfig:
    cfg = ModelConfig(compute_dtype=dtype)
    return cfg.replace(swin=cfg.swin.replace(use_pallas=kernels))


def serve_requests(svc: StylizeService, pairs, clients: int):
    """Send the pairs from `clients` threads, each in turn; returns outputs,
    per-request latencies (s) and the wall time (s)."""
    outs, lat = [None] * len(pairs), [None] * len(pairs)
    errors = []

    def client(idx):
        for i in idx:
            t = time.perf_counter()
            try:
                outs[i] = svc.stylize(*pairs[i], timeout=600.0)
            except Exception as e:  # re-raised below, in the main thread
                errors.append(e)
                return
            lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=client,
                                args=(range(j, len(pairs), clients),))
               for j in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or any(o is None for o in outs):
        raise RuntimeError("requests did not complete")
    return outs, lat, wall


def run_slice(params, pairs_bf16, pairs_f32):
    results = {}
    services = {}
    for dtype in ("bfloat16", "float32"):
        svc = StylizeService(params, slice_config(dtype, True), size=SIZE,
                             k=K, max_batch=MAX_BATCH, device=DEVICE)
        svc.warmup()
        services[dtype] = svc
    torch.cuda.synchronize()
    emit("slice_warmup", launches=dict(wb.LAUNCHES))

    # Each path's launch counts from zero, read right after its own run:
    # the bf16 service runs the row entry, the f32 service the window entry.
    for dtype, pairs in (("bfloat16", pairs_bf16), ("float32", pairs_f32)):
        for key in wb.LAUNCHES:
            wb.LAUNCHES[key] = 0
        outs, lat, wall = serve_requests(services[dtype], pairs, CLIENTS)
        results[dtype] = dict(outs=outs, lat=lat, wall=wall,
                              launches=dict(wb.LAUNCHES))
    for svc in services.values():
        svc.close()
    launches = {entry: results[dtype]["launches"][entry]
                for entry, dtype in MAIN_DTYPE.items()}
    for entry, dtype in MAIN_DTYPE.items():
        if launches[entry] <= 0:
            raise AssertionError(f"{entry} never launched on the {dtype} "
                                 f"path: {results[dtype]['launches']}")

    summary = {}
    for dtype, pairs in (("bfloat16", pairs_bf16), ("float32", pairs_f32)):
        r = results[dtype]
        before = dict(wb.LAUNCHES)
        plain = StylizeService(params, slice_config(dtype, False), size=SIZE,
                               k=K, max_batch=MAX_BATCH, device=DEVICE)
        ref_outs, _, _ = serve_requests(plain, pairs, CLIENTS)
        plain.close()
        if wb.LAUNCHES != before:
            raise AssertionError("the plain service launched a kernel")
        got = np.stack(r["outs"])
        ref = np.stack(ref_outs)
        if got.shape != (len(pairs), SIZE, SIZE, 3):
            raise AssertionError(f"output shape {got.shape}")
        if not (np.isfinite(got).all() and np.isfinite(ref).all()):
            raise AssertionError(f"{dtype}: non-finite output")
        mae = float(np.abs(got - ref).mean())
        ref_mean = float(np.abs(ref).mean())
        tol = TOL_SLICE_MAE[dtype] * max(1.0, ref_mean)
        if not mae <= tol:
            raise AssertionError(f"{dtype} slice MAE {mae} > {tol}")
        summary[dtype] = dict(
            requests=len(pairs), clients=CLIENTS,
            imgs_per_s=len(pairs) / r["wall"],
            p50_ms=float(np.median(r["lat"])) * 1e3,
            max_ms=float(np.max(r["lat"])) * 1e3,
            launches=r["launches"], mae_vs_plain=mae, mae_tol=tol,
            mean_abs_output=ref_mean, max_abs_vs_plain=float(
                np.abs(got - ref).max()))
        emit("slice", dtype=dtype, size=SIZE, k=K, max_batch=MAX_BATCH,
             **summary[dtype])
    return launches, summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; nothing run",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    fresh = not _build.BUILD_DIR.exists()
    built = _build.build_all()
    emit("build", from_scratch=fresh, seconds=built,
         build_dir=_build.BUILD_DIR.name)

    gen = torch.Generator().manual_seed(0)
    rows = check_kernels(gen)

    params = init_master_model(slice_config("bfloat16", True), gen,
                               device=DEVICE)
    rng = np.random.default_rng(0)

    def pairs(n):
        return [(rng.random((SIZE, SIZE, 3), dtype=np.float32),
                 rng.random((SIZE, SIZE, 3), dtype=np.float32))
                for _ in range(n)]

    launches, _ = run_slice(params, pairs(REQUESTS), pairs(F32_REQUESTS))

    kernels = []
    # "replaces": the TPU kernel's pl.pallas_call, file:line in the JAX
    # package beside the port.
    for entry, replaces in (
            ("window_block_rows", "ops/pallas_attention.py:961"),
            ("window_block_windows", "ops/pallas_attention.py:1036")):
        dtype = MAIN_DTYPE[entry]
        mine = [r for r in rows if r["entry"] == entry and r["dtype"] == dtype]
        # Per request batch: the four Swin blocks of one 2 x 8-image pass.
        kernels.append(dict(
            name=entry, route="cuda",
            source="mastermetastyletransfer_tpu_torch/csrc/window_block.cu",
            replaces=replaces, launches=launches[entry],
            launches_from=f"{dtype} slice run",
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sum(r["ms"] for r in mine),
            plain_ms=sum(r["plain_ms"] for r in mine),
            bound_ms=sum(r["bound_ms"] for r in mine),
            bound_by=("operations" if sum(r["ops_ms"] for r in mine)
                      >= sum(r["bytes_ms"] for r in mine) else "bytes"),
            library_ms=None,
            dtype=dtype, per="4 blocks of one 16-image Swin pass"))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
