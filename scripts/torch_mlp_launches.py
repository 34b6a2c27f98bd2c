"""Where one K10 call of the PyTorch/CUDA port spends its device time:
every launch of one forward and one backward call
(``ln_mlp_residual_fwd_kernel``, ``ln_mlp_residual_bwd_kernel``), by
kernel name, at the training step's four row shapes, from torch.profiler
on one NVIDIA GPU.

    python3 scripts/torch_mlp_launches.py [--repo DIR] [--iters N]
                                          [--dtype bfloat16|float32]

``--repo`` imports the port from another checkout (a parent commit unpacked
beside this one), so that two trees are measured by the same script in one
call. A backward call launches its main kernel, the two weight-gradient
products and the column sums' reductions, beside the wrapper's own copies
(weights cast and transposed); each name's device time is its total over
``--iters`` calls divided by the calls. The whole call is also timed with
CUDA events (a sleep kernel ahead of the window, so that the host queues the
calls first). One JSON line per (shape, direction), then the card's name
and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (label, rows, C, LN): the Swin's two stages at 16 images of 256^2, the
# style transformer on 8 contents, with its LN (one call a step) and without
# (four); hidden is 4 C.
SHAPES = (("swin_stage1", 16 * 64 * 64, 128, True),
          ("swin_stage2", 16 * 32 * 32, 256, True),
          ("st_ln", 8 * 32 * 32, 256, True),
          ("st_no_ln", 8 * 32 * 32, 256, False))


def device_ms(evt) -> float:
    """An averaged profiler event's device time in ms (the attribute's name
    moved between torch releases)."""
    us = getattr(evt, "device_time_total", None)
    if us is None:
        us = getattr(evt, "cuda_time_total", 0.0)
    return us / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mastermetastyletransfer_tpu_torch.ops import ln_mlp as lm

    if not torch.cuda.is_available():
        print("torch_mlp_launches: no CUDA device", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    plan = getattr(lm, "mlp_plan", None)  # None before the tensor-core bodies
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    for label, rows, c, use_norm in SHAPES:
        hidden = 4 * c
        x, gy = randn((rows, c)).to(dtype), randn((rows, c)).to(dtype)
        w1, b1 = randn((c, hidden), c ** -0.5), randn(hidden, 0.02)
        w2, b2 = randn((hidden, c), hidden ** -0.5), randn(c, 0.02)
        norm = ([1 + randn(c, 0.1), randn(c, 0.1)] if use_norm
                else [None, None])
        calls = {
            "forward": lambda: lm.ln_mlp_residual_fwd_kernel(
                x, w1, b1, w2, b2, *norm),
            "backward": lambda: lm.ln_mlp_residual_bwd_kernel(
                gy, x, w1, b1, w2, *norm)}
        for direction, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            start.record()
            for _ in range(args.iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            total = start.elapsed_time(end) / args.iters
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    fn()
                torch.cuda.synchronize()
            launches = sorted(
                ({"name": e.key[:120], "per_call": e.count / args.iters,
                  "ms": device_ms(e) / args.iters}
                 for e in prof.key_averages() if device_ms(e) > 0),
                key=lambda r: -r["ms"])
            print(json.dumps({
                "shape": label, "rows": rows, "C": c, "hidden": hidden,
                "ln": use_norm, "dtype": args.dtype, "direction": direction,
                "repo": args.repo, "call_ms": total,
                "plan": None if plan is None else plan(
                    rows, c, hidden, direction == "backward", dtype
                )._asdict(),
                "profiled_ms": sum(r["ms"] for r in launches),
                "launches": launches}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
