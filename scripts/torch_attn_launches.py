"""Where one K8 or K9 call of the PyTorch/CUDA port spends its device
time: every launch of one backward call (``window_attention_bwd_kernel``,
``window_attention_dual_bwd_kernel``) or, with ``--direction fwd``, one
forward call (``window_attention_fwd_kernel``,
``window_attention_dual_fwd_kernel``), by kernel name, at the training
step's attention shapes, from torch.profiler on one NVIDIA GPU.

    python3 scripts/torch_attn_launches.py [--repo DIR] [--iters N]
                                           [--dtype bfloat16|float32]
                                           [--direction bwd|fwd]
                                           [--fwd-form BLOCKS,KP,STAGES]

``--fwd-form`` lets the forward's plan take that form only (of
ops/window_attention.py's ATTN_FWD_FORMS, which it replaces for the run),
so that the forms are timed by one script; a shape where it does not fit
runs the scalar body and is left out.

``--repo`` imports the port from another checkout (a parent commit unpacked
beside this one), so that two trees are measured by the same script in one
call. A backward call launches its main body, the weight gradients'
products and the partials' reductions, beside the wrapper's own copies
(weights cast and transposed); each name's device time is its total over
``--iters`` calls divided by the calls. The whole call is also timed with
CUDA events (a sleep kernel ahead of the window, so that the host queues
the calls first). One JSON line per (shape, entry), then the card's name
and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (label, images, windows, C, heads, entries): the Swin's two stages at 16
# images of 256^2 (K8 only; the Swin is frozen, so its backward runs on no
# training path) and the style transformer on 8 contents (K8 and K9).
SHAPES = (("swin_stage1", 16, 100, 128, 4, ("k8",)),
          ("swin_stage2", 16, 25, 256, 8, ("k8",)),
          ("style_transformer", 8, 25, 256, 8, ("k8", "k9")))


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
    ap.add_argument("--direction", default="bwd", choices=("bwd", "fwd"))
    ap.add_argument("--fwd-form", default=None)
    args = ap.parse_args(argv)
    form = (None if args.fwd_form is None
            else tuple(int(v) for v in args.fwd_form.split(",")))
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa
    from mastermetastyletransfer_tpu_torch.ops.windows import (
        shift_attention_mask,
    )

    if not torch.cuda.is_available():
        print("torch_attn_launches: no CUDA device", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    fwd = args.direction == "fwd"
    # None before the tree had the tensor-core body
    plan = getattr(wa, "attn_fwd_plan" if fwd else "attn_bwd_plan", None)
    if form is not None:
        if not fwd or form not in wa.ATTN_FWD_FORMS:
            ap.error(f"--fwd-form: one of {wa.ATTN_FWD_FORMS}, with "
                     "--direction fwd")
        wa.ATTN_FWD_FORMS = (form,)
        wa.attn_fwd_plan.cache_clear()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    for label, b, nw, c, heads, entries in SHAPES:
        grid = int(round(nw ** 0.5)) * 7
        sh = 4 if label == "style_transformer" else 3
        mask = torch.from_numpy(shift_attention_mask(grid, grid, 7, 7, sh,
                                                     sh)).to(dev)
        projs = [wa.Proj(randn((c, c), c ** -0.5), randn(c, 0.02))
                 for _ in range(4)]
        xs = [randn((b, nw, 49, c)).to(dtype) for _ in range(4)]
        gs = [randn((b, nw, 49, c)).to(dtype) for _ in range(2)]
        bias = randn((heads, 49, 49), 0.02)
        fplan = {nv: None if plan is None else plan(49, c, heads, nv, dtype)
                 for nv in (1, 2)}
        calls = {
            "k8": lambda: wa.window_attention_bwd_kernel(
                gs[0], *xs[:3], *projs, bias, mask, heads),
            "k9": lambda: wa.window_attention_dual_bwd_kernel(
                *gs, *xs, projs[0], projs[1], projs[3], bias, mask, heads)}
        if fwd:
            calls = {
                "k8": lambda: wa.window_attention_fwd_kernel(
                    *xs[:3], *projs, bias, mask, heads),
                "k9": lambda: wa.window_attention_dual_fwd_kernel(
                    *xs, projs[0], projs[1], projs[3], bias, mask, heads)}
            entries = ("k8", "k9")
        for entry in entries:
            nv = 1 if entry == "k8" else 2
            if form and fplan[nv].body != "tc":
                continue
            fn = calls[entry]
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
                "shape": label, "entry": entry, "images": b, "windows": nw,
                "C": c, "heads": heads, "dtype": args.dtype,
                "direction": args.direction, "repo": args.repo,
                "call_ms": total,
                "plan": None if plan is None else fplan[nv]._asdict(),
                "profiled_ms": sum(r["ms"] for r in launches),
                "launches": launches}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
