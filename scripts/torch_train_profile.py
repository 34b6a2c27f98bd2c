"""How busy the card is during one bf16 training step of the PyTorch/CUDA
port: the step's wall time against the device's busy time (the union of
its kernels' intervals in torch.profiler), the idle share, the kernel
launches and the device time by kernel name, at the JAX train bench's
configuration (swin_B, 256^2 crops, batch 8 content + 8 style, k = 1,
every kernel on, or off with ``--kernels off``). ``--mode`` takes the plain
step (the default), the meta step of the JAX meta bench (4 inner updates of
batch 8, outer_lr 1e-4, each inner step at k = 1), the step with remat, or
with 2 micro-batches.

    python3 scripts/torch_train_profile.py [--repo DIR] [--steps N]
                                           [--kernels on|off]
                                           [--mode plain|meta|remat|accum]

``--repo`` imports the port from another checkout (a parent commit unpacked
beside this one), so that two trees are measured by the same script in one
call. After two warm-up steps, ``--steps`` steps are timed on the host
clock (each ends in a synchronize), then as many again under the profiler,
whose device intervals give the busy time (the profiler's host overhead
does not move a kernel's device time). The idle share is 1 - busy / wall.
One JSON line, then the card's name and power limit as nvidia-smi gives
them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def busy_ms(intervals) -> float:
    """The length of the union of (start, end) intervals, in ms (us in)."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--kernels", default="on", choices=("on", "off"))
    ap.add_argument("--mode", default="plain",
                    choices=("plain", "meta", "remat", "accum"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mastermetastyletransfer_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig,
    )
    from mastermetastyletransfer_tpu_torch.losses.vgg import (
        init_vgg19_features,
    )
    from mastermetastyletransfer_tpu_torch.models import init_master_model
    from mastermetastyletransfer_tpu_torch.train.state import (
        create_train_state,
    )
    from mastermetastyletransfer_tpu_torch.train.step import (
        make_meta_train_step, make_train_step,
    )

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = "cuda"
    cfg = ExperimentConfig(
        model=ModelConfig(compute_dtype="bfloat16").with_kernels(
            args.kernels == "on"),
        data=DataConfig(crop_to=256))
    inner = 4 if args.mode == "meta" else 1
    cfg = cfg.replace(train=cfg.train.replace(**{
        "plain": {}, "remat": {"remat": True},
        "accum": {"grad_accum_steps": 2},
        "meta": {"mode": "meta", "num_inner_updates": inner,
                 "outer_lr": 1e-4}}[args.mode]))
    gen = torch.Generator().manual_seed(1)
    state = create_train_state(init_master_model(cfg.model, gen, device=dev),
                               cfg.train)
    vgg = init_vgg19_features(gen, device=dev)
    rng = np.random.default_rng(1)
    content, style = (torch.from_numpy(rng.random(
        (8, 256, 256, 3), dtype=np.float32)).to(dev) for _ in range(2))
    if args.mode == "meta":
        meta = make_meta_train_step(cfg, vgg, device=dev)
        contents = torch.stack([content] * inner)

        def step(state, content, style, generator, k):
            return meta(state, contents, style, generator, ks=[k] * inner)
    else:
        step = make_train_step(cfg, vgg, device=dev)

    def run(i):
        nonlocal state
        state, _ = step(state, content, style,
                        torch.Generator().manual_seed(100 + i), k=1)
        torch.cuda.synchronize()

    for i in range(2):
        run(i)
    wall = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        run(i)
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(args.steps):
            run(i)
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = busy_ms([(e.time_range.start, e.time_range.end)
                    for e in kernels]) / args.steps
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / args.steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    wall_ms = statistics.median(wall)
    print(json.dumps({
        "repo": args.repo, "kernels": args.kernels, "mode": args.mode,
        "steps": args.steps, "k": 1, "wall_ms": wall,
        "wall_ms_median": wall_ms,
        "imgs_per_s": inner * 8 / wall_ms * 1e3,
        "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
        "launches_per_step": len(kernels) / args.steps,
        "top": [{"name": n[:100], "ms": ms} for n, ms in top]}),
        flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
