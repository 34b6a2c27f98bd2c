"""Does the data loader slow the port's trainer? The plain trainer run of
chip_smoke.py's `trainer` phase (swin_B, 256^2 crops from 512^2 staging,
batch 8, bf16, kernels on, on that phase's folders: 640x480 content and
1024x768 style JPEGs written from a seed, ``trainer_folders``), with its
loaders as they are and in variants:

    real          the prefetching loaders (4 content workers, 2 style)
    predecoded    the batches decoded before the run and replayed: no
                  decode thread runs beside the steps
    workers1      one content worker, one style worker
    switch0.5ms   the real loaders, the interpreter's switch interval
                  at 0.5 ms (5 ms by default)

run in the order given by ``--plan`` (default: real, predecoded,
workers1, switch0.5ms, real, predecoded). Per run one JSON line: each
iteration's k, the step's ms from its call to its return (host clock;
the step reads its losses back, which waits for the card), the ms
between one step's return and the next one's call, and their means over
iterations 2 to ``--iterations``. Then the card's name and power limit as
nvidia-smi gives them.

    python3 scripts/torch_trainer_loader.py [--iterations N] [--plan a,b]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class Replay:
    """An endless loader over batches decoded beforehand."""

    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def __next__(self):
        batch = self.batches[self.i % len(self.batches)]
        self.i += 1
        return batch

    def close(self):
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=8)
    ap.add_argument("--plan", default="real,predecoded,workers1,"
                                      "switch0.5ms,real,predecoded")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as cs
    from mastermetastyletransfer_tpu_torch.ops import _build
    from mastermetastyletransfer_tpu_torch.train import trainer

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    real = trainer.make_train_iterators

    def predecoded(cfg, shard=None):
        loaders = real(cfg, shard)
        try:
            return tuple(Replay([next(ld).copy()
                                 for _ in range(args.iterations)])
                         for ld in loaders)
        finally:
            for ld in loaders:
                ld.close()

    variants = {"real": (real, None), "predecoded": (predecoded, None),
                "workers1": (lambda cfg, shard=None: real(
                    cfg.replace(num_workers=1), shard), None),
                "switch0.5ms": (real, 0.0005)}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = cs.trainer_folders(tmp)
        for i, name in enumerate(args.plan.split(",")):
            make, switch = variants[name]
            rec = cs.StepRecorder()
            trainer.make_train_iterators = make
            interval = sys.getswitchinterval()
            if switch:
                sys.setswitchinterval(switch)
            try:
                with rec.patched(), contextlib.redirect_stdout(io.StringIO()):
                    trainer.main([
                        "--content_dir", dirs[0], "--style_dir", dirs[1],
                        "--exp_dir", os.path.join(tmp, f"run{i}"),
                        "--batch_size", str(cs.TRAIN_BATCH), "--crop_to",
                        str(cs.TRAIN_SIZE), "--resize_to",
                        str(cs.TRAINER_RESIZE), "--compute_dtype",
                        "bfloat16", "--use_pallas", "--save_every", "100000",
                        "--save_every_for_model", "100000", "--log_every",
                        "1", "--seed", str(cs.TRAINER_SEED),
                        "--max_iterations", str(args.iterations)])
            finally:
                sys.setswitchinterval(interval)
                trainer.make_train_iterators = real
            calls, done = rec.calls, rec.metrics
            step = [(m["t"] - c["t"]) * 1e3 for c, m in zip(calls, done)]
            gap = [(c["t"] - m["t"]) * 1e3 for m, c in zip(done, calls[1:])]
            print(json.dumps(dict(
                run=name, ks=[m["k"] for m in done], step_ms=step,
                between_ms=gap, step_ms_mean_it2=float(np.mean(step[1:])),
                between_ms_mean_it2=float(np.mean(gap[1:])))), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
