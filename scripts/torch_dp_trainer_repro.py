"""chip_smoke.py's data-parallel trainer verdict (``run_dp_trainer``),
repeated: the one-device trainer at bf16 and at f32 and the trainer over
2 gloo ranks that share the card, each run ``--reps`` times on the
trainer phase's folders and command line, first with deterministic
algorithms (``chip_smoke.deterministic_algorithms``), then under
PyTorch's defaults. Prints one JSON line a run (each step's total,
content and style losses) and one a mode: whether each trainer
reproduced itself bit for bit, and per loss the verdict's ratio (summed
over the steps, |run - f32| over |first one-device bf16 run - f32|) for
every 2-rank run and for the other one-device bf16 runs.

    python3 scripts/torch_dp_trainer_repro.py --reps 3   # on the card
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

LOSSES = ("total", "content", "style")
MODES = ("deterministic", "default")


def default_rank(rank: int, n: int, dev, argv) -> dict:
    """``trainer.train`` in one rank under PyTorch's defaults."""
    args = cs.trainer.build_argparser().parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        return cs.trainer.train(cs.trainer.config_from_args(args),
                                exp_dir=args.exp_dir,
                                log_every=args.log_every, device=dev)


def run(mode: str, label: str, argv: list) -> list:
    """One trainer run; its metrics lines."""
    if label == "dp":
        rank = cs.dp_trainer_rank if mode == "deterministic" else default_rank
        cs.spawn_ranks(rank, 2, backend="gloo", device="cuda",
                       args=(argv + ["--num_devices", "2"],))
    else:
        ctx = (cs.deterministic_algorithms() if mode == "deterministic"
               else contextlib.nullcontext())
        with ctx, contextlib.redirect_stdout(io.StringIO()):
            cs.trainer.main(argv)
    exp = argv[argv.index("--exp_dir") + 1]
    return cs.read_jsonl(os.path.join(exp, "metrics.jsonl"))


def distance(rows: list, ref: list, name: str) -> float:
    return sum(abs(r[name] - f[name]) for r, f in zip(rows, ref))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    cs._build.build_all()
    labels = {"one_bf16": [], "one_f32": ["--compute_dtype", "float32"],
              "dp": []}
    with tempfile.TemporaryDirectory() as tmp:
        cdir, sdir = cs.trainer_folders(tmp)
        for mode in MODES:
            runs = {label: [] for label in labels}
            for rep in range(args.reps):
                for label, extra in labels.items():
                    exp = os.path.join(tmp, f"{mode}_{label}_{rep}")
                    argv = cs.trainer_argv(
                        cdir, sdir, exp, "--max_iterations",
                        str(cs.DP_TRAINER_ITERS), *extra)
                    t0 = time.perf_counter()
                    rows = [{k: r[k] for k in ("step", "k", *LOSSES)}
                            for r in run(mode, label, argv)]
                    runs[label].append(rows)
                    print(json.dumps(dict(
                        mode=mode, run=label, rep=rep,
                        wall_s=time.perf_counter() - t0, steps=rows)),
                          flush=True)
            f32, one = runs["one_f32"][0], runs["one_bf16"][0]
            print(json.dumps(dict(
                mode=mode, reps=args.reps,
                reproduced={label: all(r == rs[0] for r in rs[1:])
                            for label, rs in runs.items()},
                dp_ratio={name: [distance(r, f32, name)
                                 / distance(one, f32, name)
                                 for r in runs["dp"]] for name in LOSSES},
                one_bf16_ratio={name: [distance(r, f32, name)
                                       / distance(one, f32, name)
                                       for r in runs["one_bf16"][1:]]
                                for name in LOSSES},
                tol=cs.TOL_BF16_NOISE)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
