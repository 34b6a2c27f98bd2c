"""Evaluation CLI: the test_model.py grid sweep (JAX counterpart:
eval/cli.py).

    python -m mastermetastyletransfer_tpu_torch.eval.cli \
        --content_dir test/content_input --style_dir test/style_input \
        --checkpoint experiments/run/checkpoints --k 1 --lambda_style 4 \
        --use_pallas --save_images_to outputs/

Loads a checkpoint (the flat .npz export, or a directory of train-state
checkpoints of either package, utils/checkpoint.py: its latest step's
parameters, whatever the training mode that wrote it, as the JAX
package's restore takes them), sweeps the full content x style grid at
the given transformer
depth, prints the loss statistics (mean and std of
total/content/style[/similarity], the numbers goals.txt compares with the
paper), and optionally writes the stylized images as JPEG.
``--use_pallas`` keeps its JAX name: it turns on the port's CUDA kernels in
every stage. ``--device`` (default cuda) places the run.
"""

from __future__ import annotations

import argparse
import json

import torch

from mastermetastyletransfer_tpu_torch.config import (
    DataConfig, ExperimentConfig, LossConfig, ModelConfig, SwinConfig,
    TrainConfig,
)
from mastermetastyletransfer_tpu_torch.eval.harness import (
    evaluate_grid, load_eval_images,
)
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.train.trainer import load_vgg_params
from mastermetastyletransfer_tpu_torch.utils import checkpoint as ckpt_lib
from mastermetastyletransfer_tpu_torch.utils.device import require_device

WEIGHTS_SEED = 0


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--content_dir", required=True)
    ap.add_argument("--style_dir", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz params export or a directory of train-state "
                         "checkpoints; random weights if omitted (smoke only)")
    ap.add_argument("--vgg_weights", default=None)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--k", type=int, default=1,
                    help="transformer layer count (ZS-L1 vs ZS-L3)")
    ap.add_argument("--lambda_style", type=float, default=10.0)
    ap.add_argument("--style_batch", type=int, default=8)
    ap.add_argument("--compute_similarity", action="store_true")
    ap.add_argument("--save_images_to", default=None)
    ap.add_argument("--swin_variant", default="swin_B")
    ap.add_argument("--compute_dtype", default="float32")
    ap.add_argument("--use_pallas", action="store_true",
                    help="the hand-written CUDA kernels in every stage (the "
                         "JAX package's flag name)")
    ap.add_argument("--matmul_mode", choices=["native", "split3"],
                    default="native",
                    help="the JAX package's in-kernel matmul mode; 'split3' "
                         "needs --use_pallas, as there, and runs the port's "
                         "native route (config.check_matmul_mode)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cpu for tests)")
    return ap


def config_from_args(args) -> ExperimentConfig:
    model = ModelConfig(swin=SwinConfig.for_variant(args.swin_variant),
                        compute_dtype=args.compute_dtype)
    if args.use_pallas:
        model = model.with_kernels()
    if args.matmul_mode != "native":
        model = model.replace(
            swin=model.swin.replace(matmul_mode=args.matmul_mode),
            transformer=model.transformer.replace(
                matmul_mode=args.matmul_mode),
            decoder=model.decoder.replace(matmul_mode=args.matmul_mode))
    return ExperimentConfig(
        model=model,
        loss=LossConfig(default_lambda_value=args.lambda_style),
        data=DataConfig(),
        train=TrainConfig(lambda_style=args.lambda_style))


def load_params(checkpoint, cfg: ExperimentConfig,
                device: torch.device) -> dict:
    """The model's weights: random from WEIGHTS_SEED, then, given a path,
    a .npz export or the parameters of the latest train-state checkpoint
    under a directory."""
    params = init_master_model(
        cfg.model, torch.Generator().manual_seed(WEIGHTS_SEED), device=device)
    if not checkpoint:
        return params
    if checkpoint.endswith(".npz"):
        return ckpt_lib.load_params_npz(checkpoint, params)
    return ckpt_lib.restore_params(checkpoint, params)


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    if args.matmul_mode != "native" and not args.use_pallas:
        raise SystemExit("--matmul_mode split3 requires --use_pallas "
                         "(split3 runs inside the kernels, as in the JAX "
                         "package)")
    device = require_device(args.device)
    cfg = config_from_args(args)
    params = load_params(args.checkpoint, cfg, device)
    vgg = load_vgg_params(args.vgg_weights, device)

    content, cnames = load_eval_images(args.content_dir, args.image_size)
    styles, snames = load_eval_images(args.style_dir, args.image_size)
    print(f"grid: {len(cnames)} contents x {len(snames)} styles "
          f"= {len(cnames) * len(snames)} pairs, k={args.k}")

    report = evaluate_grid(
        params, vgg, cfg, content_images=content, style_images=styles,
        content_names=cnames, style_names=snames, k=args.k,
        style_batch=args.style_batch,
        compute_similarity=args.compute_similarity,
        save_images_to=args.save_images_to, device=device)
    summary = dict(report.summary())
    # Without trained weights these numbers exercise the harness; they do
    # not reproduce the paper's goals.txt losses, and the artifact says so.
    summary["weights"] = (
        args.checkpoint if args.checkpoint else
        f"RANDOM-INIT (torch.Generator seed {WEIGHTS_SEED}) — harness "
        "golden only; NOT comparable to the reference goals.txt values")
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
