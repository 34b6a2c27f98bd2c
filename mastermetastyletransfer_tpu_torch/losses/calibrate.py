"""Loss calibration: the loss variants over image triplets (JAX
counterpart: losses/calibrate.py).

The reference's closest thing to a golden test (codes/loss.py:341-805)
computes loss magnitudes on the paper's figure-4/figure-9 images across
VGG +-batchnorm x L1/L2 distance x +-ImageNet normalization, so that
reproduced numbers can be compared with the paper's Table 1. This CLI
takes (content, style, stylized) images -- single files or aligned
directories -- and prints the whole sweep as JSON:

    python -m mastermetastyletransfer_tpu_torch.losses.calibrate \
        --content c.jpg --style s.jpg --output o.jpg \
        --vgg_weights vgg19.npz [--vgg_bn_weights vgg19_bn.npz]

The VGG19 runs in float32 on ``--device`` (default cuda) with TF32 off,
as the port's float32 stages run. ``--render`` needs matplotlib (the
machine with the card has none): without it the command exits before any
work.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
from typing import List

import numpy as np
import torch

from mastermetastyletransfer_tpu_torch.config import LossConfig
from mastermetastyletransfer_tpu_torch.data.pipeline import (
    _decode_resize, list_images,
)
from mastermetastyletransfer_tpu_torch.losses.loss import perceptual_loss
from mastermetastyletransfer_tpu_torch.models.master import (
    _TF32_OFF, imagenet_normalize,
)
from mastermetastyletransfer_tpu_torch.train.trainer import load_vgg_params
from mastermetastyletransfer_tpu_torch.utils.device import require_device


def _load_images(path: str, image_size: int) -> List[np.ndarray]:
    files = list_images(path) if os.path.isdir(path) else [path]
    return [(_decode_resize(f, image_size).astype(np.float32) / 255.0)
            for f in files]


def run_sweep(content, style, output, *, vgg_params_by_kind: dict,
              lambda_value: float = 1.0,
              compute_similarity: bool = False) -> List[dict]:
    """One row per (VGG kind, distance, ImageNet normalization), in the JAX
    package's order, for one (H, W, 3) float triplet; the images go to the
    device of the VGG weights."""
    rows = []
    for (kind, vgg), dist, norm in itertools.product(
            vgg_params_by_kind.items(),
            ["euclidian", "euclidian_squared"],
            [False, True]):
        cfg = LossConfig(use_vgg19_with_batchnorm=(kind == "bn"),
                         default_lambda_value=lambda_value,
                         distance_content=dist, distance_style=dist)
        device = vgg["conv0"]["kernel"].device
        c, s, o = (torch.from_numpy(np.asarray(x, np.float32))[None]
                   .to(device) for x in (content, style, output))
        if norm:
            c, s, o = (imagenet_normalize(c), imagenet_normalize(s),
                       imagenet_normalize(o))
        with torch.inference_mode(), _TF32_OFF:
            losses = perceptual_loss(vgg, c, s, o, cfg,
                                     compute_similarity=compute_similarity)
        row = {"vgg": kind, "distance": dist, "imagenet_norm": norm,
               **{k: float(v) for k, v in losses.items()}}
        rows.append(row)
    return rows


def render_grid(triplets, rows_by_triplet, path: str):
    """Annotated image grid, one row per (content, style, stylized) triplet
    with the loss values beside the stylized image -- the reference demo's
    3x3 matplotlib figure (codes/loss.py:528-608: content, style and output
    per row, the losses in red at the output's right edge). The values are
    the ImageNet-normalized euclidian_squared plain-VGG row's, the
    reference demo's default (codes/loss.py:404-417)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(triplets)
    fig, ax = plt.subplots(n, 3, figsize=(14, 4 * n), squeeze=False)
    for i, (c, s, o) in enumerate(triplets):
        for j, (img, title) in enumerate(
                ((c, "Content Image"), (s, "Style Image"),
                 (o, f"Output Image (triplet {i})"))):
            ax[i][j].imshow(np.clip(img, 0.0, 1.0))
            ax[i][j].set_title(title)
            ax[i][j].axis("off")
        rows = rows_by_triplet[i]
        best = next((r for r in rows
                     if r["vgg"] == "plain" and r["imagenet_norm"]
                     and r["distance"] == "euclidian_squared"), rows[0])
        h = c.shape[0]
        lines = [(f"plain VGG, {best['distance']}, "
                  f"norm={best['imagenet_norm']}", "green"),
                 (f"Total Loss:    {best['total']:.4g}", "red"),
                 (f"Content Loss:  {best['content']:.4g}", "red"),
                 (f"Style Loss:    {best['style']:.4g}", "red")]
        if "similarity" in best:
            lines.append((f"Similarity Loss: {best['similarity']:.4g}",
                          "red"))
        for li, (text, color) in enumerate(lines):
            ax[i][2].text(c.shape[1] * 1.05, h * (0.15 + 0.12 * li), text,
                          fontsize=12, color=color, clip_on=False)
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--content", required=True)
    ap.add_argument("--style", required=True)
    ap.add_argument("--output", required=True,
                    help="stylized image (or dir aligned with --content)")
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--lambda_value", type=float, default=1.0)
    ap.add_argument("--vgg_weights", default=None, help=".npz or .pt (plain)")
    ap.add_argument("--vgg_bn_weights", default=None,
                    help=".npz or .pt (batchnorm variant; optional)")
    ap.add_argument("--compute_similarity", action="store_true")
    ap.add_argument("--render", default=None, metavar="GRID_PNG",
                    help="also write the annotated image grid (reference "
                         "codes/loss.py:528-608) to this path; needs "
                         "matplotlib")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sweep (cpu for tests)")
    args = ap.parse_args(argv)
    if args.render:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("--render needs matplotlib, which does not "
                             "import here; run without --render") from None
    device = require_device(args.device)

    vggs = {"plain": load_vgg_params(args.vgg_weights, device)}
    if args.vgg_bn_weights:
        # a .pt of vgg19_bn folds its batch norm (the JAX package reads
        # it as a plain VGG19 and fails on its keys)
        vggs["bn"] = load_vgg_params(args.vgg_bn_weights, device,
                                     use_batchnorm=True)

    contents = _load_images(args.content, args.image_size)
    styles = _load_images(args.style, args.image_size)
    outputs = _load_images(args.output, args.image_size)

    all_rows = []
    rows_by_triplet = []
    for i, (c, s, o) in enumerate(zip(contents, styles, outputs)):
        rows = run_sweep(c, s, o, vgg_params_by_kind=vggs,
                         lambda_value=args.lambda_value,
                         compute_similarity=args.compute_similarity)
        for r in rows:
            r["triplet"] = i
        rows_by_triplet.append(rows)
        all_rows.extend(rows)
    print(json.dumps(all_rows, indent=2))
    if args.render:
        render_grid(list(zip(contents, styles, outputs)), rows_by_triplet,
                    args.render)
        print(f"wrote {args.render}", file=sys.stderr)
    return all_rows


if __name__ == "__main__":
    main()
