"""Few-shot adaptation to one style image (JAX counterpart: adapt.py;
reference: the fast-adaptation stage of train_only_inner_loop.py, which
freezes everything but the style transformer's encoder, :306-318).

    from mastermetastyletransfer_tpu_torch.adapt import adapt_to_style
    adapted = adapt_to_style(params, vgg, cfg, style_img, content_imgs,
                             steps=20, lr=1e-4, batch=4, seed=0)

or, from image files:

    python -m mastermetastyletransfer_tpu_torch.adapt \
        --style novel_style.jpg --content_dir photos/ \
        --checkpoint pretrained.npz --steps 20 --out_dir adapted/ --use_pallas

which writes the adapted weights (adapted.npz) and each content stylized
with them ({stem}_stylized.jpg, JPEG at quality 95, as the JAX package).
``--use_pallas`` keeps its JAX name: it turns on the port's CUDA kernels in
every stage. ``--device`` (default cuda) places the run.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Union

import numpy as np
import torch

from mastermetastyletransfer_tpu_torch.config import ExperimentConfig
from mastermetastyletransfer_tpu_torch.data import repeat_style_to_batch
from mastermetastyletransfer_tpu_torch.data.pipeline import (
    _decode_resize, list_images,
)
from mastermetastyletransfer_tpu_torch.eval.harness import _save_image, _stem
from mastermetastyletransfer_tpu_torch.inference import stylize
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.train.state import create_train_state
from mastermetastyletransfer_tpu_torch.train.step import make_train_step
from mastermetastyletransfer_tpu_torch.train.trainer import load_vgg_params
from mastermetastyletransfer_tpu_torch.utils import checkpoint as ckpt_lib
from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map
from mastermetastyletransfer_tpu_torch.utils.device import require_device

WEIGHTS_SEED = 0


def adapt_to_style(params: dict, vgg: dict, cfg: ExperimentConfig,
                   style_img: np.ndarray, content_imgs: np.ndarray, *,
                   steps: int = 20, lr: float = 1e-4, batch: int = 4,
                   seed: int = 0, log: Callable[[str], None] = print,
                   device: Union[str, torch.device] = "cuda",
                   on_step: Optional[Callable[[int, dict], None]] = None
                   ) -> dict:
    """``steps`` fast-adaptation updates against one style image: Adam at a
    constant ``lr`` on the style transformer's encoder alone. style_img is
    (H, W, 3) float in [0, 1], content_imgs (N, H, W, 3); each step takes
    ``batch`` contents at indices drawn from ``np.random.default_rng(seed)``
    (the JAX package's order) and draws k from a generator seeded by
    ``seed``. ``params`` are left as they are: the update runs on a copy on
    ``device``, which is returned. ``on_step(i, metrics)``, if given, sees
    each step's metrics (its k among them) as the step returns."""
    tcfg = cfg.train.replace(mode="fast_adaptation", inner_lr=lr,
                             use_lr_schedule=False)
    cfg = cfg.replace(train=tcfg)
    params = tree_map(lambda t: t.detach().to(device, copy=True), params)
    state = create_train_state(params, tcfg)
    step = make_train_step(cfg, vgg, device=device)

    generator = torch.Generator().manual_seed(seed)
    style = repeat_style_to_batch(np.asarray(style_img, np.float32), batch)
    n = content_imgs.shape[0]
    order = np.random.default_rng(seed)
    for it in range(steps):
        idx = order.integers(0, n, size=batch)
        state, metrics = step(state, content_imgs[idx], style, generator)
        if on_step is not None:
            on_step(it, metrics)
        if (it + 1) % max(steps // 5, 1) == 0 or it == 0:
            log(f"[adapt {it + 1}/{steps}] total={metrics['total']:.4f} "
                f"style={metrics['style']:.4f}")
    return tree_map(lambda t: t.detach(), state.params)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--style", required=True, help="the novel style image")
    ap.add_argument("--content_dir", required=True,
                    help="content images (adaptation + stylization targets)")
    ap.add_argument("--checkpoint", default=None,
                    help=".npz pretrained params (random init if omitted)")
    ap.add_argument("--vgg_weights", default=None)
    ap.add_argument("--out_dir", default="adapted")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use_pallas", action="store_true",
                    help="the hand-written CUDA kernels in every stage (the "
                         "JAX package's flag name)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cpu for tests)")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    cfg = ExperimentConfig()
    if args.use_pallas:
        cfg = cfg.replace(model=cfg.model.with_kernels())
    params = init_master_model(
        cfg.model, torch.Generator().manual_seed(WEIGHTS_SEED), device=device)
    if args.checkpoint:
        params = ckpt_lib.load_params_npz(args.checkpoint, params)
    vgg = load_vgg_params(args.vgg_weights, device)

    style = _decode_resize(args.style, args.image_size).astype(
        np.float32) / 255.0
    files = list_images(args.content_dir)
    contents = np.stack([
        _decode_resize(f, args.image_size).astype(np.float32) / 255.0
        for f in files])
    print(f"adapting to {os.path.basename(args.style)} on {len(files)} "
          f"contents, {args.steps} steps")

    adapted = adapt_to_style(params, vgg, cfg, style, contents,
                             steps=args.steps, lr=args.lr, batch=args.batch,
                             seed=args.seed, device=device)

    os.makedirs(args.out_dir, exist_ok=True)
    ckpt_lib.save_params_npz(os.path.join(args.out_dir, "adapted.npz"),
                             adapted)
    style_b = torch.from_numpy(style)[None]
    for f, c in zip(files, contents):
        out = stylize(adapted, torch.from_numpy(c)[None], style_b, cfg.model,
                      k=args.k, device=device)
        _save_image(out[0].cpu().numpy(), os.path.join(
            args.out_dir, _stem(f) + "_stylized.jpg"))
    print(f"wrote {args.out_dir}/adapted.npz and "
          f"{len(files)} stylized images")


if __name__ == "__main__":
    main()
