"""Few-shot adaptation to one style image (JAX counterpart: adapt.py:29-65;
reference: the fast-adaptation stage of train_only_inner_loop.py, which
freezes everything but the style transformer's encoder, :306-318).

    from mastermetastyletransfer_tpu_torch.adapt import adapt_to_style
    adapted = adapt_to_style(params, vgg, cfg, style_img, content_imgs,
                             steps=20, lr=1e-4, batch=4, seed=0)

The JAX package's command line (image files in, stylized files out) is not
ported: it decodes images through PIL.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from mastermetastyletransfer_tpu_torch.config import ExperimentConfig
from mastermetastyletransfer_tpu_torch.data import repeat_style_to_batch
from mastermetastyletransfer_tpu_torch.train.state import create_train_state
from mastermetastyletransfer_tpu_torch.train.step import make_train_step
from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map


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
