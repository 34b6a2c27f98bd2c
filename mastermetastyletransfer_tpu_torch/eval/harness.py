"""Evaluation harness: the full content x style grid with per-pair loss
statistics and optional stylized-image dumps (JAX counterpart:
eval/harness.py; reference: test_model.py:17-214, the 11 x 20 = 220-pair
grid of goals.txt:34).

Each content runs against a batch of styles in one call (pairs are
independent), so the grid costs ceil(S / B) batched calls per content.
Everything a style alone determines, its Swin pass and the k encoder
triples (``encode_style_stream``), is computed once per style chunk and
reused for every content. A float32 model runs each batched call, the
VGG19 loss included, with TF32 off (``train/step.py:_precision``), so that
its losses are float32 losses on the card too.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from mastermetastyletransfer_tpu_torch.config import ExperimentConfig
from mastermetastyletransfer_tpu_torch.data.native_loader import encode_jpeg
from mastermetastyletransfer_tpu_torch.data.pipeline import (
    _decode_resize, list_images,
)
from mastermetastyletransfer_tpu_torch.losses.loss import perceptual_loss
from mastermetastyletransfer_tpu_torch.models.master import (
    encode_features, encode_style_stream, stylize_from_features_with_stream,
)
from mastermetastyletransfer_tpu_torch.train.step import (
    _loss_views, _precision, prepare_batch_for_model,
)
from mastermetastyletransfer_tpu_torch.utils.device import require_device


@dataclasses.dataclass
class EvalReport:
    total: List[float]
    content: List[float]
    style: List[float]
    similarity: List[float]
    pairs: List[Tuple[str, str]]

    def summary(self) -> Dict[str, float]:
        def ms(xs):
            a = np.asarray(xs, np.float64)
            return ((float(a.mean()), float(a.std())) if a.size
                    else (float("nan"),) * 2)

        out = {}
        for name in ("total", "content", "style", "similarity"):
            vals = getattr(self, name)
            if vals:
                out[f"{name}_mean"], out[f"{name}_std"] = ms(vals)
        out["num_pairs"] = len(self.pairs)
        return out


def load_eval_images(root: str, image_size: int = 256
                     ) -> Tuple[np.ndarray, List[str]]:
    """All images under root, resized to (image_size, image_size), float
    in [0, 1], with their paths (reference: test_model.py:39-48 resizes
    only, no crop)."""
    files = list_images(root, recursive=True)
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    imgs = np.stack([_decode_resize(f, image_size) for f in files])
    return imgs.astype(np.float32) / 255.0, files


def evaluate_grid(params: dict, vgg_params: dict, cfg: ExperimentConfig, *,
                  content_images: np.ndarray, style_images: np.ndarray,
                  content_names: Optional[List[str]] = None,
                  style_names: Optional[List[str]] = None,
                  k: int = 1, style_batch: int = 8,
                  compute_similarity: bool = False,
                  save_images_to: Optional[str] = None,
                  device: Union[str, torch.device] = "cuda") -> EvalReport:
    """Every content x style pair at depth k, contents in the outer loop.

    content_images (C, H, W, 3) and style_images (S, H, W, 3) are float in
    [0, 1]; ``params`` and ``vgg_params`` live on ``device``. The styles
    are padded with zero images to a multiple of ``style_batch``, so that
    every call has one shape; a padded style never reaches the report. A
    pair's stylized image goes to ``save_images_to/{content}__{style}.jpg``
    (reference: test_model.py:101-199, per pair)."""
    device = require_device(device)
    C, S = content_images.shape[0], style_images.shape[0]
    content_names = content_names or [f"content{i}" for i in range(C)]
    style_names = style_names or [f"style{i}" for i in range(S)]

    def encode_styles(styles):
        ms = prepare_batch_for_model(styles, styles, cfg.data)[1]
        return encode_style_stream(params, ms, cfg.model, k=k)

    def eval_batch(content_one, styles, stream):
        b = styles.shape[0]
        content = content_one[None].repeat(b, 1, 1, 1)
        mc = prepare_batch_for_model(content, styles, cfg.data)[0]
        fc = encode_features(params, mc, cfg.model)
        out = stylize_from_features_with_stream(params, fc, stream, cfg.model)
        lc, ls, lo = _loss_views(content, styles, out, cfg.data)
        losses = perceptual_loss(
            vgg_params, lc, ls, lo, cfg.loss,
            lambda_value=cfg.train.lambda_style,
            compute_similarity=compute_similarity, per_example=True)
        return out, losses

    pad = (-S) % style_batch
    styles_padded = torch.from_numpy(np.concatenate(
        [style_images, np.zeros((pad,) + style_images.shape[1:],
                                np.float32)])).to(device)

    report = EvalReport([], [], [], [], [])
    if save_images_to:
        os.makedirs(save_images_to, exist_ok=True)

    with torch.inference_mode(), _precision(cfg):
        style_feats = {s0: encode_styles(styles_padded[s0:s0 + style_batch])
                       for s0 in range(0, S, style_batch)}
        for ci in range(C):
            c_img = torch.from_numpy(content_images[ci]).to(device)
            for s0 in range(0, S, style_batch):
                out, losses = eval_batch(
                    c_img, styles_padded[s0:s0 + style_batch],
                    style_feats[s0])
                out = out.cpu().numpy()
                losses = {name: v.cpu().numpy()
                          for name, v in losses.items()}
                n_valid = min(style_batch, S - s0)
                for j in range(n_valid):
                    si = s0 + j
                    report.pairs.append((content_names[ci], style_names[si]))
                    report.total.append(float(losses["total"][j]))
                    report.content.append(float(losses["content"][j]))
                    report.style.append(float(losses["style"][j]))
                    if compute_similarity:
                        report.similarity.append(
                            float(losses["similarity"][j]))
                    if save_images_to:
                        _save_image(out[j], os.path.join(
                            save_images_to,
                            f"{_stem(content_names[ci])}__"
                            f"{_stem(style_names[si])}.jpg"))
    return report


def _stem(p: str) -> str:
    return os.path.splitext(os.path.basename(p))[0]


def _save_image(img01: np.ndarray, path: str) -> None:
    """JPEG at quality 95 through the port's own encoder, as the JAX
    package writes it through PIL (values scaled by 255, clipped,
    truncated)."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(np.clip(img01 * 255.0, 0, 255).astype(np.uint8),
                            95))
