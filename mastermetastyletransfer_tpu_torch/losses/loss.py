"""Perceptual losses: the instance-normed content loss, the mean / std style
loss and the self-similarity loss (JAX counterpart: losses/loss.py;
reference: codes/loss.py:71-336, codes/utils.py:105-133).

total = content + lambda * style, over VGG19 [relu2_1, relu3_1, relu4_1,
relu5_1] features of (content, style, output) image triplets:

* content: per layer mean |IN(Fc) - IN(Fo)| (or squared), IN the non-affine
  InstanceNorm2d (biased variance, eps 1e-5);
* style: per layer mean |mu(Fs) - mu(Fo)| + |sigma(Fs) - sigma(Fo)| over the
  spatial axes, sigma torch's unbiased std, with a zero (not NaN) gradient
  where a channel is constant;
* similarity (on request): lower-triangle column-normalized spatial
  self-cosine maps on relu3_1 and relu4_1.

``LossConfig.replicate_lambda_override_bug`` and
``replicate_similarity_bug`` reproduce the reference's two bugs.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from mastermetastyletransfer_tpu_torch.config import LossConfig
from mastermetastyletransfer_tpu_torch.losses.vgg import vgg19_features_apply
from mastermetastyletransfer_tpu_torch.ops.norm import instance_norm


def _dist(x: torch.Tensor, squared: bool,
          per_example: bool = False) -> torch.Tensor:
    """Mean |x| or mean x^2; per_example keeps the batch axis."""
    v = x * x if squared else x.abs()
    if per_example:
        return v.reshape(v.shape[0], -1).mean(1)
    return v.mean()


def content_loss(feats_content: List[torch.Tensor],
                 feats_output: List[torch.Tensor],
                 distance: str = "euclidian",
                 per_example: bool = False) -> torch.Tensor:
    """Sum over layers of mean |IN(Fc) - IN(Fo)| (reference:
    codes/loss.py:284-287)."""
    sq = distance == "euclidian_squared"
    return sum(_dist(instance_norm(fc) - instance_norm(fo), sq, per_example)
               for fc, fo in zip(feats_content, feats_output))


def _spatial_mean_std(f: torch.Tensor):
    """Per (batch, channel) mean and unbiased std over the spatial axes of
    NHWC features."""
    b, h, w, c = f.shape
    n = h * w
    ff = f.float().reshape(b, n, c)
    mean = ff.mean(1)
    var = ((ff - mean[:, None, :]) ** 2).sum(1) / max(n - 1, 1)
    nonzero = var > 0
    std = torch.where(nonzero, torch.sqrt(torch.where(nonzero, var, 1.0)),
                      0.0)
    return mean, std


def style_loss(feats_style: List[torch.Tensor],
               feats_output: List[torch.Tensor],
               distance: str = "euclidian",
               per_example: bool = False) -> torch.Tensor:
    """Sum over layers of mean |mu_s - mu_o| + mean |sigma_s - sigma_o|
    (reference: codes/loss.py:310-313)."""
    sq = distance == "euclidian_squared"
    total = 0.0
    for fs, fo in zip(feats_style, feats_output):
        ms, ss = _spatial_mean_std(fs)
        mo, so = _spatial_mean_std(fo)
        total = (total + _dist(ms - mo, sq, per_example)
                 + _dist(ss - so, sq, per_example))
    return total


def _scaled_self_cosine_tril(f: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """Lower-triangle (k=-1) column-normalized spatial self-cosine map of
    NHWC features (reference: codes/utils.py:105-133)."""
    b, h, w, c = f.shape
    n = h * w
    x = f.float().reshape(b, n, c)
    norms = torch.linalg.norm(x, dim=-1).clamp_min(1e-8)
    sim = (x @ x.transpose(1, 2)) / (norms[:, :, None] * norms[:, None, :])
    sim = sim / (sim.sum(1, keepdim=True) + eps)
    return torch.tril(sim, diagonal=-1)


def similarity_loss(feats_a: List[torch.Tensor], feats_b: List[torch.Tensor],
                    distance: str = "euclidian",
                    per_example: bool = False) -> torch.Tensor:
    """Over relu3_1 and relu4_1 (reference: codes/loss.py:332-334)."""
    sq = distance == "euclidian_squared"
    return sum(_dist(_scaled_self_cosine_tril(feats_a[i])
                     - _scaled_self_cosine_tril(feats_b[i]), sq, per_example)
               for i in (1, 2))


def perceptual_loss(vgg_params: dict, content: torch.Tensor,
                    style: torch.Tensor, output: torch.Tensor,
                    cfg: LossConfig, *, lambda_value: Optional[float] = None,
                    compute_similarity: bool = False,
                    per_example: bool = False) -> dict:
    """The loss of NHWC image triplets: {"content", "style", "total"} (and
    "similarity" on request). Content and style, gradient-free targets,
    share one VGG pass; the output's pass carries the gradients."""
    if lambda_value is None or cfg.replicate_lambda_override_bug:
        lambda_value = cfg.default_lambda_value
    with torch.no_grad():
        if content.shape == style.shape:
            b = content.shape[0]
            fcs = vgg19_features_apply(vgg_params, torch.cat([content, style]))
            fc, fs = [f[:b] for f in fcs], [f[b:] for f in fcs]
        else:
            fc = vgg19_features_apply(vgg_params, content)
            fs = vgg19_features_apply(vgg_params, style)
    fo = vgg19_features_apply(vgg_params, output)
    c_loss = content_loss(fc, fo, cfg.distance_content, per_example)
    s_loss = style_loss(fs, fo, cfg.distance_style, per_example)
    out = {"content": c_loss, "style": s_loss,
           "total": c_loss + lambda_value * s_loss}
    if compute_similarity:
        other = fc if cfg.replicate_similarity_bug else fo
        out["similarity"] = similarity_loss(fc, other, cfg.distance_style,
                                            per_example)
    return out
