"""Norms with PyTorch-module numerics on NHWC tensors (JAX counterpart:
ops/norm.py). Statistics are taken in float32 whatever the input dtype.

- instance_norm: nn.InstanceNorm2d(affine=False), biased variance, eps 1e-5
  (reference: codes/style_transformer.py:983-986, codes/loss.py:102-105);
- layer_norm: nn.LayerNorm over the last dim, eps 1e-5.
"""

from __future__ import annotations

from typing import Optional

import torch


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  scale: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalize over the spatial axes 1..ndim-2 per (sample, channel),
    with an optional per-channel affine."""
    xf = x.float()
    axes = tuple(range(1, x.ndim - 1))
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf * xf).mean(dim=axes, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with affine parameters."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)
