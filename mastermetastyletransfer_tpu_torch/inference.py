"""Bucketed zero-shot stylization of any image size (JAX counterpart:
inference.py). Inputs are reflect-padded up to the nearest size bucket and
the output is cropped back, so that only a few shapes ever run.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

from mastermetastyletransfer_tpu_torch.config import ModelConfig
from mastermetastyletransfer_tpu_torch.models.master import master_apply

DEFAULT_BUCKETS = (256, 512, 1024)


def pick_bucket(h: int, w: int,
                buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket covering max(h, w) (the largest if none does)."""
    m = max(h, w)
    for b in sorted(buckets):
        if m <= b:
            return b
    return max(buckets)


def _pad_to(x: torch.Tensor, s: int) -> torch.Tensor:
    """Reflect-pad NHWC bottom/right to (s, s). Reflection needs the pad
    below the current size, so extreme aspect ratios pad in stages; a
    1-pixel axis repeats its edge."""
    xc = x.permute(0, 3, 1, 2)
    xh, xw = xc.shape[2], xc.shape[3]
    while xh < s or xw < s:
        ph = min(s - xh, max(xh - 1, 0))
        pw = min(s - xw, max(xw - 1, 0))
        if ph == 0 and pw == 0:
            xc = F.pad(xc, (0, s - xw, 0, s - xh), mode="replicate")
            break
        xc = F.pad(xc, (0, pw, 0, ph), mode="reflect")
        xh, xw = xh + ph, xw + pw
    return xc.permute(0, 2, 3, 1)


def stylize(params: dict, content: torch.Tensor, style: torch.Tensor,
            cfg: ModelConfig, *, k: int = 1,
            buckets: Sequence[int] = DEFAULT_BUCKETS,
            device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Stylize NHWC batches of any size through size buckets; returns
    (B, H, W, 3) at the content's size, on ``device``."""
    content = torch.as_tensor(content, device=device)
    style = torch.as_tensor(style, device=device)
    _, h, w, _ = content.shape
    size = pick_bucket(h, w, buckets)
    with torch.inference_mode():
        out = master_apply(params, _pad_to(content, size),
                           _pad_to(style, size), cfg, k=k)
    return out[:, :h, :w, :]
