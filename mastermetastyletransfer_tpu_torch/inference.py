"""Bucketed zero-shot stylization of any image size, the style-lambda
sweep and the stream blend (JAX counterpart: inference.py).

``stylize`` reflect-pads its inputs up to the nearest size bucket and crops
the output back, so that only a few shapes ever run. The lambda sweep runs
one architecture under several parameter sets (in the reference, lambda
selects a checkpoint: pretrained_model_lambda_is_{2,4}.pt), set by set.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from mastermetastyletransfer_tpu_torch.config import ModelConfig
from mastermetastyletransfer_tpu_torch.models.master import master_apply
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    WindowedStyleStream,
)
from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map

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


def stack_params(param_sets: List[dict]) -> dict:
    """Stack parameter trees of one structure along a new leading axis (the
    JAX package's form of a sweep's sets; the port's sweep takes the list)."""
    return tree_map(lambda *xs: torch.stack(xs), *param_sets)


def make_lambda_sweep_fn(cfg: ModelConfig, k: int = 1,
                         device: Union[str, torch.device] = "cuda"
                         ) -> Callable[..., torch.Tensor]:
    """Sweep over parameter sets (the lambda axis): fn(param_sets, content,
    style) -> (L, B, H, W, 3) on ``device``, where ``param_sets`` is a list
    of L trees of one structure on ``device``, run one after another. (The
    JAX package takes the sets stacked, vmaps over the set axis and halves
    its kernels' TPU VMEM budgets for the vmap's live buffers; a loop holds
    one set's buffers at a time and has no such budget.)"""
    device = torch.device(device)

    def sweep(param_sets, content, style):
        content = torch.as_tensor(content, device=device)
        style = torch.as_tensor(style, device=device)
        with torch.inference_mode():
            return torch.stack([master_apply(p, content, style, cfg, k=k)
                                for p in param_sets])

    return sweep


def lambda_sweep(param_sets: Dict[float, dict], content, style,
                 cfg: ModelConfig, *, k: int = 1,
                 device: Union[str, torch.device] = "cuda"
                 ) -> Dict[float, np.ndarray]:
    """The lambda control sweep: {lambda: params} -> {lambda: stylized},
    in sorted lambda order, as numpy arrays."""
    lams = sorted(param_sets)
    sets = [tree_map(lambda t: t.to(device), param_sets[lam]) for lam in lams]
    outs = make_lambda_sweep_fn(cfg, k, device)(sets, content, style)
    outs = outs.cpu().numpy()
    return {lam: outs[i] for i, lam in enumerate(lams)}


def interpolate_params(params_a: dict, params_b: dict, alpha) -> dict:
    """Stylization strength between two checkpoints (e.g. the lambda=2 and
    lambda=4 models): (1 - alpha) * a + alpha * b per leaf."""
    return tree_map(lambda a, b: (1.0 - alpha) * a + alpha * b, params_a,
                    params_b)


def blend_style_streams(streams: List, weights):
    """Style interpolation: the weighted sum of style streams
    (``models.encode_style_stream``, all of one k and one feature size),
    decoded with ``models.stylize_with_style_stream``; the AdaIN paper's
    style interpolation (Huang & Belongie 2017, sec. 7.1) on the (Key,
    Scale, Shift) triples. The weights are normalized to sum to 1 and the
    sum runs in float32, cast back to each tensor's dtype, so that
    weights [1, 0, ...] give stream 0 exactly. A windowed stream gives a
    ``WindowedStyleStream`` of the same (h, w)."""
    ws = np.asarray(weights, np.float32).reshape(-1)
    if ws.shape[0] != len(streams):
        raise ValueError(f"{len(streams)} streams but {ws.shape[0]} weights"
                         " -- zip would silently drop the extras")
    total = np.float32(ws.sum())
    if total == 0.0:
        raise ValueError("weights sum to zero")
    ws = ws / total
    first = streams[0]
    windowed = isinstance(first, WindowedStyleStream)
    for s in streams[1:]:
        if isinstance(s, WindowedStyleStream) != windowed:
            raise ValueError("windowed and generic streams do not blend")
        if windowed and s.hw != first.hw:
            raise ValueError(f"streams of feature sizes {first.hw} and "
                             f"{s.hw} do not blend")
        if len(s) != len(first):
            raise ValueError(f"streams of k={len(first)} and k={len(s)} do "
                             "not blend")
        for ta, tb in zip(first, s):
            if [t.shape for t in ta] != [t.shape for t in tb]:
                raise ValueError("streams of other shapes do not blend")

    def mix(*xs):
        acc = sum(float(w) * x.float() for w, x in zip(ws, xs))
        return acc.to(xs[0].dtype)

    triples = [tuple(mix(*(s[i][j] for s in streams)) for j in range(3))
               for i in range(len(first))]
    return WindowedStyleStream(triples, first.hw) if windowed else triples
