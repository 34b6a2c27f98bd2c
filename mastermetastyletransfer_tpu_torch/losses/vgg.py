"""VGG19 features to relu5_1, emitting [relu2_1, relu3_1, relu4_1, relu5_1],
the loss backbone (JAX counterpart: losses/vgg.py; reference: the cut
torchvision VGG19 features[0:30], codes/loss.py:15-63).

NHWC in and out, as in the JAX package; inside, NCHW convolutions (3x3,
1-pixel zero padding, torch Conv2d padding=1) and 2x2 max pools. The
weights are random He-normal draws from a ``torch.Generator`` (the JAX
package draws its own; the tests carry one tree across with
utils/checkpoint.py:params_from_jax). No download.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

# (kind, in_ch, out_ch) per layer, one list per slice; "C" conv3x3 + ReLU,
# "M" max pool 2x2 / 2. Each slice ends after the ReLU of its named layer.
VGG19_LAYER_PLAN: List[List[Tuple[str, int, int]]] = [
    [("C", 3, 64), ("C", 64, 64), ("M", 0, 0), ("C", 64, 128)],
    [("C", 128, 128), ("M", 0, 0), ("C", 128, 256)],
    [("C", 256, 256), ("C", 256, 256), ("C", 256, 256), ("M", 0, 0),
     ("C", 256, 512)],
    [("C", 512, 512), ("C", 512, 512), ("C", 512, 512), ("M", 0, 0),
     ("C", 512, 512)],
]


def init_vgg19_features(g: torch.Generator, device="cuda") -> dict:
    """He-normal kernels (HWIO, std sqrt(2 / (9 Cin))) and zero biases, the
    JAX package's tree: {"conv0": {"kernel", "bias"}, ...}."""
    params = {}
    idx = 0
    for sl in VGG19_LAYER_PLAN:
        for kind, cin, cout in sl:
            if kind == "C":
                std = (2.0 / (3 * 3 * cin)) ** 0.5
                params[f"conv{idx}"] = {
                    "kernel": (torch.randn((3, 3, cin, cout), generator=g)
                               * std).to(device),
                    "bias": torch.zeros(cout, device=device)}
                idx += 1
    return params


def vgg19_features_apply(params: dict, x: torch.Tensor) -> List[torch.Tensor]:
    """NHWC images (B, H, W, 3) -> [relu2_1, relu3_1, relu4_1, relu5_1],
    each NHWC."""
    feats = []
    idx = 0
    y = x.permute(0, 3, 1, 2)
    for sl in VGG19_LAYER_PLAN:
        for kind, _, _ in sl:
            if kind == "M":
                y = F.max_pool2d(y, 2, 2)
            else:
                p = params[f"conv{idx}"]
                w = p["kernel"].to(y.dtype).permute(3, 2, 0, 1)
                y = F.relu(F.conv2d(y, w, p["bias"].to(y.dtype), padding=1))
                idx += 1
        feats.append(y.permute(0, 2, 3, 1))
    return feats
