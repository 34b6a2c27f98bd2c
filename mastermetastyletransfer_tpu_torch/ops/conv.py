"""NHWC convolution and upsampling of the CNN decoder (JAX counterpart:
ops/conv.py; reference: codes/decoder.py:23-55). Kernels are HWIO, as in
the JAX package.

Only the plain forms are here. The JAX package's phase-space forms
(``phase_conv3x3``, ``phase2_conv3x3`` and the rest) are exact rewrites of
the same convolutions that feed its stencil kernels; they come with the
port of those kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mastermetastyletransfer_tpu_torch.ops.mlp import uniform


def init_conv(g: torch.Generator, c_in: int, c_out: int,
              initializer: str = "kaiming_normal_") -> dict:
    """3x3 HWIO conv with the reference's initializers, fan_out mode and
    ReLU gain (reference: codes/decoder.py:58-73)."""
    shape = (3, 3, c_in, c_out)
    fan_out, fan_in = 9 * c_out, 9 * c_in
    gain = 2.0 ** 0.5
    if initializer == "kaiming_normal_":
        kernel = torch.randn(shape, generator=g) * (gain / fan_out ** 0.5)
    elif initializer == "kaiming_uniform_":
        kernel = uniform(g, shape, gain * (3.0 / fan_out) ** 0.5)
    elif initializer == "xavier_normal_":
        kernel = torch.randn(shape, generator=g) * (
            (2.0 / (fan_in + fan_out)) ** 0.5)
    elif initializer == "xavier_uniform_":
        kernel = uniform(g, shape, (6.0 / (fan_in + fan_out)) ** 0.5)
    elif initializer == "default":
        kernel = uniform(g, shape, (1.0 / fan_in) ** 0.5)
    else:
        raise ValueError(f"unknown initializer {initializer!r}")
    return {"kernel": kernel, "bias": torch.zeros(c_out)}


def reflect_conv(params: dict, x: torch.Tensor, *,
                 relu: bool = True) -> torch.Tensor:
    """1-pixel reflect pad -> 3x3 conv + bias -> optional ReLU."""
    xc = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    w = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)   # HWIO -> OIHW
    y = F.conv2d(xc, w, params["bias"].to(x.dtype))
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an NHWC tensor."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)
