"""Linear and MLP on param dicts (JAX counterpart: ops/mlp.py).

The MLP is torchvision.ops.MLP(dim, [hidden, dim], GELU): Linear -> exact-
erf GELU -> Linear (reference: codes/style_transformer.py:366, :839-841,
:991). Kernels are (in, out). The port serves evaluation only, where
dropout and stochastic depth are the identity, so neither appears here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["kernel"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(linear(params["fc1"], x), approximate="none")
    return linear(params["fc2"], h)


def uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def trunc_normal(g: torch.Generator, shape, std: float = 0.02) -> torch.Tensor:
    """Normal(0, std) truncated to the absolute interval [-2, 2], as
    torch.nn.init.trunc_normal_ with its defaults."""
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, std=std, a=-2.0, b=2.0, generator=g)
    return t


def init_linear(g: torch.Generator, d_in: int, d_out: int,
                use_bias: bool = True, init: str = "torch_default") -> dict:
    """"torch_default" is nn.Linear's U(+-1/sqrt(fan_in)); "xavier_uniform"
    with a tiny normal bias is the reference's MLP init
    (codes/style_transformer.py:368-372)."""
    if init == "xavier_uniform":
        p = {"kernel": uniform(g, (d_in, d_out), (6.0 / (d_in + d_out)) ** 0.5)}
        if use_bias:
            p["bias"] = torch.randn(d_out, generator=g) * 1e-6
        return p
    bound = (1.0 / d_in) ** 0.5
    p = {"kernel": uniform(g, (d_in, d_out), bound)}
    if use_bias:
        p["bias"] = uniform(g, (d_out,), bound)
    return p


def init_mlp(g: torch.Generator, dim: int, hidden: int,
             init: str = "torch_default") -> dict:
    return {"fc1": init_linear(g, dim, hidden, init=init),
            "fc2": init_linear(g, hidden, dim, init=init)}
