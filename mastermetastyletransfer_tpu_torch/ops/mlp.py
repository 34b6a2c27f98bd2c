"""Linear and MLP on param dicts (JAX counterpart: ops/mlp.py).

The MLP is torchvision.ops.MLP(dim, [hidden, dim], GELU): Linear -> exact-
erf GELU -> Linear (reference: codes/style_transformer.py:366, :839-841,
:991). Kernels are (in, out).

Training draws its random masks from an explicit ``torch.Generator`` (the
JAX package's rng keys), on the generator's device, one draw per call that
is not the identity: at evaluation (``deterministic``) and at a rate of 0
nothing is drawn, so two routes that make the same calls in the same order
see the same masks.

In a data-parallel step (train/step.py with a mesh) each rank holds its
rows of the global batch, and ``data_shard`` makes every draw the one-device
step's: the draw takes the global shape and keeps this rank's rows, so that
every rank advances the shared generator as the one-device step does and
the same images get the same masks. Dim 0 of every draw is batch-major
(NHWC activations; windows (B * nW, ...) grouped by image), or
``stacked_batches`` such batches one after another (the Swin's one pass over
contents and styles, models/master.py).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["kernel"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


# (rank, n) of the data-parallel step in progress, and how many batches
# dim 0 of a draw stacks. Module globals, not thread-locals: a remat
# forward's recompute runs on autograd's device thread.
_SHARD: Optional[Tuple[int, int]] = None
_STACKED = 1


@contextlib.contextmanager
def data_shard(rank: int, n: int):
    """Draws as rank ``rank`` of ``n`` of a data-parallel step."""
    global _SHARD
    prev, _SHARD = _SHARD, (rank, n)
    try:
        yield
    finally:
        _SHARD = prev


@contextlib.contextmanager
def stacked_batches(groups: int):
    """Dim 0 of the draws inside is ``groups`` batches one after another."""
    global _STACKED
    prev, _STACKED = _STACKED, groups
    try:
        yield
    finally:
        _STACKED = prev


def _uniform_like(x: torch.Tensor, shape, g: torch.Generator
                  ) -> torch.Tensor:
    if _SHARD is None:
        return torch.rand(shape, generator=g, device=g.device).to(x.device)
    rank, n = _SHARD
    rest = tuple(shape[1:])
    m = shape[0] // _STACKED            # this rank's rows of each batch
    u = torch.rand((_STACKED, n * m) + rest, generator=g, device=g.device)
    return u[:, rank * m:(rank + 1) * m].reshape(tuple(shape)).to(x.device)


def dropout(x: torch.Tensor, p: float, *, deterministic: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Elementwise dropout: keep with probability 1 - p, scaled by
    1 / (1 - p)."""
    if deterministic or p == 0.0:
        return x
    keep = _uniform_like(x, x.shape, generator) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def mlp_apply(params: dict, x: torch.Tensor, *, dropout_p: float = 0.0,
              deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """fc1 -> GELU -> dropout -> fc2 -> dropout (JAX ops/mlp.py:66-79)."""
    h = F.gelu(linear(params["fc1"], x), approximate="none")
    h = dropout(h, dropout_p, deterministic=deterministic,
                generator=generator)
    y = linear(params["fc2"], h)
    return dropout(y, dropout_p, deterministic=deterministic,
                   generator=generator)


def stochastic_depth(x: torch.Tensor, p: float, *,
                     deterministic: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """torchvision StochasticDepth(p, "row"): one Bernoulli keep per sample
    with probability 1 - p, scaled by 1 / (1 - p); the identity at
    evaluation (JAX ops/mlp.py:81-91; reference:
    codes/style_transformer.py:361, :819)."""
    if deterministic or p == 0.0:
        return x
    keep_prob = 1.0 - p
    keep = _uniform_like(x, (x.shape[0],), generator) < keep_prob
    keep = keep.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(keep, x / keep_prob, 0.0).to(x.dtype)


def sd_lerp(x: torch.Tensor, y: torch.Tensor, p: float, *,
            deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth over a fused residual y = x + m: x + SD(y - x)
    (JAX models/style_transformer.py:78-84)."""
    if deterministic or p == 0.0:
        return y
    return x + stochastic_depth(y - x, p, deterministic=False,
                                generator=generator)


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
