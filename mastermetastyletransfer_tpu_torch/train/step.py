"""The plain training step (JAX counterpart: train/step.py, mode "plain",
one device; reference: train_only_inner_loop.py:389-614).

One step: sample k in [1, max_layers] (reference: train.py:448), run the
model in training mode (stochastic depth on, the Swin included) on the
inputs the flags give it, the VGG19 perceptual loss on the images the flags
give it (the four ImageNet-normalization combinations of
train_only_inner_loop.py:494-575), gradients of the trainable parameters,
one Adam update. With ``with_kernels`` on, the style transformer and the
Swin run K8-K10 forward and backward, the decoder K5 and K7 with their
backward passes (models/).

Randomness comes from one explicit ``torch.Generator`` per call: k first,
then the model's masks in the order the model draws them. The masked scan
of the JAX package over a traced k is a TPU-compiler workaround; the port
loops over the sampled k in Python.

A float32 model runs the whole step, backward and loss included, with TF32
off (the port's f32 stages do so in evaluation too); a bfloat16 model keeps
PyTorch's own flags.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple, Union

import torch

from mastermetastyletransfer_tpu_torch.config import (
    DataConfig, ExperimentConfig,
)
from mastermetastyletransfer_tpu_torch.losses.loss import perceptual_loss
from mastermetastyletransfer_tpu_torch.models.master import (
    _TF32_OFF, imagenet_normalize, master_apply,
)
from mastermetastyletransfer_tpu_torch.train.state import TrainState
from mastermetastyletransfer_tpu_torch.utils.checkpoint import flatten_params


def prepare_batch_for_model(content: torch.Tensor, style: torch.Tensor,
                            data_cfg: DataConfig
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the model sees: ImageNet-normalized iff the Swin flag is on."""
    if data_cfg.use_imagenet_normalization_for_swin:
        return imagenet_normalize(content), imagenet_normalize(style)
    return content, style


def _loss_views(content: torch.Tensor, style: torch.Tensor,
                output: torch.Tensor, data_cfg: DataConfig):
    """What the loss sees: all three normalized iff the loss flag is on."""
    if data_cfg.use_imagenet_normalization_for_loss:
        return (imagenet_normalize(content), imagenet_normalize(style),
                imagenet_normalize(output))
    return content, style, output


def _sample_k(generator: torch.Generator, max_layers: int) -> int:
    """k in [1, max_layers], both ends included."""
    return int(torch.randint(1, max_layers + 1, (1,), generator=generator,
                             device=generator.device).item())


def _precision(cfg: ExperimentConfig):
    m = cfg.model
    if all(m.stage_dtype(s) == "float32"
           for s in ("swin", "transformer", "decoder")):
        return _TF32_OFF
    return contextlib.nullcontext()


def make_loss_and_grad(cfg: ExperimentConfig, vgg_params: dict
                       ) -> Callable:
    """(params, content, style, k, generator) -> (total loss, metrics, {flat
    key: grad}) for the leaves of params that require grad."""

    def loss_and_grad(params, content, style, k, generator):
        with _precision(cfg):
            mc, ms = prepare_batch_for_model(content, style, cfg.data)
            out = master_apply(params, mc, ms, cfg.model, k=k,
                               deterministic=False, generator=generator)
            lc, ls, lo = _loss_views(content, style, out, cfg.data)
            losses = perceptual_loss(vgg_params, lc, ls, lo, cfg.loss,
                                     lambda_value=cfg.train.lambda_style)
            leaves = {key: v for key, v in flatten_params(params).items()
                      if v.requires_grad}
            grads = torch.autograd.grad(losses["total"],
                                        list(leaves.values()),
                                        allow_unused=True)
        grads = {key: (g if g is not None else torch.zeros_like(v))
                 for (key, v), g in zip(leaves.items(), grads)}
        metrics = {name: float(v.detach()) for name, v in losses.items()}
        return losses["total"].detach(), metrics, grads

    return loss_and_grad


def make_train_step(cfg: ExperimentConfig, vgg_params: dict,
                    device: Union[str, torch.device] = "cuda") -> Callable:
    """The plain step: (state, content, style, generator) -> (state,
    metrics). ``content`` and ``style`` are NHWC float32 in [0, 1] (numpy or
    tensors), the style already repeated to the content batch (reference:
    train.py:411-416); they are moved to ``device``. Adam's update is in
    place on the state's trainable leaves."""
    device = torch.device(device)
    loss_and_grad = make_loss_and_grad(cfg, vgg_params)

    def step(state: TrainState, content, style,
             generator: torch.Generator, k: Optional[int] = None):
        """One update; ``k`` fixes the depth (a measurement at a known
        depth) instead of drawing it."""
        content = torch.as_tensor(content, device=device, dtype=torch.float32)
        style = torch.as_tensor(style, device=device, dtype=torch.float32)
        if k is None:
            k = _sample_k(generator, cfg.train.max_layers)
        _, metrics, grads = loss_and_grad(state.params, content, style, k,
                                          generator)
        keys = list(state.trainable())
        lr = state.opt.step([grads[key] for key in keys])
        state.step += 1
        return state, dict(metrics, k=k, lr=lr)

    return step
