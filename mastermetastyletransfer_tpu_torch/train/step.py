"""The training steps (JAX counterpart: train/step.py; reference:
train_only_inner_loop.py:389-614, train.py:316-563).

The plain step: sample k in [1, max_layers] (reference: train.py:448), run
the model in training mode (stochastic depth on, the Swin included) on the
inputs the flags give it, the VGG19 perceptual loss on the images the flags
give it (the four ImageNet-normalization combinations of
train_only_inner_loop.py:494-575), gradients of the trainable parameters,
one Adam update. With ``with_kernels`` on, the style transformer and the
Swin run K8-K10 forward and backward, the decoder K5 and K7 with their
backward passes (models/). Fast adaptation is the plain step with every
leaf but the style transformer's encoder frozen (train/state.py).

The meta step is Reptile (reference: train.py:316-563, its intended
algorithm as in the JAX package): clone theta's trainable leaves into
omega, ``num_inner_updates`` plain steps on omega through the one Adam
state, then theta += outer_lr * (omega - theta) on the trainable leaves.

``TrainConfig.grad_accum_steps`` splits the batch into micro-batches run in
turn, their gradients and losses averaged; ``TrainConfig.remat`` runs the
model's forward under non-reentrant ``torch.utils.checkpoint``, so that the
backward recomputes it from the same generator state.

Randomness comes from one explicit ``torch.Generator`` per call: k first,
then the model's masks in the order the model draws them (micro-batch after
micro-batch, inner step after inner step). The masked scan of the JAX
package over a traced k is a TPU-compiler workaround; the port loops over
the sampled k in Python.

A float32 model runs the whole step, backward and loss included, with TF32
off (the port's f32 stages do so in evaluation too); a bfloat16 model keeps
PyTorch's own flags.

Data parallelism: pass a mesh (parallel/mesh.py, a "data" axis over the
ranks of an initialised process group, one device each) and the step is
the one-device step on the global batch, computed by ranks that each hold
their rows of it (``DataShard``: the contiguous 1/n, or under
``grad_accum_steps`` their 1/n of each micro-batch). Every rank draws k
from the same generator; the model's masks are drawn in the global
batch's shape and sliced to the rank's rows (ops/mlp.data_shard); the
trainable leaves' gradients and the losses go through one mean all-reduce
(``all_reduce_mean``) before Adam, at every inner update of the meta
step; Adam and the meta step's interpolation then run identically on
every rank, whose weights stay equal bit for bit. Where the JAX package
lets XLA insert the all-reduce, the port makes it by hand; it uses no
``DistributedDataParallel``, since the parameters are dicts of tensors.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from mastermetastyletransfer_tpu_torch.config import (
    DataConfig, ExperimentConfig,
)
from mastermetastyletransfer_tpu_torch.losses.loss import perceptual_loss
from mastermetastyletransfer_tpu_torch.models.master import (
    _TF32_OFF, imagenet_normalize, master_apply,
)
from mastermetastyletransfer_tpu_torch.ops.mlp import data_shard
from mastermetastyletransfer_tpu_torch.parallel.mesh import (
    DataShard, all_reduce_mean,
)
from mastermetastyletransfer_tpu_torch.train.state import (
    TrainState, trainable_labels,
)
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    flatten_params, tree_map,
)


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


def _model_forward(cfg: ExperimentConfig) -> Callable:
    """(params, model content, model style, k, generator) -> output, the
    model in training mode. With ``remat``, under non-reentrant
    checkpointing: the reentrant form sees only tensor arguments, and the
    parameters come in a dict, so its output would carry no graph to them.
    ``preserve_rng_state`` restores only the default generators, so the
    recompute draws its masks from a copy of the explicit generator at the
    state the forward started from, and the caller's generator stays where
    the forward left it."""

    def forward(params, mc, ms, k, generator):
        return master_apply(params, mc, ms, cfg.model, k=k,
                            deterministic=False, generator=generator)

    if not cfg.train.remat:
        return forward

    def remat_forward(params, mc, ms, k, generator):
        start = generator.get_state()
        recompute = False

        def run(mc, ms):
            nonlocal recompute
            g = generator
            if recompute:       # the backward's: the forward's masks
                g = torch.Generator(device=generator.device)
                g.set_state(start)
            recompute = True
            return forward(params, mc, ms, k, g)

        return checkpoint(run, mc, ms, use_reentrant=False)

    return remat_forward


def make_loss_and_grad(cfg: ExperimentConfig, vgg_params: dict,
                       mesh=None) -> Callable:
    """(params, content, style, k, generator) -> (total loss, metrics, {flat
    key: grad}) for the leaves of params that require grad. With
    ``grad_accum_steps`` = n > 1 the batch (which n must divide) runs as n
    micro-batches in turn, each drawing its masks from the generator after
    the one before; the gradients and the losses are their means. With a
    mesh, content and style are this rank's rows, the masks the global
    batch's, and the gradients and losses their means over the ranks."""
    forward = _model_forward(cfg)
    accum = max(int(cfg.train.grad_accum_steps), 1)
    shard = None if mesh is None else DataShard.on(mesh, accum)

    def one(params, content, style, k, generator):
        with _precision(cfg):
            mc, ms = prepare_batch_for_model(content, style, cfg.data)
            out = forward(params, mc, ms, k, generator)
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
        return {name: v.detach() for name, v in losses.items()}, grads

    def local(params, content, style, k, generator):
        if accum == 1:
            return one(params, content, style, k, generator)
        b = content.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} does not divide into "
                             f"grad_accum_steps={accum} micro-batches")
        mb = b // accum
        parts = [one(params, content[i * mb:(i + 1) * mb],
                     style[i * mb:(i + 1) * mb], k, generator)
                 for i in range(accum)]
        losses = {name: sum(lo[name] for lo, _ in parts) / accum
                  for name in parts[0][0]}
        grads = {key: sum(g[key] for _, g in parts) / accum
                 for key in parts[0][1]}
        return losses, grads

    def loss_and_grad(params, content, style, k, generator):
        if shard is None:
            losses, grads = local(params, content, style, k, generator)
        else:
            with data_shard(shard.rank, shard.n):
                losses, grads = local(params, content, style, k, generator)
            mean = all_reduce_mean([*grads.values(), *losses.values()], mesh)
            grads = dict(zip(grads, mean))
            losses = dict(zip(losses, mean[len(grads):]))
        metrics = {name: float(v) for name, v in losses.items()}
        return losses["total"], metrics, grads

    return loss_and_grad


def _update(state: TrainState, loss_and_grad: Callable, content, style,
            generator: torch.Generator, k: Optional[int], max_layers: int
            ) -> dict:
    """One Adam update of the state's trainable leaves (in place, through
    ``state.opt``, whose moments the leaves need not be): k drawn unless
    given, loss and gradients, the update. Returns the metrics."""
    if k is None:
        k = _sample_k(generator, max_layers)
    _, metrics, grads = loss_and_grad(state.params, content, style, k,
                                      generator)
    leaves = state.trainable()
    lr = state.opt.step([grads[key] for key in leaves], list(leaves.values()))
    return dict(metrics, k=k, lr=lr)


def make_train_step(cfg: ExperimentConfig, vgg_params: dict,
                    device: Union[str, torch.device] = "cuda",
                    mesh=None) -> Callable:
    """The plain step (and fast adaptation's): (state, content, style,
    generator) -> (state, metrics). ``content`` and ``style`` are NHWC
    float32 in [0, 1] (numpy or tensors), the style already repeated to the
    content batch (reference: train.py:411-416); they are moved to
    ``device``. Adam's update is in place on the state's trainable
    leaves. With a mesh (data parallelism, module docstring) they are this
    rank's rows of the global batch (``DataShard.rows``), the state and
    the generator every rank's same."""
    device = torch.device(device)
    loss_and_grad = make_loss_and_grad(cfg, vgg_params, mesh)

    def step(state: TrainState, content, style,
             generator: torch.Generator, k: Optional[int] = None):
        """One update; ``k`` fixes the depth (a measurement at a known
        depth) instead of drawing it."""
        content = torch.as_tensor(content, device=device, dtype=torch.float32)
        style = torch.as_tensor(style, device=device, dtype=torch.float32)
        metrics = _update(state, loss_and_grad, content, style, generator, k,
                          cfg.train.max_layers)
        state.step += 1
        return state, metrics

    return step


@torch.no_grad()
def _interp(theta: dict, omega: dict, labels: dict, eta: float) -> dict:
    """theta += eta * (omega - theta), in place, on the leaves labelled
    "train" (reference: train.py:524-534); returns theta."""
    t_flat, o_flat = flatten_params(theta), flatten_params(omega)
    keys = [key for key, label in flatten_params(labels).items()
            if label == "train"]
    ts = [t_flat[key] for key in keys]
    diff = torch._foreach_sub([o_flat[key] for key in keys], ts)
    torch._foreach_mul_(diff, eta)
    torch._foreach_add_(ts, diff)
    return theta


def make_meta_train_step(cfg: ExperimentConfig, vgg_params: dict,
                         device: Union[str, torch.device] = "cuda",
                         mesh=None) -> Callable:
    """The Reptile meta step: (state, contents, style, generator, ks=None)
    -> (state, metrics of the last inner step). One call is one task:
    ``contents`` is (num_inner_updates, B, H, W, 3), a content batch per
    inner step, and ``style`` one style image repeated to B. ``state.params``
    are theta; omega, a copy of theta's trainable leaves (the frozen ones,
    the Swin's, shared with theta, so the weight caches keep hitting), lives
    inside the call. Each inner step draws its k, or takes ``ks[j]``, and
    takes one update through ``state.opt``, whose moments and count carry
    across tasks (reference: train.py:392-398); then theta moves toward
    omega by ``outer_lr`` and ``state.step`` counts one. With a mesh each
    inner batch is this rank's rows (``contents`` (n, B / ranks, ...)) and
    each inner update's gradients are averaged over the ranks."""
    device = torch.device(device)
    loss_and_grad = make_loss_and_grad(cfg, vgg_params, mesh)
    n = cfg.train.num_inner_updates

    def step(state: TrainState, contents, style,
             generator: torch.Generator,
             ks: Optional[Sequence[int]] = None):
        contents = torch.as_tensor(contents, device=device,
                                   dtype=torch.float32)
        style = torch.as_tensor(style, device=device, dtype=torch.float32)
        if contents.shape[0] != n or (ks is not None and len(ks) != n):
            raise ValueError(f"{n} inner updates: contents "
                             f"{tuple(contents.shape)}, ks {ks}")
        theta = state.params
        omega = tree_map(lambda t: (t.detach().clone().requires_grad_()
                                    if t.requires_grad else t), theta)
        inner = TrainState(step=state.step, params=omega, opt=state.opt)
        drawn = []
        for j in range(n):
            metrics = _update(inner, loss_and_grad, contents[j], style,
                              generator, None if ks is None else ks[j],
                              cfg.train.max_layers)
            drawn.append(metrics["k"])
        _interp(theta, omega, trainable_labels(theta, cfg.train),
                cfg.train.outer_lr)
        state.step += 1
        return state, dict(metrics, ks=drawn)

    return step
