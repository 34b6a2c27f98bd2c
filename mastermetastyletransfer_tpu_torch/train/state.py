"""Train state: parameters, the Adam state and the step count, and the
freezing that the reference does with requires_grad (JAX counterpart:
train/state.py; reference: train.py:216-218,
train_only_inner_loop.py:306-318).

``trainable_labels`` labels each parameter "train" or "freeze" as the JAX
package does; ``create_train_state`` maps the labels onto the leaves'
``requires_grad``, and the optimizer holds the trainable leaves only, so a
frozen group gets neither gradients nor updates.

``Adam`` is the update of ``optax.adam``: bias-corrected moments, eps
outside the square root, the learning rate of the schedule at the step
count before the update (0 first). Its moments and count can also update
another list of leaves of the same shapes: the meta step's per-task copy
omega, task after task, through the one state that the JAX package keeps
in ``TrainState.opt_state`` (its train/step.py:189-205).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from mastermetastyletransfer_tpu_torch.config import TrainConfig
from mastermetastyletransfer_tpu_torch.train.schedule import make_lr_schedule
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    flatten_params, tree_map,
)


def trainable_labels(params: dict, cfg: TrainConfig) -> dict:
    """The tree of params with each leaf "train" or "freeze": plain and meta
    modes freeze the Swin unless ``freeze_encoder`` is off;
    fast_adaptation trains the style transformer's encoder only."""
    def sub(tree, label):
        return tree_map(lambda _: label, tree)

    if cfg.mode == "fast_adaptation":
        st = params["style_transformer"]
        return {"swin": sub(params["swin"], "freeze"),
                "decoder": sub(params["decoder"], "freeze"),
                "style_transformer": {
                    "encoder": sub(st["encoder"], "train"),
                    "decoder": sub(st["decoder"], "freeze")}}
    return {"swin": sub(params["swin"],
                        "freeze" if cfg.freeze_encoder else "train"),
            "decoder": sub(params["decoder"], "train"),
            "style_transformer": sub(params["style_transformer"], "train")}


class Adam:
    """optax.adam(schedule) over a list of tensors, updated in place."""

    def __init__(self, params: List[torch.Tensor],
                 schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             params: Optional[List[torch.Tensor]] = None) -> float:
        """One update from grads (one per parameter, in order) of
        ``params``, by default the leaves the optimizer was built over, else
        leaves of the same shapes in the same order; returns the learning
        rate it used."""
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        mhat = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        vhat = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        denom = torch._foreach_sqrt(vhat)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mhat, denom)
        torch._foreach_add_(self.params if params is None else params, mhat,
                            alpha=-lr)
        return lr


@dataclass
class TrainState:
    step: int
    params: dict
    opt: Adam

    def trainable(self) -> Dict[str, torch.Tensor]:
        """{flat key: leaf} of the leaves that train."""
        return {k: v for k, v in flatten_params(self.params).items()
                if v.requires_grad}


def create_train_state(params: dict, cfg: TrainConfig) -> TrainState:
    """Mark each leaf's requires_grad by its label and build the optimizer
    over the trainable leaves (the tree's tensors are updated in place)."""
    labels = flatten_params(trainable_labels(params, cfg))
    leaves = flatten_params(params)
    train = []
    for key, leaf in leaves.items():
        leaf.requires_grad_(labels[key] == "train")
        if labels[key] == "train":
            train.append(leaf)
    return TrainState(step=0, params=params,
                      opt=Adam(train, make_lr_schedule(cfg)))
