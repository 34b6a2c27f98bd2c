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

``to_pytree`` and ``load_pytree`` map the state to and from the tree that
the JAX package's checkpoints hold (``{"state": TrainState}``, flattened by
``utils/orbax.py``), optax's for ``make_optimizer``'s ``multi_transform``:

    state.step
    state.params.<path>
    state.opt_state.inner_states.freeze.inner_state        EmptyState: None
    state.opt_state.inner_states.train.inner_state.0.count Adam's count
    state.opt_state.inner_states.train.inner_state.0.mu.<path>
    state.opt_state.inner_states.train.inner_state.0.nu.<path>
                                        a frozen leaf's moments: None
    state.opt_state.inner_states.train.inner_state.1.count the schedule's

The port keeps one count for the two.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from mastermetastyletransfer_tpu_torch.config import TrainConfig
from mastermetastyletransfer_tpu_torch.train.schedule import make_lr_schedule
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    copy_leaf, flatten_params, tree_map,
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


_OPT = ("state", "opt_state", "inner_states")
_FREEZE = _OPT + ("freeze", "inner_state")
_ADAM = _OPT + ("train", "inner_state", 0)
_SCHEDULE = _OPT + ("train", "inner_state", 1, "count")
_COUNTS = (("state", "step"), _ADAM + ("count",), _SCHEDULE)


def param_paths(tree, prefix: tuple = ()) -> Dict[tuple, torch.Tensor]:
    """{path: leaf} in JAX's order of leaves (dict keys sorted, list items
    by their index as ints)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in param_paths(tree[k], prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in param_paths(t, prefix + (i,)).items()}
    return {prefix: tree}


def _count(n: int) -> torch.Tensor:
    return torch.tensor(int(n), dtype=torch.int32)


def optax_tree(step: int, count: int, params: Dict[tuple, torch.Tensor],
               mu: Dict[tuple, torch.Tensor], nu: Dict[tuple, torch.Tensor]
               ) -> List[Tuple[tuple, Optional[torch.Tensor]]]:
    """The checkpoint tree of a train state given by its parts: every
    parameter by its path (in JAX's order), Adam's moments by the paths of
    the trainable leaves (None for the rest), one count for Adam's and the
    schedule's."""
    out = [(("state", "step"), _count(step))]
    out += [(("state", "params") + p, v) for p, v in params.items()]
    out += [(_FREEZE, None), (_ADAM + ("count",), _count(count))]
    for name, moments in (("mu", mu), ("nu", nu)):
        out += [(_ADAM + (name,) + p, moments.get(p)) for p in params]
    out.append((_SCHEDULE, _count(count)))
    return out


def to_pytree(state: TrainState) -> List[Tuple[tuple, Optional[torch.Tensor]]]:
    """The state's leaves as the JAX package's checkpoint tree holds them,
    in JAX's order."""
    params = param_paths(state.params)
    index = {id(t): i for i, t in enumerate(state.opt.params)}
    trained = {p: index[id(v)] for p, v in params.items() if id(v) in index}
    return optax_tree(state.step, state.opt.count, params,
                      {p: state.opt.mu[i] for p, i in trained.items()},
                      {p: state.opt.nu[i] for p, i in trained.items()})


def load_pytree(state: TrainState, leaves: Dict[tuple, Optional[torch.Tensor]],
                where: str) -> TrainState:
    """Copy a checkpoint's tree (``utils/orbax.read_pytree``) into the
    state, each tensor in place on its device, once every check has
    passed. KeyError where the leaves or the trainable ones are not the
    state's (another training mode), ValueError where a shape is not the
    state's or Adam's and the schedule's counts differ."""
    want = dict(to_pytree(state))
    missing = [k for k in want if k not in leaves]
    extra = [k for k in leaves if k not in want]
    if missing or extra:
        raise KeyError(f"{where}: the checkpoint's leaves are not the "
                       f"state's: {len(missing)} missing {missing[:3]}, "
                       f"{len(extra)} extra {extra[:3]}")
    moved = [k for k, v in want.items() if (v is None) != (leaves[k] is None)]
    if moved:
        raise KeyError(f"{where}: the checkpoint's trainable leaves are not "
                       f"the state's (another training mode?): {moved[:3]}")
    for k, v in want.items():
        got = leaves[k]
        if v is not None and tuple(got.shape) != tuple(v.shape):
            raise ValueError(f"{where}: {k}: shape {tuple(got.shape)} in the "
                             f"checkpoint, {tuple(v.shape)} expected")
    for k in _COUNTS:
        if leaves[k].is_floating_point() or leaves[k].dtype == torch.bool:
            raise ValueError(f"{where}: {k}: a count of dtype "
                             f"{leaves[k].dtype}")
    step, adam, schedule = (int(leaves[k]) for k in _COUNTS)
    if adam != schedule:
        raise ValueError(f"{where}: Adam's count {adam} and the schedule's "
                         f"count {schedule} differ")
    for k, v in want.items():
        if v is not None and k not in _COUNTS:
            copy_leaf(v, leaves[k])
    state.step, state.opt.count = step, adam
    return state
