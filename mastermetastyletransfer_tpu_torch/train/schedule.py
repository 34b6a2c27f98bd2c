"""The reference's learning-rate schedule: linear warmup, then stepped
exponential decay (JAX counterpart: train/schedule.py; reference:
train_only_inner_loop.py:321-341).

- warmup (iteration < warmup): from 1% of the base rate to the base rate;
- after: base * (1 - rate) ** ((it - warmup) // decay_every), floored at
  ``decay_until``.

The reference counts iterations from 1; the optimizer's step counts from 0,
so iteration = step + 1.
"""

from __future__ import annotations

import math
from typing import Callable

from mastermetastyletransfer_tpu_torch.config import TrainConfig


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    base = cfg.inner_lr
    warmup = cfg.warmup_iterations
    rate = cfg.lr_decay_rate
    every = max(int(cfg.lr_decay_every), 1)
    floor = cfg.lr_decay_until

    if not cfg.use_lr_schedule:
        return lambda step: base

    def schedule(step: int) -> float:
        it = float(step) + 1.0
        if it < warmup:
            return base * ((it / max(warmup, 1)) * 0.99 + 0.01)
        n_decays = math.floor(max(it - warmup, 0.0) / every)
        return max(base * (1.0 - rate) ** n_decays, floor)

    return schedule
