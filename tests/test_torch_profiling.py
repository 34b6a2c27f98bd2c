"""The port's profiling hooks (``utils/profiling.py``) against the JAX
package's on the CPU: ``StepTimer`` under a patched clock, step for step
with JAX's; ``annotate`` as a named range in a ``trace_to`` Chrome trace;
``sync`` a no-op on CPU tensors (the card's ``sync`` is driven by
chip_smoke.py)."""

import json

import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu.utils import profiling as jprof
from mastermetastyletransfer_tpu_torch.utils import profiling as tprof


class _Clock:
    def __init__(self, ticks):
        self._ticks = iter(ticks)

    def __call__(self):
        return next(self._ticks)


@pytest.mark.parametrize("window", [1, 3, 50])
def test_step_timer_matches_jax(monkeypatch, window):
    ticks = np.cumsum(np.random.default_rng(window).uniform(0.01, 0.2, 12))
    timers = {}
    for name, mod in (("jax", jprof), ("port", tprof)):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(ticks.tolist()))
        timer = mod.StepTimer(window=window)
        seen = [(timer.mean_step_seconds, timer.imgs_per_sec(8))]
        for _ in ticks:
            timer.tick()
            seen.append((timer.mean_step_seconds, timer.imgs_per_sec(8)))
        timers[name] = (timer.times, seen)
    assert timers["port"][0] == timers["jax"][0]
    assert len(timers["port"][0]) == min(window, len(ticks) - 1)
    for (pm, pi), (jm, ji) in zip(timers["port"][1], timers["jax"][1]):
        assert (pm == jm or (np.isnan(pm) and np.isnan(jm)))
        assert (pi == ji or (np.isnan(pi) and np.isnan(ji)))


def test_annotate_shows_in_the_trace(tmp_path):
    with tprof.trace_to(str(tmp_path)):
        with tprof.annotate("mmst_step"):
            y = torch.ones(64, 64) @ torch.ones(64, 64)
        tprof.sync(y)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "mmst_step" in names
    assert float(y[0, 0]) == 64.0


def test_sync_walks_the_tree_on_cpu():
    tree = {"a": torch.zeros(2), "b": [torch.ones(1), (torch.zeros(3),)],
            "c": 3}
    tprof.sync(tree)
    tprof.sync(torch.zeros(1))
    tprof.sync([])
