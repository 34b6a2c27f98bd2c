"""Profiling hooks: named trace ranges, a device trace and per-step wall
time (JAX counterpart: utils/profiling.py).

* ``annotate(name)``: a ``torch.profiler.record_function`` range (a named
  span in a ``trace_to`` trace), plus an NVTX range while CUDA is
  initialized, for an external timeline.
* ``trace_to(logdir)``: a ``torch.profiler.profile`` over the CPU and, where
  there is one, the CUDA device, written to ``logdir`` as a Chrome trace
  (Perfetto or chrome://tracing read it).
* ``sync(x)``: waits for the device of every tensor leaf of ``x`` (CUDA
  launches return before the work is done); a no-op for CPU tensors.
* ``StepTimer``: rolling per-step wall time and images per second.

The JAX package's ``utils/cache.py`` (its persistent XLA compile cache) and
``ops/vmem.py`` (the TPU's scoped-VMEM limit) have no counterpart: the
port's kernels are compiled once into ``build/`` and there is no compile
step per shape to cache, and an H100 block's shared memory is sized by
each kernel's own plan (``smem_bytes``, checked against the 227 KB a block
may opt into) rather than by a compiler-wide scoped limit.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range: record_function for the torch profiler, and NVTX
    on CUDA."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace_to(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where available) and write
    ``logdir/trace.json``, a Chrome trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _leaves(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)


def sync(x) -> None:
    """Wait for all work queued on the device of each tensor leaf of x
    (nested dicts, lists and tuples); CPU tensors need no wait."""
    for dev in {t.device for t in _leaves(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Rolling per-step wall time over the last ``window`` steps: ``tick``
    at each step's end; the first tick starts the clock."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def mean_step_seconds(self) -> float:
        return (sum(self.times) / len(self.times) if self.times
                else float("nan"))

    def imgs_per_sec(self, batch: int) -> float:
        s = self.mean_step_seconds
        return batch / s if s == s and s > 0 else float("nan")
