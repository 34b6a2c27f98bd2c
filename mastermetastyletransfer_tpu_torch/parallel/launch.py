"""Start the ranks of a mesh as processes (the JAX package gets its devices
from the runtime; PyTorch needs a process per rank).

    results = spawn_ranks(fn, n, backend="gloo", device="cpu", args=(...))

runs ``fn(rank, n, device, *args)`` in n processes started with the
``spawn`` method (never ``fork``: a process that has started CUDA or
threads cannot fork safely), each in a process group of world size n
already initialised, and returns the ranks' results in rank order. ``fn``
must be a module-level function of a module that imports neither JAX nor
anything the ranks' machine lacks: each process imports it afresh.

Rendezvous is a ``file://`` store in a fresh temporary directory, so that
runs started side by side (test workers) never race for a port. The group
gets a finite timeout, so that a rank waiting on a collective that another
rank will never join fails instead of hanging. A CUDA rank binds
``cuda:(rank % device_count)``: with one card per rank, its own card
(NCCL); with one card for all (gloo), the same card. A rank that raises
ends the whole run, the others stopped, with its traceback
(``torch.multiprocessing.ProcessRaisedException``). Each rank returns its
result through a pickle file in the same directory, written by the rank
and read by the caller alone.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = {"gloo": ("cpu", "cuda"), "nccl": ("cuda",)}
# The process group's timeout: a collective waits this long for a rank.
TIMEOUT_S = 600.0


def spawn_ranks(fn: Callable, n: int, *, backend: str, device: str,
                args: Sequence = ()) -> List:
    """Run ``fn(rank, n, torch.device, *args)`` in n spawned ranks of one
    process group over ``backend`` ("gloo" or "nccl") on ``device`` ("cpu"
    or "cuda"); return their results in rank order."""
    if device not in BACKENDS.get(backend, ()):
        raise ValueError(f"backend {backend!r} on device {device!r}: one of "
                         f"{BACKENDS}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, and torch sees no card")
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise ValueError(f"NCCL takes one card per rank: {n} ranks, "
                         f"{torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory(prefix="mmst_ranks_") as tmp:
        mp.start_processes(_rank_main, nprocs=n, join=True,
                           start_method="spawn",
                           args=(fn, n, backend, device, tmp, tuple(args)))
        results = []
        for rank in range(n):
            with open(_result_path(tmp, rank), "rb") as f:
                results.append(pickle.load(f))
        return results


def _result_path(tmp: str, rank: int) -> str:
    return os.path.join(tmp, f"rank{rank}.pkl")


def _rank_main(rank: int, fn: Callable, n: int, backend: str, device: str,
               tmp: str, args: tuple) -> None:
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    out = fn(rank, n, dev, *args)
    # Only a rank that finished leaves the group, once every rank has: one
    # that raised exits with its traceback, and the caller stops the others.
    dist.barrier()
    dist.destroy_process_group()
    path = _result_path(tmp, rank)
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)
