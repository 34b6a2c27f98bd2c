"""Device mesh, placement and the data axis's collectives on
torch.distributed (JAX counterpart: parallel/mesh.py).

JAX's ``Mesh`` holds the devices of one process and XLA places each array
by its ``NamedSharding``. Here each rank is a process with one device (on
one card shared by several ranks, each its own CUDA context), and a
``torch.distributed.device_mesh.DeviceMesh`` over an initialised process
group takes ``Mesh``'s place: it names the axes and gives each axis its
process group. A rank holds plain tensors, its own shard or a full copy,
so JAX's ``batch_sharding`` and ``replicated_sharding`` (specs that tell
XLA where an array lives) have no counterpart: ``shard_batch`` returns
this rank's slice of the batch and ``replicate`` makes every rank's copy
the first rank's.

How a tensor crosses ranks follows the group's backend (``to_wire``):
NCCL takes the rank's CUDA tensors as they are (one card per rank); gloo
takes CPU tensors, so a CUDA tensor goes through a pinned host copy and
back (ranks that share one card, where NCCL refuses two ranks).

Data parallelism (train/step.py) needs two more pieces that XLA gives the
JAX package for free: which rows of a global batch a rank holds
(``DataShard``), and the gradient's mean over the data axis
(``all_reduce_mean``, one collective a call).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map


def make_mesh(num_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, *,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the ranks of the initialised process group, whose world
    size must be ``num_devices`` (None: the world size). Default is a 1-D
    data-parallel mesh; pass ``shape`` and two axis names (e.g. ("data",
    "space")) for a hybrid batch x spatial mesh. ``device_type`` "cpu" is
    for ranks without a card (the CPU tests)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.launch.spawn_ranks, or "
                           "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if num_devices is None:
        num_devices = world
    if num_devices > world:
        raise ValueError(
            f"requested {num_devices} devices but only {world} available")
    if shape is None:
        shape = (num_devices,) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    if int(np.prod(shape)) != num_devices:
        raise ValueError(f"mesh shape {shape} != num_devices {num_devices}")
    if num_devices != world:
        raise ValueError(f"a mesh spans every rank of the process group: "
                         f"{num_devices} devices of {world} ranks")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """The dimension of the mesh named ``axis``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return names.index(axis)


def axis_slice(x: torch.Tensor, mesh: DeviceMesh, axis: str,
               dim: int) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim`` over the mesh axis
    ``axis``; raises where the size does not divide."""
    n = mesh.size(axis_index(mesh, axis))
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide "
                         f"over the {n} ranks of axis {axis!r}")
    m = x.shape[dim] // n
    return x.narrow(dim, mesh.get_local_rank(axis) * m, m)


def shard_batch(batch, mesh: DeviceMesh, axis: str = "data"):
    """This rank's slice of dim 0 of every tensor of a batch-leading tree
    (dim 0 split over ``axis``, in the axis's rank order)."""
    return tree_map(lambda x: axis_slice(x, mesh, axis, 0), batch)


def to_wire(t: torch.Tensor, group=None) -> torch.Tensor:
    """A contiguous tensor with t's values that a collective of ``group``
    takes: t itself where the backend takes t's device, else (gloo and a
    CUDA tensor) a pinned host copy."""
    backend = dist.get_backend(group)
    if t.is_cuda and backend == "gloo":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)
    if not t.is_cuda and backend == "nccl":
        raise ValueError("NCCL takes CUDA tensors; this one is on the CPU")
    return t.contiguous()


def wire_empty(like: torch.Tensor, group=None) -> torch.Tensor:
    """An uninitialised receive buffer for a tensor like ``like``, where
    ``to_wire`` would put it."""
    if like.is_cuda and dist.get_backend(group) == "gloo":
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def replicate(tree, mesh: DeviceMesh):
    """Every tensor of the tree as the mesh's first rank holds it, on every
    rank (a broadcast over the whole mesh); the tensors keep their
    devices."""
    src = int(mesh.mesh.flatten()[0])

    def bcast(t):
        w = to_wire(t.detach())
        if w.data_ptr() == t.data_ptr():
            w = w.clone()
        dist.broadcast(w, src=src)
        return w.to(t.device)

    return tree_map(bcast, tree)


class DataShard(NamedTuple):
    """One rank's part of every global batch: rank ``rank`` of ``n`` on
    the data axis, under ``accum`` micro-batches (``grad_accum_steps``).
    The loader, the crops and the step take their rows from it."""
    rank: int
    n: int
    accum: int = 1

    def rows(self, b: int) -> np.ndarray:
        """This rank's rows of a global batch of ``b``, in the order it
        holds them. Micro-batch j is global rows j b / a onward, as the
        JAX package reshapes the global batch, and the rank holds its 1/n
        of each in turn: j b / a + [rank b / (a n), (rank + 1) b / (a n));
        with a = 1 the contiguous slice ``shard_batch`` takes."""
        n, a = self.n, self.accum
        if b % (n * a):
            raise ValueError(f"a global batch of {b} does not divide over "
                             f"{n} ranks x grad_accum_steps={a} "
                             f"micro-batches")
        mb, m = b // a, b // (a * n)
        return np.concatenate([j * mb + self.rank * m + np.arange(m)
                               for j in range(a)])

    @classmethod
    def on(cls, mesh: DeviceMesh, accum: int = 1,
           axis: str = "data") -> "DataShard":
        """This rank's shard on the mesh's ``axis``."""
        return cls(mesh.get_local_rank(axis),
                   mesh.size(axis_index(mesh, axis)), accum)


# all_reduce_mean's calls and the bytes each rank sent into them, since
# the process started (chip_smoke.py reads them per step).
ALL_REDUCES = {"calls": 0, "bytes": 0}


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: DeviceMesh,
                    axis: str = "data") -> List[torch.Tensor]:
    """Each tensor's mean over the ranks of ``axis``, as new tensors on
    the inputs' devices and in their dtypes: flattened into one float32
    buffer, summed by one all-reduce (gloo has no AVG), divided by the
    axis size and unflattened. Every rank gets the same bits."""
    group = mesh.get_group(axis)
    n = mesh.size(axis_index(mesh, axis))
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    wire = to_wire(flat, group)
    dist.all_reduce(wire, group=group)
    wire.div_(n)
    ALL_REDUCES["calls"] += 1
    ALL_REDUCES["bytes"] += wire.numel() * wire.element_size()
    flat = wire.to(flat.device)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out
