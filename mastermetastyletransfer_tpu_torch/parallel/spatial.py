"""Spatial parallelism for high-resolution stylization: the hybrid mesh,
image placement, and the stylize entry (JAX counterpart:
parallel/spatial.py).

The reference caps cost architecturally -- attention is window-local (49
tokens a window) with global mixing through the alternating cyclic shift
(reference: codes/style_transformer.py:97-111) -- but runs on one device.
For the 1024^2 configuration the image is split along H over the ranks of
a "space" axis; a hybrid ("data", "space") mesh composes batch and spatial
splits for batched high-resolution serving.

JAX's ``make_spatial_stylize`` is GSPMD: it annotates the arrays with a
sharding and lets XLA's partitioner emit the halo exchanges. PyTorch has
no such partitioner, so the mechanism here is not GSPMD: the same function
runs through the band-owned path of parallel/spatial_shmap.py, explicit
halos over torch.distributed, with the decoder in its plain nine-conv
form (JAX's default ``sharded_decoder=True``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mastermetastyletransfer_tpu_torch.config import ModelConfig
from mastermetastyletransfer_tpu_torch.parallel.mesh import (
    axis_index, axis_slice, make_mesh, to_wire,
)
from mastermetastyletransfer_tpu_torch.parallel.spatial_shmap import (
    make_spatial_stylize_shmap, plain_decoder,
)
from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map


def make_hybrid_mesh(data: int, space: int, *,
                     device_type: str = "cuda") -> DeviceMesh:
    """Mesh over (data, space): batch split x spatial split."""
    return make_mesh(data * space, axis_names=("data", "space"),
                     shape=(data, space), device_type=device_type)


def make_spatial_stylize(cfg: ModelConfig, mesh: DeviceMesh, *, k: int = 1,
                         data_axis: Optional[str] = None,
                         space_axis: str = "space"):
    """Stylize with images split over H (and optionally the batch):
    ``fn(params, content, style)`` on this rank's shards, returning this
    rank's band (make_spatial_stylize_shmap's contract).

    The decoder runs in its plain resize + conv form, the same function as
    the phase-space form (ops/conv.py), at every band count, as JAX's does
    with its default ``sharded_decoder=True``. JAX's False, which keeps the
    configured decoder, has no parameter here: at n > 1 the band path runs
    the plain form whatever the configuration, and at n = 1 the configured
    decoder is ``make_spatial_stylize_shmap`` itself."""
    return make_spatial_stylize_shmap(plain_decoder(cfg), mesh, k=k,
                                      space_axis=space_axis,
                                      data_axis=data_axis)


def shard_images_spatial(batch, mesh: DeviceMesh, *,
                         data_axis: Optional[str] = None,
                         space_axis: str = "space"):
    """This rank's shard of every NHWC image tensor of a tree: its H-band
    over ``space_axis`` and, with ``data_axis``, its slice of the batch."""
    def shard(x):
        if data_axis is not None:
            x = axis_slice(x, mesh, data_axis, 0)
        return axis_slice(x, mesh, space_axis, 1)

    return tree_map(shard, batch)


def gather_images_spatial(band: torch.Tensor, mesh: DeviceMesh, *,
                          data_axis: Optional[str] = None,
                          space_axis: str = "space",
                          dst: int = 0) -> Optional[torch.Tensor]:
    """The inverse of ``shard_images_spatial``: every rank's band put
    together as the whole (B, H, W, C) tensor on the rank ``dst`` (global
    rank; on its device), None on the others. Every rank of the mesh calls
    it together."""
    wire = to_wire(band)
    rank = dist.get_rank()
    parts = ([torch.empty_like(wire) for _ in range(dist.get_world_size())]
             if rank == dst else None)
    dist.gather(wire, parts, dst=dst)
    if rank != dst:
        return None
    coords = mesh.mesh
    sdim = axis_index(mesh, space_axis)
    ddim = None if data_axis is None else axis_index(mesh, data_axis)
    bl, hb = band.shape[0], band.shape[1]
    nd = 1 if ddim is None else mesh.size(ddim)
    out = torch.empty((bl * nd, hb * mesh.size(sdim)) + tuple(band.shape[2:]),
                      dtype=band.dtype, device=band.device)
    for r, part in enumerate(parts):
        at = [int(i) for i in (coords == r).nonzero()[0]]
        di = 0 if ddim is None else at[ddim]
        si = at[sdim]
        out[di * bl:(di + 1) * bl, si * hb:(si + 1) * hb] = part
    return out
