"""Mesh helpers, data parallelism's pieces and the band-owned spatial
stylize on torch.distributed (JAX counterpart: parallel/). The
data-parallel steps themselves are ``train/step.py``'s ``make_train_step``
and ``make_meta_train_step`` with a mesh. JAX's ``batch_sharding`` and
``replicated_sharding`` have no counterpart: a rank holds plain tensors
(parallel/mesh.py)."""

from mastermetastyletransfer_tpu_torch.parallel.mesh import (  # noqa: F401
    DataShard, all_reduce_mean, make_mesh, replicate, shard_batch,
)
from mastermetastyletransfer_tpu_torch.parallel.spatial_shmap import (  # noqa
    make_spatial_stylize_shmap, spatial_shmap_unsupported,
)
