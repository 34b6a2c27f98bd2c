"""What the ranks of the band-owned spatial tests run (parallel/launch.py
``spawn_ranks``). This module imports torch, numpy and the port only:
each rank is a fresh process that imports it, and a function defined in a
test file would make every rank import JAX through that file.

Each worker returns numpy arrays or plain Python values; the whole-image
results (the bands put together) come back from rank 0.
"""

import numpy as np
import torch
import torch.distributed as dist

from mastermetastyletransfer_tpu_torch.models.decoder import (
    cnn_decoder_apply,
)
from mastermetastyletransfer_tpu_torch.ops import style_block, window_block
from mastermetastyletransfer_tpu_torch.parallel import (
    make_mesh, make_spatial_stylize_shmap, replicate, shard_batch,
)
from mastermetastyletransfer_tpu_torch.parallel import spatial_shmap as ss
from mastermetastyletransfer_tpu_torch.parallel.spatial import (
    gather_images_spatial, make_hybrid_mesh, make_spatial_stylize,
    shard_images_spatial,
)
from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map

# The kernel entries of the band path's Swin and style transformer.
BAND_ENTRIES = ((window_block, "window_block_rows"),
                (window_block, "window_block_windows"),
                (style_block, "encoder_scale_shift"),
                (style_block, "decoder_tail"))


def count_calls(entries=BAND_ENTRIES) -> dict:
    """Wrap each (module, name) entry so that its calls are counted (on the
    CPU a wrapper runs its plain version and counts no launch); returns
    the live counts."""
    counts = dict.fromkeys((name for _, name in entries), 0)
    for mod, name in entries:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        setattr(mod, name, counted)
    return counts


def _mesh(n: int, hybrid: bool):
    if hybrid:
        return make_hybrid_mesh(2, n // 2, device_type="cpu"), "data"
    return make_mesh(n, ("space",), device_type="cpu"), None


def _gathered(band, mesh, data_axis, rank):
    full = gather_images_spatial(band, mesh, data_axis=data_axis)
    return full.numpy() if rank == 0 else None


def collectives(rank, n, dev, x, cases):
    """``_band_roll_h``, ``_band_unroll_h`` and ``_band_repartition`` on this
    rank's band of each case's input: cases are (name, kind, arg, h_valid)
    with kind "roll" (arg sh), "unroll" (arg sh) or "repart" (arg o_rows);
    x maps name -> the whole (B, n * rows, W, C) input. Returns every
    band's output, in band order, from each rank its own."""
    torch.set_num_threads(1)
    mesh, _ = _mesh(n, False)
    band = ss.band_of(mesh)
    out = {}
    for name, kind, arg, h_valid in cases:
        xl = shard_images_spatial(torch.from_numpy(x[name]), mesh)
        if kind == "roll":
            y = ss._band_roll_h(xl, arg, band)
        elif kind == "unroll":
            y = ss._band_unroll_h(xl, arg, band)
        else:
            y = ss._band_repartition(xl, arg, band, h_valid=h_valid)
        out[name] = y.numpy()
    return out


def mesh_checks(rank, n, dev):
    """make_mesh's refusals (their messages), shard_batch and replicate on
    a world of n ranks, and the hybrid mesh's coordinates."""
    torch.set_num_threads(1)
    errors = {}
    for label, kw in (("too_many", dict(num_devices=n + 1)),
                      ("no_shape", dict(num_devices=n,
                                        axis_names=("data", "space"))),
                      ("bad_shape", dict(num_devices=n,
                                         axis_names=("data", "space"),
                                         shape=(n, 2)))):
        try:
            make_mesh(device_type="cpu", **kw)
        except ValueError as e:
            errors[label] = str(e)
    mesh = make_mesh(n, ("data",), device_type="cpu")
    batch = {"x": torch.arange(4 * n * 3).reshape(4 * n, 3),
             "y": [torch.arange(2 * n)]}
    try:
        shard_batch({"z": torch.zeros(2 * n + 1)}, mesh)
    except ValueError as e:
        errors["indivisible"] = str(e)
    mine = {"w": torch.full((3,), float(rank)),
            "v": {"u": torch.full((2, 2), 10.0 + rank)}}
    hybrid = make_hybrid_mesh(2, n // 2, device_type="cpu")
    return dict(errors=errors,
                shard=shard_batch(batch, mesh),
                replicated=replicate(mine, mesh),
                hybrid=(hybrid.get_local_rank("data"),
                        hybrid.get_local_rank("space"),
                        hybrid.mesh.tolist()))


def band_model(rank, n, dev, swin_params, decoder_params, cfg, images,
               feats):
    """The band Swin (``_swin_local``) on this rank's band of images, with
    the patch embed as configured and as a strided convolution
    (``patch_embed_impl="conv"``), and the band-local plain decoder
    (``_band_decoder``) on its band of each of feats (their dtypes: the
    weights are cast to each); all put together on rank 0."""
    torch.set_num_threads(1)
    mesh, _ = _mesh(n, False)
    band = ss.band_of(mesh)
    _, h, w, _ = images.shape
    aux, meta = ss._build_aux(h, w, cfg, n, band.index, dev)
    with torch.inference_mode():
        x = shard_images_spatial(torch.from_numpy(images), mesh)
        swin = [ss._swin_local(swin_params, x, scfg, aux, meta, band)
                for scfg in (cfg.swin,
                             cfg.swin.replace(patch_embed_impl="conv"))]
        dec = [ss._band_decoder(
            tree_map(lambda t, f=f: t.to(getattr(torch, str(f.dtype))),
                     decoder_params),
            shard_images_spatial(torch.from_numpy(f), mesh), cfg.decoder,
            band) for f in feats]
    return dict(swin=[_gathered(f, mesh, None, rank) for f in swin],
                decoder=[_gathered(d, mesh, None, rank) for d in dec])


def band_stylize(rank, n, dev, params, content, style, runs, hybrid=False,
                 kernel_dtypes=None):
    """The band stylize of each run (label, cfg, k, entry) on this rank's
    shards, entry "shmap" (make_spatial_stylize_shmap) or "spatial"
    (make_spatial_stylize), on a 1-D space mesh or the hybrid (2, n / 2)
    mesh; returns the put-together outputs (rank 0) and each run's
    kernel-entry calls on this rank. ``kernel_dtypes`` (names) widens the
    band gate's kernel types (spatial_shmap.KERNEL_DTYPES) in this rank:
    ("bfloat16", "float32") sends f32 through the kernel branches, which
    run their plain versions on the CPU."""
    torch.set_num_threads(1)
    if kernel_dtypes is not None:
        ss.KERNEL_DTYPES = tuple(getattr(torch, d) for d in kernel_dtypes)
    counts = count_calls()
    mesh, data_axis = _mesh(n, hybrid)
    params = replicate(params, mesh)
    c, s = shard_images_spatial((torch.from_numpy(content),
                                 torch.from_numpy(style)), mesh,
                                data_axis=data_axis)
    outs, calls = {}, {}
    for label, cfg, k, entry in runs:
        make = (make_spatial_stylize_shmap if entry == "shmap"
                else make_spatial_stylize)
        for key in counts:
            counts[key] = 0
        out = make(cfg, mesh, k=k, data_axis=data_axis)(params, c, s)
        calls[label] = dict(counts)
        outs[label] = _gathered(out, mesh, data_axis, rank)
    return dict(outputs=outs, calls=calls)


def band_pieces(rank, n, dev, x, cases, swin_params, decoder_params, cfg,
                images, feats):
    """``collectives``, ``band_model`` and (on a world of 4)
    ``mesh_checks`` in one run of n ranks."""
    return dict(collectives=collectives(rank, n, dev, x, cases),
                model=band_model(rank, n, dev, swin_params, decoder_params,
                                 cfg, images, feats),
                mesh=mesh_checks(rank, n, dev) if n == 4 else None)


def raise_on(rank, n, dev, bad):
    """Rank ``bad`` raises; the others wait on a collective it never
    joins."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.all_reduce(torch.ones(1))
    return rank


def whole_decoder(params, feats, cfg):
    """The whole-image plain decoder, the reference of the band one, in
    feats' dtype."""
    params = tree_map(lambda t: t.to(getattr(torch, str(feats.dtype))),
                      params)
    with torch.inference_mode():
        return cnn_decoder_apply(params, torch.from_numpy(feats),
                                 cfg.decoder).numpy()


def np_tree(tree):
    """A tree of tensors as numpy arrays (for comparisons)."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    return np.asarray(tree)
