"""What the ranks of the data-parallel tests run (parallel/launch.py
``spawn_ranks``). This module imports torch, numpy and the port only:
each rank is a fresh process that imports it, and a function defined in a
test file would make every rank import JAX through that file.

A case is a dict: ``cfg`` (the port's ExperimentConfig), ``weights`` (a
key of the ``weights`` argument: numpy trees (model, VGG19), or an int
seed from which ``seeded_weights`` draws them), ``content`` (the global
batch, (B, H, W, 3), or (n_inner, B, H, W, 3) in meta mode), ``style``
(B, H, W, 3), ``seed`` (the step generator's) and ``k`` (None: drawn; a
list of ks in meta mode). Each rank steps on its rows of the global batch
(``DataShard.rows``) through the data-parallel step; rank 0 returns the
metrics and the state's trainable leaves and Adam moments, every rank a
digest of its whole state.
"""

import hashlib

import torch
import torch.distributed as dist

from mastermetastyletransfer_tpu_torch.losses.vgg import init_vgg19_features
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.parallel import (
    DataShard, make_mesh, replicate,
)
from mastermetastyletransfer_tpu_torch.train.state import create_train_state
from mastermetastyletransfer_tpu_torch.train.step import (
    make_meta_train_step, make_train_step,
)
from mastermetastyletransfer_tpu_torch.train.trainer import train
from mastermetastyletransfer_tpu_torch.utils.checkpoint import (
    flatten_params, params_from_jax,
)


def seeded_weights(cfg, seed: int):
    """The port's model and VGG19 weights drawn from one generator."""
    g = torch.Generator().manual_seed(seed)
    return (init_master_model(cfg.model, g, device="cpu"),
            init_vgg19_features(g, device="cpu"))


def case_weights(case, weights):
    """A case's (model, VGG19) weights, fresh tensors."""
    w = weights[case["weights"]]
    if isinstance(w, int):
        return seeded_weights(case["cfg"], w)
    return params_from_jax(w[0]), params_from_jax(w[1])


def run_step(case, weights, mesh=None, shard=None):
    """One step of the case from fresh weights: on the global batch
    (no mesh), or on ``shard``'s rows of it through the data-parallel
    step. Returns (state, metrics)."""
    cfg = case["cfg"]
    params, vgg = case_weights(case, weights)
    if mesh is not None:
        params, vgg = replicate(params, mesh), replicate(vgg, mesh)
    state = create_train_state(params, cfg.train)
    meta = cfg.train.mode == "meta"
    make = make_meta_train_step if meta else make_train_step
    step = make(cfg, vgg, device="cpu", mesh=mesh)
    content, style = case["content"], case["style"]
    if shard is not None:
        rows = shard.rows(style.shape[0])
        content = content[:, rows] if meta else content[rows]
        style = style[rows]
    gen = torch.Generator().manual_seed(case["seed"])
    if meta:
        return step(state, content, style, gen, ks=case["k"])
    return step(state, content, style, gen, k=case["k"])


def state_digest(state) -> str:
    """sha256 of every leaf, Adam's moments, the step and the count."""
    h = hashlib.sha256()
    for t in flatten_params(state.params).values():
        h.update(t.detach().numpy().tobytes())
    for t in state.opt.mu + state.opt.nu:
        h.update(t.numpy().tobytes())
    h.update(f"{state.step},{state.opt.count}".encode())
    return h.hexdigest()


def state_arrays(state) -> dict:
    """The trainable leaves and Adam's first moments, by flat key."""
    leaves = state.trainable()
    return dict(params={k: v.detach().numpy().copy()
                        for k, v in leaves.items()},
                mu={k: m.numpy().copy()
                    for k, m in zip(leaves, state.opt.mu)})


def dp_steps(rank, n, dev, cases, weights):
    """Each case's data-parallel step on this rank's rows."""
    torch.set_num_threads(1)
    mesh = make_mesh(n, device_type="cpu")
    out = {}
    for label, case in cases.items():
        shard = DataShard.on(mesh, max(case["cfg"].train.grad_accum_steps, 1))
        state, metrics = run_step(case, weights, mesh, shard)
        out[label] = dict(digest=state_digest(state), rows=shard.rows(
            case["style"].shape[0]).tolist())
        if rank == 0:
            out[label].update(metrics=metrics, **state_arrays(state))
    return out


def dp_train(rank, n, dev, runs):
    """``trainer.train`` of each (cfg, exp_dir) in ``runs``, by label: its
    result (rank 0's logged metrics) and the experiment directory this
    rank took from rank 0 (the object the trainer broadcasts)."""
    torch.set_num_threads(1)
    taken = []
    broadcast = dist.broadcast_object_list

    def recorded(objs, *args, **kwargs):
        broadcast(objs, *args, **kwargs)
        taken.append(objs[0])

    dist.broadcast_object_list = recorded
    try:
        return {label: dict(result=train(cfg, exp_dir=exp, log_every=1,
                                         device="cpu", dump_images=False),
                            exp_dir=taken[-1])
                for label, (cfg, exp) in runs.items()}
    finally:
        dist.broadcast_object_list = broadcast
