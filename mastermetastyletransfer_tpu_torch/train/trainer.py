"""Training driver CLI: plain, meta (Reptile) and fast-adaptation modes
(JAX counterpart: train/trainer.py; reference: train.py:567-811,
train_only_inner_loop.py:619-879): flags -> config -> the model, VGG19 and
train state -> resume -> the mode's step -> prefetching image-folder
loaders -> the step loop -> JSONL metrics, checkpoints and stylized-image
dumps.

Run:
    python -m mastermetastyletransfer_tpu_torch.train.trainer --mode plain \
        --content_dir ... --style_dir ... --max_iterations 1000 --use_pallas

``--use_pallas`` keeps its JAX name: it turns on the port's CUDA kernels in
every stage. ``--device`` (default cuda) places the run; the tests pass
cpu. Checkpoints are the JAX package's Orbax train-state checkpoints,
read and written without Orbax (utils/checkpoint.py): ``--resume`` takes
an exp_dir of either package.

Data parallelism (JAX's ``--num_devices``): ``main`` with ``--num_devices``
n > 1 starts n ranks (parallel/launch.py), over NCCL with a card each on
``--device cuda`` (fewer cards than n raise) and over gloo on ``--device
cpu``; each runs ``train``, which with ``num_devices`` n > 1 needs an
initialised process group of world size n (``make_mesh`` raises
otherwise). The ranks hold the same weights (rank 0's, broadcast once, as
the JAX package replicates them), restore the same checkpoint on
``--resume``, decode only their rows of each global batch and step
together through the data-parallel steps (train/step.py); rank 0 alone
resolves and writes the experiment directory (config, metrics,
checkpoints, dumps) and prints. ``--batch_size`` is the global batch,
and imgs/s counts it. Ranks that share one card over gloo are reached by
calling ``train`` inside ``spawn_ranks(..., backend="gloo",
device="cuda")``.

Randomness: the weights come from ``torch.Generator`` seeded with
``--seed`` (the VGG19's, without ``--vgg_weights``, from seed 1, as the
JAX package's key 1); each iteration's crops, k and stochastic-depth masks
from a generator seeded from (seed, iteration), so that a resumed run
draws what a continuous run draws at the same iteration. The loaders, as
the JAX package's, start over at their first batch on every call of
``train``, a resumed one too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from mastermetastyletransfer_tpu_torch.config import (
    DataConfig, ExperimentConfig, LossConfig, ModelConfig, SwinConfig,
    TrainConfig,
)
from mastermetastyletransfer_tpu_torch.data.pipeline import (
    device_preprocess_pair, make_train_iterators,
)
from mastermetastyletransfer_tpu_torch.losses.vgg import init_vgg19_features
from mastermetastyletransfer_tpu_torch.models.master import (
    init_master_model, master_apply,
)
from mastermetastyletransfer_tpu_torch.parallel.launch import spawn_ranks
from mastermetastyletransfer_tpu_torch.parallel.mesh import (
    DataShard, make_mesh, replicate,
)
from mastermetastyletransfer_tpu_torch.train.state import create_train_state
from mastermetastyletransfer_tpu_torch.train.step import (
    make_meta_train_step, make_train_step,
)
from mastermetastyletransfer_tpu_torch.utils import checkpoint as ckpt_lib
from mastermetastyletransfer_tpu_torch.utils.device import require_device
from mastermetastyletransfer_tpu_torch.utils.png import save_png

VGG_SEED = 1


def load_vgg_params(path: Optional[str],
                    device: Union[str, torch.device] = "cuda",
                    use_batchnorm: bool = False) -> dict:
    """VGG19 loss weights on ``device``: a flat .npz export, a torchvision
    .pt state dict (of vgg19_bn with ``use_batchnorm``, batch norm folded
    into the convs), or, without a path, a random draw from seed 1 (right
    in shape; only for smoke runs)."""
    template = init_vgg19_features(torch.Generator().manual_seed(VGG_SEED),
                                   device=device)
    if path is None:
        return template
    if path.endswith(".npz"):
        return ckpt_lib.load_params_npz(path, template)
    from mastermetastyletransfer_tpu_torch.utils.convert import (
        convert_vgg19, load_torch_state_dict,
    )
    return convert_vgg19(load_torch_state_dict(path),
                         use_batchnorm=use_batchnorm, device=device)


class MetricsLogger:
    """JSONL metrics log (replaces the reference's wandb and prints; wandb
    stays optional, imported only with use_wandb)."""

    def __init__(self, exp_dir: str, use_wandb: bool = False,
                 config: Optional[dict] = None, wandb_mode: str = "online"):
        os.makedirs(exp_dir, exist_ok=True)
        self.f = open(os.path.join(exp_dir, "metrics.jsonl"), "a")
        self.wandb = None
        if use_wandb:
            try:
                import wandb
                # online/offline selection, reference train.py:319-327
                wandb.init(project="mastermetastyletransfer_tpu_torch",
                           config=config, mode=wandb_mode)
                self.wandb = wandb
            except Exception as e:  # noqa: BLE001 (absent, or offline)
                print(f"wandb unavailable ({e}); logging to JSONL only")

    def log(self, step: int, metrics: dict):
        """One line: the step, each float metric, and ``ks`` (the meta
        step's depths) as a list of ints."""
        rec = {"step": step, **{k: (list(v) if k == "ks" else float(v))
                                for k, v in metrics.items()}}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.wandb:
            self.wandb.log(rec, step=step)

    def log_images(self, step: int, images: dict):
        """content/style/stylized triplets, as the reference logs them
        (train.py:539-553)."""
        if self.wandb:
            self.wandb.log(
                {k: self.wandb.Image(np.clip(np.asarray(v) * 255, 0, 255)
                                     .astype(np.uint8))
                 for k, v in images.items()}, step=step)

    def close(self):
        self.f.close()
        if self.wandb:
            self.wandb.finish()


def _resolve_exp_dir(exp_dir: str, resume: bool) -> str:
    """Collision renaming (reference train.py:137-150): a fresh run never
    reuses an existing experiment dir, it appends _2, _3, ... until one is
    free; --resume keeps the dir (it must exist to restore from)."""
    if resume or not os.path.exists(exp_dir):
        return exp_dir
    i = 2
    while os.path.exists(f"{exp_dir}_{i}"):
        i += 1
    renamed = f"{exp_dir}_{i}"
    print(f"experiment dir {exp_dir!r} exists; using {renamed!r}")
    return renamed


def iteration_generator(seed: int, it: int) -> torch.Generator:
    """The generator of iteration ``it``: its crops, then its k, then its
    masks (the JAX package folds the iteration into its key likewise)."""
    state = np.random.SeedSequence([seed, it]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & (2 ** 63 - 1))


def train(cfg: ExperimentConfig, *, exp_dir: str = "experiments/run",
          vgg_path: Optional[str] = None, resume: bool = False,
          use_wandb: bool = False, log_every: int = 10,
          dump_images: bool = True, wandb_mode: str = "online",
          device: Union[str, torch.device] = "cuda") -> dict:
    """Run the configured training loop on ``device``; returns the last
    logged metrics. With ``num_devices`` n > 1, one rank of n in an
    initialised process group (module docstring)."""
    tcfg, dcfg = cfg.train, cfg.data
    if tcfg.matmul_precision == "high" and (
            cfg.model.swin.use_pallas or cfg.model.transformer.use_pallas
            or cfg.model.decoder.use_pallas):
        # the JAX package's refusal, kept for the same configurations; the
        # port's f32 stages run with TF32 off whatever the value
        raise ValueError(
            "matmul_precision='high' cannot combine with use_pallas (the "
            "JAX package's kernels reject it); use 'highest' or disable "
            "the kernels")
    device = require_device(device)
    mesh = shard = None
    if tcfg.num_devices > 1:
        mesh = make_mesh(tcfg.num_devices, device_type=device.type)
        shard = DataShard.on(mesh, max(int(tcfg.grad_accum_steps), 1))
        shard.rows(dcfg.batch_size_content)     # raises where n x a does
    lead = mesh is None or shard.rank == 0      # not divide the batch
    if lead:
        exp_dir = _resolve_exp_dir(exp_dir, resume)
        os.makedirs(exp_dir, exist_ok=True)
        with open(os.path.join(exp_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
    if mesh is not None:
        # resolved once: a rank that resolved it after rank 0 made the
        # directory would pick the next free name
        shared = [exp_dir]
        dist.broadcast_object_list(shared, src=0)
        exp_dir = shared[0]

    params = init_master_model(cfg.model,
                               torch.Generator().manual_seed(tcfg.seed),
                               device=device)
    vgg = load_vgg_params(vgg_path, device)
    if mesh is not None:
        params, vgg = replicate(params, mesh), replicate(vgg, mesh)
    state = create_train_state(params, tcfg)

    start_step = 0
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    if resume and ckpt_lib.latest_step(ckpt_dir) is not None:
        state = ckpt_lib.restore_checkpoint(ckpt_dir, state)
        start_step = state.step
        if lead:
            print(f"resumed from step {start_step}")

    meta = tcfg.mode == "meta"
    make_step = make_meta_train_step if meta else make_train_step
    step_fn = make_step(cfg, vgg, device=device, mesh=mesh)
    per_step = dcfg.batch_size_content * (tcfg.num_inner_updates if meta
                                          else 1)
    last_metrics = {}
    with contextlib.ExitStack() as stack:
        content_loader, style_loader = make_train_iterators(dcfg, shard)
        stack.callback(content_loader.close)
        stack.callback(style_loader.close)
        logger = None
        if lead:
            logger = MetricsLogger(exp_dir, use_wandb, cfg.to_dict(),
                                   wandb_mode=wandb_mode)
            stack.callback(logger.close)
        t_start = time.time()
        for it in range(start_step, tcfg.max_iterations):
            gen = iteration_generator(tcfg.seed, it)
            style_u8 = torch.from_numpy(next(style_loader)).to(device)
            if meta:
                batches = [next(content_loader)
                           for _ in range(tcfg.num_inner_updates)]
                content_u8 = torch.from_numpy(np.stack(batches)).to(device)
                cflat, style = device_preprocess_pair(
                    cfg, content_u8.flatten(0, 1), style_u8, generator=gen,
                    shard=shard, groups=tcfg.num_inner_updates)
                content = cflat.unflatten(0, content_u8.shape[:2])
            else:
                content_u8 = torch.from_numpy(next(content_loader)).to(device)
                content, style = device_preprocess_pair(
                    cfg, content_u8, style_u8, generator=gen, shard=shard)
            state, metrics = step_fn(state, content, style, gen)
            if meta:
                metrics.pop("k")      # the last inner step's; ks has all

            if not lead:
                continue
            if (it + 1) % log_every == 0 or it == start_step:
                m = dict(metrics)
                m["imgs_per_sec"] = (per_step * (it + 1 - start_step)
                                     / max(time.time() - t_start, 1e-9))
                logger.log(it + 1, m)
                print(f"[{it + 1}/{tcfg.max_iterations}] " + " ".join(
                    f"{k}={v}" if k == "ks" else f"{k}={v:.4f}"
                    for k, v in m.items()))
                last_metrics = m

            if (it + 1) % tcfg.save_every_for_model == 0:
                ckpt_lib.save_checkpoint(ckpt_dir, state, it + 1,
                                         config_json=cfg.to_json())
            if dump_images and (it + 1) % tcfg.save_every == 0:
                c1 = content[0, 0] if meta else content[0]
                with torch.no_grad():
                    out = master_apply(state.params, c1[None], style[:1],
                                       cfg.model, k=1, deterministic=True)
                out_np = out[0].float().cpu().numpy()
                save_png(os.path.join(exp_dir, f"stylized_{it + 1}.png"),
                         out_np)
                logger.log_images(it + 1, {
                    "content": c1.cpu().numpy(),
                    "style": style[0].cpu().numpy(), "stylized": out_np})

    if lead:
        ckpt_lib.save_checkpoint(ckpt_dir, state, state.step,
                                 config_json=cfg.to_json())
    if mesh is not None:
        dist.barrier()      # the directory is whole when any rank returns
    return last_metrics


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=["plain", "meta", "fast_adaptation"],
                   default="plain")
    p.add_argument("--content_dir",
                   default="datasets/coco_train_dataset/train2017")
    p.add_argument("--style_dir", default="datasets/wikiart")
    p.add_argument("--exp_dir", default="experiments/run")
    p.add_argument("--vgg_weights", default=None,
                   help=".npz export or torchvision VGG19 .pt state dict")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--crop_to", type=int, default=256)
    p.add_argument("--resize_to", type=int, default=512)
    p.add_argument("--inner_lr", type=float, default=1e-4)
    p.add_argument("--outer_lr", type=float, default=1e-4)
    p.add_argument("--num_inner_updates", type=int, default=1)
    p.add_argument("--max_layers", type=int, default=4)
    p.add_argument("--lambda_style", type=float, default=10.0)
    p.add_argument("--max_iterations", type=int, default=15000)
    p.add_argument("--warmup_iterations", type=int, default=0)
    p.add_argument("--lr_decay_rate", type=float, default=0.02)
    p.add_argument("--lr_decay_every", type=int, default=3000)
    p.add_argument("--save_every", type=int, default=100)
    p.add_argument("--save_every_for_model", type=int, default=1000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel ranks: over NCCL with a card each "
                        "(--device cuda) or gloo (--device cpu)")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--matmul_precision", default=None,
                   choices=["default", "high", "highest"],
                   help="recorded in the config as the JAX package records "
                        "it; the port's float32 stages run with TF32 off "
                        "whatever the value ('high' with --use_pallas is "
                        "refused, as in the JAX package)")
    p.add_argument("--use_pallas", action="store_true",
                   help="the hand-written CUDA kernels in every stage (the "
                        "JAX package's flag name)")
    p.add_argument("--swin_variant", default="swin_B",
                   choices=["swin_T", "swin_S", "swin_B"])
    p.add_argument("--unfreeze_swin", action="store_true")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_mode", default="online",
                   choices=["online", "offline", "disabled"],
                   help="wandb run mode (reference train.py:319-327)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (cpu for tests)")
    return p


def config_from_args(args) -> ExperimentConfig:
    model = ModelConfig(swin=SwinConfig.for_variant(args.swin_variant),
                        compute_dtype=args.compute_dtype)
    if args.use_pallas:
        model = model.with_kernels()
    return ExperimentConfig(
        model=model,
        loss=LossConfig(default_lambda_value=args.lambda_style),
        data=DataConfig(content_dir=args.content_dir,
                        style_dir=args.style_dir,
                        batch_size_content=args.batch_size,
                        crop_to=args.crop_to, resize_to=args.resize_to,
                        seed=args.seed),
        train=TrainConfig(mode=args.mode, inner_lr=args.inner_lr,
                          outer_lr=args.outer_lr,
                          num_inner_updates=args.num_inner_updates,
                          max_layers=args.max_layers,
                          lambda_style=args.lambda_style,
                          max_iterations=args.max_iterations,
                          freeze_encoder=not args.unfreeze_swin,
                          save_every=args.save_every,
                          save_every_for_model=args.save_every_for_model,
                          warmup_iterations=args.warmup_iterations,
                          lr_decay_rate=args.lr_decay_rate,
                          lr_decay_every=args.lr_decay_every,
                          seed=args.seed, num_devices=args.num_devices),
        exp_name=os.path.basename(args.exp_dir),
    )


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.matmul_precision == "high" and args.use_pallas:
        parser.error("--matmul_precision high cannot combine with "
                     "--use_pallas (the JAX package's kernels reject it); "
                     "use highest, or drop --use_pallas")
    cfg = config_from_args(args)
    if args.matmul_precision is not None:
        cfg = cfg.replace(train=cfg.train.replace(
            matmul_precision=args.matmul_precision))
    kwargs = dict(exp_dir=args.exp_dir, vgg_path=args.vgg_weights,
                  resume=args.resume, use_wandb=args.use_wandb,
                  log_every=args.log_every, wandb_mode=args.wandb_mode)
    if args.num_devices > 1:
        device = require_device(args.device).type
        return spawn_ranks(_train_rank, args.num_devices,
                           backend="nccl" if device == "cuda" else "gloo",
                           device=device, args=(cfg, kwargs))[0]
    return train(cfg, device=args.device, **kwargs)


def _train_rank(rank: int, n: int, device: torch.device,
                cfg: ExperimentConfig, kwargs: dict) -> dict:
    """One rank of ``main``'s data-parallel run."""
    return train(cfg, device=device, **kwargs)


if __name__ == "__main__":
    main()
