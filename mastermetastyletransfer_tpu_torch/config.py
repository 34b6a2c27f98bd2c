"""Configuration dataclasses of the port.

The port keeps its own copy of the configuration (it imports nothing of the
JAX package). Field names and defaults follow the JAX package's
``config.py``; ``from_dict`` accepts that package's JSON and ignores the
keys it does not know (reference: codes/full_model.py:21-60,
codes/style_transformer.py:1159-1226). The model's configurations carry
every field of the JAX package's, so that no model field of its JSON is
dropped: a value the port does not know raises where it is read
(``matmul_mode`` other than "native" or "split3" where its stage is
built), never silently.

``use_pallas`` keeps its JAX name so that JSON round-trips: in the port it
means "run the hand-written CUDA kernels of this stage" (the Swin blocks,
the style transformer, the decoder's phase convs).

The training fields (dropouts, stochastic depth, ``LossConfig``,
``DataConfig``, ``TrainConfig``, ``ExperimentConfig``) follow the same
rule: the JAX package's names and defaults, every field of its
``DataConfig`` and ``TrainConfig``, so that the trainer's ``config.json``
round-trips between the two.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


MATMUL_MODES = ("native", "split3")


def check_matmul_mode(cfg, stage: str) -> None:
    """Raise where a stage is built with a matmul mode the JAX package does
    not have. Its modes (its ops/precision.py): "native", the products in
    the working type with f32 sums; "split3", an f32 x f32 product as three
    bf16 passes of a hi/lo split (about 4.4e-6 relative error), a TPU
    workaround for the Mosaic compiler's missing HIGH precision, which
    leaves non-f32 products native. The port runs both as its native
    route: an f32 stage with TF32 off (models/master.py:_stage_ctx) and the
    kernels' scalar f32 bodies, which compute the same product more
    exactly; a bf16 stage one pass, as split3 runs it in JAX."""
    if cfg.matmul_mode not in MATMUL_MODES:
        raise ValueError(f"{stage}: matmul_mode={cfg.matmul_mode!r}, not one "
                         f"of {MATMUL_MODES}")


def _one_of(name: str, value: str, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"{name}={value!r}, not one of {allowed}")


class _ConfigBase:
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        """Build from a (possibly nested) plain dict, ignoring extra keys."""
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class AttentionConfig(_ConfigBase):
    """Shifted-window attention block (reference:
    codes/style_transformer.py:175-295)."""
    dim: int = 256
    num_heads: int = 8
    window_size: Tuple[int, int] = (7, 7)
    shift_size: Tuple[int, int] = (4, 4)
    qkv_bias: bool = True
    proj_bias: bool = True
    dropout: float = 0.0
    attention_dropout: float = 0.0
    use_pallas: bool = False


@dataclass(frozen=True)
class StyleTransformerConfig(_ConfigBase):
    """Style transformer encoder/decoder pair (reference:
    codes/style_transformer.py:1159-1226)."""
    encoder_dim: int = 256
    decoder_dim: int = 256
    encoder_num_heads: int = 8
    decoder_num_heads: int = 8
    encoder_window_size: Tuple[int, int] = (7, 7)
    decoder_window_size: Tuple[int, int] = (7, 7)
    encoder_shift_size: Tuple[int, int] = (4, 4)
    decoder_shift_size: Tuple[int, int] = (4, 4)
    encoder_mlp_ratio: float = 4.0
    decoder_mlp_ratio: float = 4.0
    encoder_dropout: float = 0.0
    decoder_dropout: float = 0.0
    encoder_attention_dropout: float = 0.0
    decoder_attention_dropout: float = 0.0
    encoder_qkv_bias: bool = True
    decoder_qkv_bias: bool = True
    encoder_proj_bias: bool = True
    decoder_proj_bias: bool = True
    encoder_stochastic_depth_prob: float = 0.1
    decoder_stochastic_depth_prob: float = 0.1
    # The style encoder runs norm-free, the decoder self block with
    # LayerNorm (reference: codes/style_transformer.py:807, :946).
    encoder_use_norm: bool = False
    decoder_use_norm: bool = True
    encoder_if_use_processed_Key_in_Scale_and_Shift_calculation: bool = True
    decoder_use_instance_norm_with_affine: bool = False
    decoder_use_regular_MHA_instead_of_Swin_at_the_end: bool = False
    decoder_use_Key_instance_norm_after_linear_transformation: bool = True
    decoder_exclude_MLP_after_Fcs_self_MHA: bool = False
    use_pallas: bool = False
    # The kernels' products: "native" or "split3" (one route in the port).
    matmul_mode: str = "native"
    # How the JAX package compiles a traced k: a masked scan or a switch
    # over the depths, two XLA graph shapes of one function. The port runs
    # a Python loop over the sampled k, which computes that function, so it
    # takes either value.
    traced_k_impl: str = "scan"

    def __post_init__(self):
        _one_of("traced_k_impl", self.traced_k_impl, ("scan", "switch"))

    def encoder_attn(self) -> AttentionConfig:
        return AttentionConfig(
            dim=self.encoder_dim, num_heads=self.encoder_num_heads,
            window_size=self.encoder_window_size,
            shift_size=self.encoder_shift_size,
            qkv_bias=self.encoder_qkv_bias, proj_bias=self.encoder_proj_bias,
            dropout=self.encoder_dropout,
            attention_dropout=self.encoder_attention_dropout,
            use_pallas=self.use_pallas)

    def decoder_attn(self) -> AttentionConfig:
        return AttentionConfig(
            dim=self.decoder_dim, num_heads=self.decoder_num_heads,
            window_size=self.decoder_window_size,
            shift_size=self.decoder_shift_size,
            qkv_bias=self.decoder_qkv_bias, proj_bias=self.decoder_proj_bias,
            dropout=self.decoder_dropout,
            attention_dropout=self.decoder_attention_dropout,
            use_pallas=self.use_pallas)


@dataclass(frozen=True)
class SwinConfig(_ConfigBase):
    """First two stages of torchvision's swin_{t,s,b} (reference:
    codes/utils.py:59-102). Output is NHWC (B, H/8, W/8, 2*embed_dim)."""
    variant: str = "swin_B"
    embed_dim: int = 128
    depths: Tuple[int, int] = (2, 2)
    num_heads: Tuple[int, int] = (4, 8)
    window_size: Tuple[int, int] = (7, 7)
    mlp_ratio: float = 4.0
    # torchvision scales stochastic depth linearly over all blocks of the
    # full model; the first 4 blocks of swin_B (24 blocks, p_max 0.5) get
    # p_i = 0.5 i / 23.
    stochastic_depth_probs: Tuple[float, ...] = (0.0, 0.5 / 23, 1.0 / 23,
                                                 1.5 / 23)
    use_pallas: bool = False
    # The kernels' products: "native" or "split3" (one route in the port).
    matmul_mode: str = "native"
    # The 4x4 stride-4 patch embedding as a space-to-depth GEMM ("s2d") or
    # a direct strided convolution ("conv"): one function.
    patch_embed_impl: str = "s2d"

    def __post_init__(self):
        _one_of("patch_embed_impl", self.patch_embed_impl, ("s2d", "conv"))

    @staticmethod
    def for_variant(variant: str) -> "SwinConfig":
        if variant == "swin_B":
            return SwinConfig(variant=variant, embed_dim=128, num_heads=(4, 8),
                              stochastic_depth_probs=(0.0, 0.5 / 23,
                                                      1.0 / 23, 1.5 / 23))
        if variant == "swin_S":
            return SwinConfig(variant=variant, embed_dim=96, num_heads=(3, 6),
                              stochastic_depth_probs=(0.0, 0.3 / 23,
                                                      0.6 / 23, 0.9 / 23))
        if variant == "swin_T":
            return SwinConfig(variant=variant, embed_dim=96, num_heads=(3, 6),
                              stochastic_depth_probs=(0.0, 0.2 / 11,
                                                      0.4 / 11, 0.6 / 11))
        raise ValueError(
            f"unknown swin variant {variant!r} (swin_T/swin_S/swin_B)")

    @property
    def out_dim(self) -> int:
        return self.embed_dim * 2


@dataclass(frozen=True)
class DecoderConfig(_ConfigBase):
    """CNN (AdaIN-paper) decoder (reference: codes/decoder.py:15-21). The
    phase-space switches are exact rewrites of the same nine convs
    (ops/conv.py); with ``use_pallas`` the phase convs run the stencil
    kernels K5-K7 (ops/phase_conv.py)."""
    channel_dim: int = 256
    initializer: str = "kaiming_normal_"
    # Each upsample -> pad -> conv pair as one coarse-grid phase conv.
    fuse_upsample: bool = True
    use_pallas: bool = False
    # The kernels' products: "native" or "split3" (one route in the port).
    matmul_mode: str = "native"
    # First conv index that runs on the plain fine grid instead.
    phase_exit: int = 99
    # The stencil conv (K5, K6) for the phase convs that pass its gate.
    use_stencil_conv: bool = True
    # The last upsample enters a second phase level (L2) in eval.
    phase2_tail: bool = True
    # The RGB conv under phase2_tail: "l2" (composed conv), "l1" (down to
    # L1, then a phase conv) or "l2k128" (the RGB-tail kernel K12's
    # 128-lane entry, ops/phase_conv.stencil_phase2_rgb128).
    # "l2gemm", the JAX package's four-shifted-products form of "l2" (a TPU
    # speed variant of the same function), runs the "l2" route here.
    rgb_tail: str = "l2"


@dataclass(frozen=True)
class ModelConfig(_ConfigBase):
    """Swin encoder + style transformer + CNN decoder (reference:
    codes/full_model.py:21-155)."""
    swin: SwinConfig = field(default_factory=SwinConfig)
    transformer: StyleTransformerConfig = field(
        default_factory=StyleTransformerConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    # "float32" or "bfloat16"; parameters stay float32.
    compute_dtype: str = "float32"
    # Per-stage overrides; None means compute_dtype.
    swin_dtype: Optional[str] = None
    transformer_dtype: Optional[str] = None
    decoder_dtype: Optional[str] = None

    def stage_dtype(self, stage: str) -> str:
        return getattr(self, f"{stage}_dtype") or self.compute_dtype

    def with_kernels(self, on: bool = True) -> "ModelConfig":
        """The hand-written kernels on (or off) in every stage, as the JAX
        service's --use_pallas sets them: the Swin blocks, the style
        transformer and the decoder."""
        return self.replace(
            swin=self.swin.replace(use_pallas=on),
            transformer=self.transformer.replace(use_pallas=on),
            decoder=self.decoder.replace(use_pallas=on))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        return cls(
            swin=SwinConfig.from_dict(d.get("swin", {})),
            transformer=StyleTransformerConfig.from_dict(
                d.get("transformer", {})),
            decoder=DecoderConfig.from_dict(d.get("decoder", {})),
            compute_dtype=d.get("compute_dtype", "float32"),
            swin_dtype=d.get("swin_dtype"),
            transformer_dtype=d.get("transformer_dtype"),
            decoder_dtype=d.get("decoder_dtype"),
        )

    @classmethod
    def from_json(cls, s: str) -> "ModelConfig":
        return cls.from_dict(json.loads(s))


@dataclass(frozen=True)
class LossConfig(_ConfigBase):
    """VGG19 perceptual loss (reference: codes/loss.py:77-98). The two
    ``replicate_*`` flags reproduce the reference's bugs bit for bit: an
    explicit lambda overwritten by the default (codes/loss.py:189-190), and
    a similarity loss of the content features against themselves
    (codes/loss.py:333-334). ``use_vgg19_with_batchnorm`` only says which
    torchvision weights a conversion folds into the same conv plan; the
    loss reads it nowhere, as in the JAX package."""
    use_vgg19_with_batchnorm: bool = False
    default_lambda_value: float = 10.0
    distance_content: str = "euclidian"      # or "euclidian_squared"
    distance_style: str = "euclidian"
    replicate_lambda_override_bug: bool = False
    replicate_similarity_bug: bool = False


@dataclass(frozen=True)
class DataConfig(_ConfigBase):
    """The data pipeline's config (reference: codes/get_dataloader.py,
    train.py:222-245, train_only_inner_loop.py:494-575): the image folders
    and the loaders' batch sizes, staging size, workers and sampler seed
    (data/pipeline.py's host half), the crop and the normalization flags
    (its device half and the training steps)."""
    content_dir: str = "datasets/coco_train_dataset/train2017"
    style_dir: str = "datasets/wikiart"
    batch_size_content: int = 4
    batch_size_style: int = 1
    resize_to: int = 512
    crop_to: int = 256
    use_random_crop: bool = True
    use_imagenet_normalization_for_swin: bool = True
    use_imagenet_normalization_for_loss: bool = True
    num_workers: int = 4
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig(_ConfigBase):
    """The training loop's config (reference: train.py:589-806,
    train_only_inner_loop.py:321-341, :619-879): what the steps, the
    optimizer and the schedule read, and what train/trainer.py's loop reads
    (iterations, the save periods, the seed, the device count).
    ``matmul_precision`` is recorded as the JAX package records it; the
    port's f32 stages run with TF32 off whatever its value
    (models/master.py:_stage_ctx). ``remat`` recomputes the model's forward
    in the backward pass; ``grad_accum_steps`` splits each batch into that
    many micro-batches run in turn, their gradients averaged."""
    mode: str = "plain"                 # "plain" | "meta" | "fast_adaptation"
    matmul_precision: str = "default"   # "default" | "high" | "highest"
    inner_lr: float = 1e-4
    outer_lr: float = 1e-4              # Reptile's outer step (meta mode)
    num_inner_updates: int = 1
    max_layers: int = 4                 # random k in [1, max_layers]
    lambda_style: float = 10.0
    max_iterations: int = 15000
    freeze_encoder: bool = True
    save_every: int = 100
    save_every_for_model: int = 1000
    use_lr_schedule: bool = True
    warmup_iterations: int = 0
    lr_decay_rate: float = 0.02
    lr_decay_every: int = 3000
    lr_decay_until: float = 0.0
    seed: int = 42
    num_devices: int = 1
    remat: bool = False
    grad_accum_steps: int = 1


@dataclass(frozen=True)
class ExperimentConfig(_ConfigBase):
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    exp_name: str = "master"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        return cls(model=ModelConfig.from_dict(d.get("model", {})),
                   loss=LossConfig.from_dict(d.get("loss", {})),
                   data=DataConfig.from_dict(d.get("data", {})),
                   train=TrainConfig.from_dict(d.get("train", {})),
                   exp_name=d.get("exp_name", "master"))

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))
