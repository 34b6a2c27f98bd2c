"""Full model: Swin encoder -> style transformer -> CNN decoder (JAX
counterpart: models/master.py; reference: codes/full_model.py:21-226).
NHWC throughout.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Union

import torch

from mastermetastyletransfer_tpu_torch.config import ModelConfig
from mastermetastyletransfer_tpu_torch.models.decoder import (
    cnn_decoder_apply, init_cnn_decoder,
)
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    init_style_transformer, style_transformer_apply,
    style_transformer_apply_from_stream, style_transformer_stream,
)
from mastermetastyletransfer_tpu_torch.models.swin import (
    init_swin_backbone, swin_backbone_apply,
)
from mastermetastyletransfer_tpu_torch.ops.mlp import stacked_batches
from mastermetastyletransfer_tpu_torch.utils.checkpoint import tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_master_model(cfg: ModelConfig, generator: torch.Generator,
                      device: Union[str, torch.device] = "cuda") -> dict:
    """Float32 parameters drawn on the CPU from ``generator`` with the JAX
    package's tree, shapes and initializer distributions, then moved to
    ``device``. (The two frameworks draw different numbers from one seed;
    tests share weights through utils/checkpoint.py.)"""
    params = {
        "swin": init_swin_backbone(generator, cfg.swin),
        "style_transformer": init_style_transformer(generator,
                                                    cfg.transformer),
        "decoder": init_cnn_decoder(generator, cfg.decoder),
    }
    return tree_map(lambda t: t.to(device), params)


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Cast floating-point leaves to ``dtype``."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    params)


class _TF32Off:
    """TF32 off for cuBLAS matmuls and cuDNN convolutions while any thread
    is inside. The flags are process-wide and one service per k runs its
    own worker thread, so the first thread in saves the flags and the last
    one out restores them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inside = 0
        self._saved = None

    def __enter__(self):
        matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        with self._lock:
            if self._inside == 0:
                self._saved = (matmul.allow_tf32, cudnn.allow_tf32)
                matmul.allow_tf32 = cudnn.allow_tf32 = False
            self._inside += 1

    def __exit__(self, *exc):
        with self._lock:
            self._inside -= 1
            if self._inside == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = self._saved


_TF32_OFF = _TF32Off()


def _stage_ctx(cfg: ModelConfig, stage: str):
    """Precision of one stage of the forward pass: a float32 stage runs with
    TF32 off (PyTorch's default lets cuDNN run float32 convolutions in
    TF32), and the caller's setting comes back after it; a bfloat16 stage
    is left as it is. (The JAX package's counterpart runs a float32 stage
    at matmul precision HIGHEST.)"""
    if DTYPES[cfg.stage_dtype(stage)] == torch.float32:
        return _TF32_OFF
    return contextlib.nullcontext()


def master_apply(params: dict, content: torch.Tensor, style: torch.Tensor,
                 cfg: ModelConfig, *, k: int = 1, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stylize ``content`` with ``style`` (NHWC RGB, normalized the way the
    Swin encoder expects); returns float32 RGB. Evaluation by default;
    training passes ``deterministic=False`` and the generator its
    stochastic-depth (and dropout) masks are drawn from, the Swin's first,
    then the style transformer's.

    Content and style share one Swin pass when their shapes agree (the
    reference calls it twice, codes/full_model.py:219-220; every op is
    independent per image, so the concatenation is exact; a data-parallel
    step's draws see the two batches stacked, ops/mlp.stacked_batches)."""
    dtype = DTYPES[cfg.stage_dtype("swin")]
    content, style = content.to(dtype), style.to(dtype)
    rand = dict(deterministic=deterministic, generator=generator)
    with _stage_ctx(cfg, "swin"):
        if content.shape == style.shape:
            b = content.shape[0]
            with stacked_batches(2):
                both = swin_backbone_apply(params["swin"],
                                           torch.cat([content, style]),
                                           cfg.swin, **rand)
            fc, fs = both[:b], both[b:]
        else:
            fc = swin_backbone_apply(params["swin"], content, cfg.swin, **rand)
            fs = swin_backbone_apply(params["swin"], style, cfg.swin, **rand)
    return stylize_from_features(params, fc, fs, cfg, k=k, **rand)


def stylize_from_features(params: dict, fc: torch.Tensor, fs: torch.Tensor,
                          cfg: ModelConfig, *, k: int = 1,
                          deterministic: bool = True,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Style transformer + CNN decoder on encoder features."""
    td = DTYPES[cfg.stage_dtype("transformer")]
    with _stage_ctx(cfg, "transformer"):
        fcs = style_transformer_apply(params["style_transformer"], fc.to(td),
                                      fs.to(td), cfg.transformer, k=k,
                                      deterministic=deterministic,
                                      generator=generator)
    dd = DTYPES[cfg.stage_dtype("decoder")]
    with _stage_ctx(cfg, "decoder"):
        out = cnn_decoder_apply(params["decoder"], fcs.to(dd), cfg.decoder,
                                deterministic=deterministic)
    return out.float()


def encode_features(params: dict, images: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Frozen-encoder features (B, H/8, W/8, 2E) of NHWC images, so that
    a caller can keep a style's features across many contents (the
    reference recomputes the Swin per pair, codes/full_model.py:219-220)."""
    with _stage_ctx(cfg, "swin"):
        return swin_backbone_apply(
            params["swin"], images.to(DTYPES[cfg.stage_dtype("swin")]),
            cfg.swin)


def encode_style_stream(params: dict, style: torch.Tensor, cfg: ModelConfig,
                        *, k: int):
    """Everything of one style that no content changes: its Swin features
    and the k (Key, Scale, Shift) encoder triples evolved from them. The
    encoder reads the style alone (reference:
    codes/style_transformer.py:1229-1245), so computing it once per style
    is exact, and each content then pays only its own Swin pass and the
    decoder halves (style-locked serving)."""
    fs = encode_features(params, style, cfg)
    td = DTYPES[cfg.stage_dtype("transformer")]
    with _stage_ctx(cfg, "transformer"):
        return style_transformer_stream(params["style_transformer"],
                                        fs.to(td), cfg.transformer, k=k)


def stylize_from_features_with_stream(params: dict, fc: torch.Tensor, stream,
                                      cfg: ModelConfig) -> torch.Tensor:
    """The style transformer's decoder half and the CNN decoder on content
    features and a style stream (``encode_style_stream`` under the same
    cfg); returns float32 RGB."""
    td = DTYPES[cfg.stage_dtype("transformer")]
    with _stage_ctx(cfg, "transformer"):
        fcs = style_transformer_apply_from_stream(
            params["style_transformer"], fc.to(td), stream, cfg.transformer)
    dd = DTYPES[cfg.stage_dtype("decoder")]
    with _stage_ctx(cfg, "decoder"):
        out = cnn_decoder_apply(params["decoder"], fcs.to(dd), cfg.decoder)
    return out.float()


def stylize_with_style_stream(params: dict, content: torch.Tensor, stream,
                              cfg: ModelConfig) -> torch.Tensor:
    """Stylize a content batch against one style stream; a batch-1 stream
    serves any content batch."""
    fc = encode_features(params, content, cfg)
    return stylize_from_features_with_stream(params, fc, stream, cfg)


def make_stylize_fn(cfg: ModelConfig, k: int = 1,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Callable[..., torch.Tensor]:
    """Zero-shot stylization closure: (params, content, style) -> RGB on
    ``device``. Inputs may be numpy arrays or tensors; params must already
    be on ``device``."""
    device = torch.device(device)

    def stylize(params, content, style):
        with torch.inference_mode():
            return master_apply(params, torch.as_tensor(content, device=device),
                                torch.as_tensor(style, device=device), cfg,
                                k=k)

    return stylize


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """NHWC [0, 1] RGB -> ImageNet-normalized (reference: train.py:418-424)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def imagenet_denormalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return x * std + mean
