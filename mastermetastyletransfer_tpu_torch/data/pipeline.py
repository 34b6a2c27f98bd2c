"""The device half of the data pipeline (JAX counterpart:
data/pipeline.py:213-258): a staged uint8 batch becomes float crops in
[0, 1] on its device, and one style image is repeated to the content
batch; ``device_preprocess_pair`` makes a training step's two inputs so,
by the configuration, as the JAX trainer does. The host half (image
folders, samplers, the prefetching loader) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mastermetastyletransfer_tpu_torch.config import ExperimentConfig


def device_preprocess_batch(batch_u8: torch.Tensor, crop_to: int, *,
                            random_crop: bool,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, crop_to, crop_to, C) float32 in [0, 1],
    on the batch's device: RandomCrop or CenterCrop(crop_to) + ToTensor
    (reference: train.py:222-245). A random crop draws each image's row
    offsets, then its column offsets, in [0, H - crop_to] and
    [0, W - crop_to] from ``generator`` (on the generator's device); the
    centre crop starts at ((H - crop_to) // 2, (W - crop_to) // 2). ImageNet
    normalization comes later, by the flags (train/step.py)."""
    b, h, w, _ = batch_u8.shape
    x = batch_u8.to(torch.float32) / 255.0
    if crop_to > h or crop_to > w:
        raise ValueError(f"crop {crop_to} larger than staged size {h}x{w}")
    if crop_to == h and crop_to == w:
        return x
    if random_crop:
        if generator is None:
            raise ValueError("random_crop requires a generator")
        oy, ox = (torch.randint(0, n - crop_to + 1, (b,), generator=generator,
                                device=generator.device).to(x.device)
                  for n in (h, w))
    else:
        oy = torch.full((b,), (h - crop_to) // 2, device=x.device)
        ox = torch.full((b,), (w - crop_to) // 2, device=x.device)
    span = torch.arange(crop_to, device=x.device)
    rows = (oy[:, None] + span)[:, :, None]
    cols = (ox[:, None] + span)[:, None, :]
    return x[torch.arange(b, device=x.device)[:, None, None], rows, cols]


def repeat_style_to_batch(style_one, batch_size: int) -> torch.Tensor:
    """One style image ((H, W, C) or (1, H, W, C), numpy or a tensor) ->
    repeated to the content batch size (reference: train.py:411-416)."""
    style_one = torch.as_tensor(style_one)
    if style_one.ndim == 3:
        style_one = style_one[None]
    return style_one[:1].repeat(batch_size, 1, 1, 1)


def device_preprocess_pair(cfg: ExperimentConfig, content_u8: torch.Tensor,
                           style_u8: torch.Tensor, *,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A training step's (content, style) from staged uint8 batches, as the
    JAX trainer makes them (its train/trainer.py:174-186): both cropped to
    ``cfg.data.crop_to``, at random per image when
    ``cfg.data.use_random_crop``, but the styles always centred in fast
    adaptation (reference: train_only_inner_loop.py:280-286); the first
    style repeated to ``cfg.data.batch_size_content``. Random crops draw
    the contents' offsets, then the styles', from ``generator``."""
    data = cfg.data
    content = device_preprocess_batch(content_u8, data.crop_to,
                                      random_crop=data.use_random_crop,
                                      generator=generator)
    style = device_preprocess_batch(
        style_u8, data.crop_to, generator=generator,
        random_crop=data.use_random_crop
        and cfg.train.mode != "fast_adaptation")
    return content, repeat_style_to_batch(style, data.batch_size_content)
