"""Static window geometry: relative-position index and bias, the shifted-
window attention mask, the pad-token validity mask, partition/merge and
padding (JAX counterpart: ops/windows.py; reference:
codes/style_transformer.py:21-28, :77-150, :227-239).

Masks and indices are built with numpy from static shapes and cached.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(N*N,) int index into a ((2wh-1)*(2ww-1), heads) bias table."""
    coords_h, coords_w = np.meshgrid(np.arange(wh), np.arange(ww),
                                     indexing="ij")
    coords = np.stack([coords_h.reshape(-1), coords_w.reshape(-1)])
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).reshape(-1)


def relative_position_bias(table: torch.Tensor, wh: int,
                           ww: int) -> torch.Tensor:
    """table ((2wh-1)*(2ww-1), heads) -> bias (heads, N, N)."""
    n = wh * ww
    idx = torch.from_numpy(relative_position_index(wh, ww)).to(table.device)
    return table[idx].reshape(n, n, -1).permute(2, 0, 1)


@lru_cache(maxsize=None)
def shift_attention_mask(pad_h: int, pad_w: int, wh: int, ww: int,
                         sh: int, sw: int) -> np.ndarray:
    """(nW, N, N) float32 mask with entries in {0, -100}: token pairs that
    come from different regions of the rolled grid may not attend
    (reference: codes/style_transformer.py:136-147)."""
    region = np.zeros((pad_h, pad_w), dtype=np.int32)
    h_slices = ((0, pad_h - wh), (pad_h - wh, pad_h - sh), (pad_h - sh, pad_h))
    w_slices = ((0, pad_w - ww), (pad_w - ww, pad_w - sw), (pad_w - sw, pad_w))
    count = 0
    for h0, h1 in h_slices:
        for w0, w1 in w_slices:
            region[h0:h1, w0:w1] = count
            count += 1
    region = region.reshape(pad_h // wh, wh, pad_w // ww, ww)
    region = region.transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    diff = region[:, None, :] - region[:, :, None]
    return np.where(diff != 0, np.float32(-100.0), np.float32(0.0))


@lru_cache(maxsize=None)
def valid_token_mask(h: int, w: int, pad_h: int, pad_w: int, wh: int,
                     ww: int, sh: int, sw: int) -> np.ndarray:
    """(nW, N) float32: 1 for tokens that come from the valid (h, w) corner
    of the padded grid, after the roll by (-sh, -sw) and partition."""
    m = np.zeros((pad_h, pad_w), np.float32)
    m[:h, :w] = 1.0
    if sh or sw:
        m = np.roll(m, (-sh, -sw), axis=(0, 1))
    m = m.reshape(pad_h // wh, wh, pad_w // ww, ww).transpose(0, 2, 1, 3)
    return m.reshape(-1, wh * ww)


def window_partition(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, wh*ww, C); H, W multiples of the window."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // wh) * (w // ww), wh * ww, c)


def window_merge(x: torch.Tensor, b: int, h: int, w: int, wh: int,
                 ww: int) -> torch.Tensor:
    """Inverse of window_partition: (B*nW, wh*ww, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    x = x.reshape(b, h // wh, w // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def pad_to_windows(x: torch.Tensor, wh: int,
                   ww: int) -> Tuple[torch.Tensor, int, int]:
    """Zero-pad H, W (bottom/right) to window multiples (reference:
    codes/style_transformer.py:77-87). Returns (x, pad_h, pad_w)."""
    _, h, w, _ = x.shape
    pad_b = (-h) % wh
    pad_r = (-w) % ww
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    return x, h + pad_b, w + pad_r


def effective_shift(pad_h: int, pad_w: int, window: Tuple[int, int],
                    shift: Tuple[int, int]) -> Tuple[int, int]:
    """No shift along an axis the window covers whole (reference:
    codes/style_transformer.py:91-94)."""
    sh = 0 if window[0] >= pad_h else shift[0]
    sw = 0 if window[1] >= pad_w else shift[1]
    return sh, sw
