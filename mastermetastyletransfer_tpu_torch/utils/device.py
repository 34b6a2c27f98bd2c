"""The device of a run, as the entry points take it (``--device``)."""

from __future__ import annotations

from typing import Union

import torch


def require_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch.device; a CUDA device that torch cannot see
    raises (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda asked for, and torch sees no CUDA "
                           "device (pass --device cpu to run on the CPU)")
    return device
