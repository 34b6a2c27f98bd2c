"""Weight conversion: PyTorch state dicts -> the port's parameter trees
(JAX counterpart: utils/convert.py). Only what the trainer's
``--vgg_weights`` needs is here: reading a state dict from a file, and the
torchvision VGG19 (or VGG19-BN) features for the loss, batch norm folded
into the conv before it (exact in eval mode). The conversions of the Swin,
the style transformer and the decoder are not ported yet.

Layout: a torch Conv2d weight (out, in, kh, kw) becomes an HWIO kernel
(kh, kw, in, out), as in the JAX package.
"""

from __future__ import annotations

import pickle
from typing import Dict, Union

import numpy as np
import torch

from mastermetastyletransfer_tpu_torch.losses.vgg import VGG19_LAYER_PLAN


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's state dict as numpy arrays, read on the CPU;
    weights only where the file allows it (a pickled module otherwise, as
    the JAX package reads it: load only files you trust)."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


_VGG19_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28]
_VGG19_BN_CONV_IDX = [0, 3, 7, 10, 14, 17, 20, 23, 27, 30, 33, 36, 40]


def convert_vgg19(sd: Dict[str, np.ndarray], use_batchnorm: bool = False,
                  eps: float = 1e-5,
                  device: Union[str, torch.device] = "cpu") -> dict:
    """torch vgg19(_bn).features state dict -> the VGG19 loss tree
    ({"conv0": {"kernel", "bias"}, ...}, float32 on ``device``). Keys may
    carry a "features." prefix (a whole model's dict) or be bare indices
    (the cut Sequential). Batch norm (eval mode) folds into the conv before
    it, in float64, as in the JAX package."""
    if any(k.startswith("features.") for k in sd):
        sd = {k[len("features."):]: v for k, v in sd.items()
              if k.startswith("features.")}
    idxs = _VGG19_BN_CONV_IDX if use_batchnorm else _VGG19_CONV_IDX
    n_convs = sum(1 for sl in VGG19_LAYER_PLAN for kind, _, _ in sl
                  if kind == "C")
    params = {}
    for i in range(n_convs):
        ci = idxs[i]
        w = sd[f"{ci}.weight"].astype(np.float64)
        b = sd[f"{ci}.bias"].astype(np.float64)
        if use_batchnorm:
            gamma = sd[f"{ci + 1}.weight"].astype(np.float64)
            beta = sd[f"{ci + 1}.bias"].astype(np.float64)
            mean = sd[f"{ci + 1}.running_mean"].astype(np.float64)
            var = sd[f"{ci + 1}.running_var"].astype(np.float64)
            scale = gamma / np.sqrt(var + eps)
            w = w * scale[:, None, None, None]
            b = (b - mean) * scale + beta
        params[f"conv{i}"] = {
            "kernel": torch.from_numpy(np.ascontiguousarray(
                w.transpose(2, 3, 1, 0), dtype=np.float32)).to(device),
            "bias": torch.from_numpy(b.astype(np.float32)).to(device)}
    return params
