"""Swin patch embedding with its LayerNorm as one kernel (JAX counterpart:
the Pallas kernel K13 ``pallas_patch_embed`` in ops/pallas_conv.py).

``patch_embed(images, kernel, bias, ln_scale, ln_bias)``: images (B, H, W,
Cin) and a (ps, ps, Cin, E) HWIO kernel -> (B, H/ps, W/ps, E), the ps x ps
stride-ps conv plus bias in f32, then LayerNorm over E in f32 where
``ln_scale`` is given, rounded once to the images' type. As in the JAX
package, no model path calls it: models/swin.py embeds patches as a
space-to-depth GEMM or a strided conv (``SwinConfig.patch_embed_impl``).
The kernel is csrc/patch_embed.cu.

The wrapper runs the kernel for a CUDA tensor and the plain PyTorch version
below for a CPU tensor; any other device raises. The kernel has no backward
(neither has the JAX kernel): where autograd would record the call it
raises (ops/window_block.py:refuse_grad).

``LAUNCHES`` counts kernel launches; the wrapper adds one only where it
launches its kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from mastermetastyletransfer_tpu_torch.ops import _build
from mastermetastyletransfer_tpu_torch.ops.window_block import (
    MAX_SMEM_BYTES, _need, _on_cuda, refuse_grad,
)

LAUNCHES = {"patch_embed": 0}


def patch_embed_plain(images: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor,
                      ln_scale: Optional[torch.Tensor] = None,
                      ln_bias: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """K13's function: the rows below the last whole patch row are dropped,
    as the JAX kernel's blocks drop them; products of T-typed operands
    summed in f32, the f32 bias, the f32 LayerNorm, one rounding."""
    b, h, w, cin = images.shape
    ps, e = kernel.shape[0], kernel.shape[-1]
    hc, wc = h // ps, w // ps
    t = images.dtype
    x = images[:, :hc * ps].reshape(b, hc, ps, wc, ps, cin)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hc, wc, ps * ps * cin)
    y = x.float() @ kernel.to(t).float().reshape(ps * ps * cin, e)
    y = y + bias.float()
    if ln_scale is not None:
        mean = y.mean(-1, keepdim=True)
        var = ((y - mean) ** 2).mean(-1, keepdim=True)
        y = ((y - mean) * torch.rsqrt(var + 1e-5) * ln_scale.float()
             + ln_bias.float())
    return y.to(t)


class PatchArgs(ctypes.Structure):
    """The C struct ``PatchArgs`` of csrc/patch_embed.cu, field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("x", "w", "bias", "ln_s",
                                                "ln_b", "out")]
                + [(f, ctypes.c_longlong) for f in ("dtype", "B", "H", "W",
                                                    "Cin", "E", "ps")])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("patch_embed")
    lib.mmst_patch_embed.argtypes = [ctypes.POINTER(PatchArgs),
                                     ctypes.c_void_p]
    lib.mmst_patch_embed.restype = ctypes.c_int
    lib.mmst_patch_embed_smem_bytes.argtypes = [ctypes.c_longlong] * 2
    lib.mmst_patch_embed_smem_bytes.restype = ctypes.c_longlong
    return lib


def smem_bytes(ps: int, cin: int, e: int) -> int:
    """Shared memory of one thread block of the kernel."""
    return _lib().mmst_patch_embed_smem_bytes(ps * ps * cin, e)


def patch_embed(images: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor, ln_scale: Optional[torch.Tensor] = None,
                ln_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K13: images (B, H, W, Cin), kernel (ps, ps, Cin, E) HWIO, bias (E,)
    [, LayerNorm scale and bias (E,)] -> (B, H/ps, W/ps, E) in the images'
    type."""
    if not _on_cuda(images):
        return patch_embed_plain(images, kernel, bias, ln_scale, ln_bias)
    refuse_grad("patch_embed", images, kernel, bias, ln_scale, ln_bias)
    if images.dtype not in (torch.float32, torch.bfloat16) or \
            images.dim() != 4:
        raise TypeError(f"images are {images.dtype} of shape "
                        f"{tuple(images.shape)}; the kernel takes (B, H, W, "
                        "Cin) float32 or bfloat16")
    b, h, w, cin = images.shape
    ps, e = kernel.shape[0], kernel.shape[-1]
    if tuple(kernel.shape) != (ps, ps, cin, e) or w % ps or h < ps:
        raise ValueError(f"kernel {tuple(kernel.shape)} is not (ps, ps, "
                         f"{cin}, E), or the width {w} is not a multiple "
                         f"of ps, or the height {h} below it")
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("the LayerNorm needs both its scale and its bias")
    dev = images.device
    _need("images", images, images.shape, images.dtype, dev)
    wk = kernel.to(images.dtype).reshape(ps * ps * cin, e).contiguous()
    vecs = [None if v is None else v.float().contiguous()
            for v in (bias, ln_scale, ln_bias)]
    for name, v in zip(("bias", "ln_scale", "ln_bias"), vecs):
        if v is not None:
            _need(name, v, (e,), torch.float32, dev)
    _need("kernel", wk, (ps * ps * cin, e), images.dtype, dev)
    smem = smem_bytes(ps, cin, e)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ps={ps}, Cin={cin}, E={e} needs {smem} bytes of "
                         f"shared memory per block, over the "
                         f"{MAX_SMEM_BYTES} available")
    out = torch.empty((b, h // ps, w // ps, e), dtype=images.dtype,
                      device=dev)
    args = PatchArgs(
        x=images.data_ptr(), w=wk.data_ptr(), bias=vecs[0].data_ptr(),
        ln_s=None if vecs[1] is None else vecs[1].data_ptr(),
        ln_b=None if vecs[2] is None else vecs[2].data_ptr(),
        out=out.data_ptr(), dtype=int(images.dtype == torch.bfloat16), B=b,
        H=h, W=w, Cin=cin, E=e, ps=ps)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().mmst_patch_embed(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"patch_embed: CUDA error {err} at launch")
    LAUNCHES["patch_embed"] += 1
    return out
