"""A Swin stage's two blocks in one kernel (JAX counterpart: the Pallas kernel
K11 ``fused_window_block_pair_rows`` in ops/pallas_attention.py, behind
``MMST_BLOCK_PAIR=1``).

``window_block_pair_rows`` takes the window-padded image (B, Hp, Wp, C) and
returns block1(block0(x)): block 0 unshifted, block 1 shifted by (sh, sw),
each with its validity mask, block 1 with the shift mask, in the plain
(un-rolled) frame as K1's row entry gives (the JAX kernel returns block 1's
rolled frame and its caller un-rolls). The kernel is csrc/block_pair.cu,
whose windows run K1's per-window bodies: at bfloat16, where ``pair_plan``
(K1's ``block_plan`` for the rows entry) says so, the tensor-core body in
K1's form for that width, block 1 reading block 0's output through L2
only; at float32 the scalar body.

The wrapper runs the kernel for a CUDA tensor and the plain PyTorch version
below for a CPU tensor; any other device raises. The plain version is K1's
plain version applied twice, block 0's output rounded to the input type as
the kernels round it. The kernel has no backward (neither has the JAX
kernel): where autograd would record the call it raises
(ops/window_block.py:refuse_grad).

``LAUNCHES`` counts kernel launches; the wrapper adds one only where it
launches its kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from mastermetastyletransfer_tpu_torch.ops import _build
from mastermetastyletransfer_tpu_torch.ops.window_block import (
    MAX_SMEM_BYTES, BlockPlan, BlockWeights, TcPlan, _need, _on_cuda,
    block_plan, refuse_grad, window_block_rows_plain,
)

LAUNCHES = {"window_block_pair_rows": 0}


def window_block_pair_rows_plain(
        x: torch.Tensor, w0: BlockWeights, w1: BlockWeights, *, heads: int,
        window: Tuple[int, int], shift: Tuple[int, int],
        mask1: Optional[torch.Tensor] = None,
        padmask0: Optional[torch.Tensor] = None,
        padmask1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K11's function: K1's plain row version with shift (0, 0) and block
    0's weights, then with ``shift`` and block 1's; (B, Hp, Wp, C) in and
    out, the plain frame."""
    y0 = window_block_rows_plain(x, w0, heads=heads, window=window,
                                 shift=(0, 0), padmask=padmask0)
    return window_block_rows_plain(y0, w1, heads=heads, window=window,
                                   shift=shift, mask=mask1, padmask=padmask1)


_BLOCK_PTRS = ("wqkv", "bqkv", "wp", "bp", "rel_bias", "mask", "padmask",
               "n1s", "n1b", "n2s", "n2b", "w1", "b1", "w2", "b2")


class PairBlock(ctypes.Structure):
    """The C struct ``PairBlock`` of csrc/block_pair.cu."""
    _fields_ = [(f, ctypes.c_void_p) for f in _BLOCK_PTRS]


class PairArgs(ctypes.Structure):
    """The C struct ``PairArgs`` of csrc/block_pair.cu, field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("x", "out", "y0", "sync")]
                + [("blk", PairBlock * 2), ("scale", ctypes.c_double)]
                + [(f, ctypes.c_longlong) for f in (
                    "dtype", "B", "Hp", "Wp", "C", "heads", "hidden", "wh",
                    "ww", "sh", "sw")]
                + [("plan", TcPlan)])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("block_pair")
    lib.mmst_window_block_pair_rows.argtypes = [ctypes.POINTER(PairArgs),
                                                ctypes.c_void_p]
    lib.mmst_window_block_pair_rows.restype = ctypes.c_int
    lib.mmst_window_block_pair_smem_bytes.argtypes = [ctypes.c_longlong] * 4
    lib.mmst_window_block_pair_smem_bytes.restype = ctypes.c_longlong
    lib.mmst_window_block_pair_attributes.argtypes = (
        [ctypes.c_longlong] * 3 + [ctypes.POINTER(ctypes.c_longlong)] * 3)
    lib.mmst_window_block_pair_attributes.restype = ctypes.c_int
    lib.mmst_pair_load_probe.argtypes = (
        [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 5
        + [ctypes.c_longlong, ctypes.c_void_p])
    lib.mmst_pair_load_probe.restype = ctypes.c_int
    return lib


def pair_plan(n: int, c: int, heads: int, hidden: int,
              dtype: torch.dtype) -> BlockPlan:
    """The body each window of one K11 call runs: K1's plan for the rows
    entry at the same shape (ops/window_block.py:block_plan), so that each
    stage takes K1's form -- two blocks of 8 warps an SM at C <= 128, one
    of 16 above -- at bfloat16, and the scalar body at float32."""
    return block_plan("window_block_rows", n, c, heads, hidden, dtype)


def smem_bytes(plan: BlockPlan, n: int, c: int, heads: int,
               dtype: torch.dtype) -> int:
    """Dynamic shared memory one thread block of the call's body takes:
    the plan's (the tensor-core layout, ops/window_block.py:tc_layout), or
    the scalar body's (K1's scalar layout)."""
    if plan.body == "tc":
        return plan.smem_bytes
    return _lib().mmst_window_block_pair_smem_bytes(
        n, c, heads, torch.finfo(dtype).bits // 8)


def kernel_attributes(plan: BlockPlan, dtype: torch.dtype, dh: int
                      ) -> Tuple[int, int, int]:
    """(static shared memory bytes per block, dynamic shared memory opted
    in so far on this device, registers per thread) of the kernel ``plan``
    runs: the tensor-core kernel of head dim dh in the plan's form, or the
    scalar kernel at ``dtype``."""
    vals = [ctypes.c_longlong() for _ in range(3)]
    err = _lib().mmst_window_block_pair_attributes(
        TcPlan.of(plan).body, int(dtype == torch.bfloat16), dh,
        *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes: CUDA error {err}")
    return tuple(v.value for v in vals)


# The token loads the probe compares (csrc/window_tc.cuh, load16): a plain
# load (K1's and K2's), through L2 only (K11's block 1), the read-only path.
LOAD_POLICIES = {"plain": 0, "l2": 1, "read_only": 2}


def load_probe(y: torch.Tensor, fresh: torch.Tensor, policy: str,
               fence: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run csrc/block_pair.cu's load probe on the card: one thread block
    reads the bf16 tensor y (a whole number of 16-byte pieces) through the
    policy's load, publishes, waits on a flag as K11's block 1 waits, and
    reads it again, while another thread block, after the first reading,
    overwrites y with ``fresh`` and publishes as K11's block 0 does. With
    ``fence`` off the reading block fences neither before publishing nor
    after waiting. Returns (first reading, second reading), each shaped as
    y; y ends holding fresh."""
    if y.device.type != "cuda" or y.dtype != torch.bfloat16:
        raise ValueError("the probe runs on a bfloat16 CUDA tensor")
    _need("fresh", fresh, y.shape, y.dtype, y.device)
    _need("y", y, y.shape, y.dtype, y.device)
    if y.numel() % 8:
        raise ValueError("y must hold whole 16-byte pieces")
    first, second = torch.empty_like(y), torch.empty_like(y)
    flags = torch.zeros(2, dtype=torch.int32, device=y.device)
    err = _lib().mmst_pair_load_probe(
        LOAD_POLICIES[policy], int(fence), y.data_ptr(), fresh.data_ptr(),
        first.data_ptr(), second.data_ptr(), flags.data_ptr(),
        y.numel() // 8, torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"load probe: CUDA error {err} at launch")
    return first, second


def _check_block(name: str, w: BlockWeights, c: int, heads: int, n: int,
                 hidden: int, dtype: torch.dtype, dev: torch.device) -> None:
    f32 = torch.float32
    for field, shape, t in (
            ("wqkv", (c, 3 * c), dtype), ("bqkv", (3 * c,), f32),
            ("wp", (c, c), dtype), ("bp", (c,), f32),
            ("rel_bias", (heads, n, n), f32),
            ("w1", (c, hidden), dtype), ("b1", (hidden,), f32),
            ("w2", (hidden, c), dtype), ("b2", (c,), f32)):
        _need(f"{name}.{field}", getattr(w, field), shape, t, dev)
    for field in ("n1s", "n1b", "n2s", "n2b"):
        if getattr(w, field) is not None:
            _need(f"{name}.{field}", getattr(w, field), (c,), f32, dev)
    if ((w.n1s is None) != (w.n1b is None)
            or (w.n2s is None) != (w.n2b is None)):
        raise ValueError(f"{name}: a norm needs both its scale and its bias")


def window_block_pair_rows(x: torch.Tensor, w0: BlockWeights,
                           w1: BlockWeights, *, heads: int,
                           window: Tuple[int, int], shift: Tuple[int, int],
                           mask1: Optional[torch.Tensor] = None,
                           padmask0: Optional[torch.Tensor] = None,
                           padmask1: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K11: block1(block0(x)) on a window-padded image (B, Hp, Wp, C), the
    plain frame. mask1 (nW, N, N) and padmask1 (nW, N) are in the window
    order of the grid rolled by ``shift``, padmask0 of the plain grid, as
    ops/windows.py builds them."""
    if not _on_cuda(x):
        return window_block_pair_rows_plain(
            x, w0, w1, heads=heads, window=window, shift=shift, mask1=mask1,
            padmask0=padmask0, padmask1=padmask1)
    refuse_grad("window_block_pair_rows", x, mask1, padmask0, padmask1,
                *w0, *w1)
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise TypeError(f"x is {x.dtype} of shape {tuple(x.shape)}; the "
                        "kernel takes a (B, Hp, Wp, C) float32 or bfloat16 "
                        "image")
    b, hp, wp, c = x.shape
    (wh, ww), (sh, sw) = window, shift
    if hp % wh or wp % ww or not (0 <= sh < wh and 0 <= sw < ww):
        raise ValueError(f"image {hp}x{wp} is not padded to window {window},"
                         f" or shift {shift} is outside it")
    n, nw = wh * ww, (hp // wh) * (wp // ww)
    hidden = w0.w1.shape[1]
    if c % heads or hidden % c or w1.w1.shape[1] != hidden:
        raise ValueError(f"C={c} must divide by heads={heads}, and both "
                         f"blocks' MLP width {hidden} by C")
    dev = x.device
    _need("x", x, x.shape, x.dtype, dev)
    for name, w in (("w0", w0), ("w1", w1)):
        _check_block(name, w, c, heads, n, hidden, x.dtype, dev)
    if mask1 is not None:
        _need("mask1", mask1, (nw, n, n), torch.float32, dev)
    for name, pm in (("padmask0", padmask0), ("padmask1", padmask1)):
        if pm is not None:
            _need(name, pm, (nw, n), torch.float32, dev)
    plan = pair_plan(n, c, heads, hidden, x.dtype)
    smem = smem_bytes(plan, n, c, heads, x.dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"N={n}, C={c} needs {smem} bytes of shared memory "
                         f"per block, over the {MAX_SMEM_BYTES} available")

    out = torch.empty_like(x)
    y0 = torch.empty_like(x)
    # the ticket counter and one ready flag per (image, window), zeroed on
    # the launch's stream
    sync = torch.zeros(1 + b * nw, dtype=torch.int32, device=dev)

    def ptrs(w: BlockWeights, mask, padmask):
        vals = {**w._asdict(), "mask": mask, "padmask": padmask}
        return PairBlock(**{f: (vals[f].data_ptr() if vals[f] is not None
                                else None) for f in _BLOCK_PTRS})

    args = PairArgs(
        x=x.data_ptr(), out=out.data_ptr(), y0=y0.data_ptr(),
        sync=sync.data_ptr(),
        blk=(PairBlock * 2)(ptrs(w0, None, padmask0),
                            ptrs(w1, mask1, padmask1)),
        scale=(c // heads) ** -0.5,
        dtype=1 if x.dtype == torch.bfloat16 else 0, B=b, Hp=hp, Wp=wp,
        C=c, heads=heads, hidden=hidden, wh=wh, ww=ww, sh=sh, sw=sw,
        plan=TcPlan.of(plan))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().mmst_window_block_pair_rows(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"window_block_pair_rows: CUDA error {err} at "
                           "launch")
    LAUNCHES["window_block_pair_rows"] += 1
    return out
