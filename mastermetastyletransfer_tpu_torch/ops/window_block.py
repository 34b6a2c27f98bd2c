"""The whole Swin block kernel (JAX counterparts: the Pallas kernels K1
``fused_window_block_rows`` and K2 ``fused_window_block`` in
ops/pallas_attention.py, which both compute ``_block_compute``).

Two entries over one CUDA computation (csrc/window_block.cu):

* ``window_block_rows``: x is the window-padded NHWC image (B, Hp, Wp, C);
  the cyclic shift is folded into the kernel's index arithmetic and the
  output comes back in the plain (un-rolled) frame;
* ``window_block_windows``: x is partitioned, (B, nW, N, C).

Two bodies compute the block: both entries at bfloat16 run the tensor-core
body (csrc/window_tc.cuh) where ``block_plan`` below says so -- K1 at the
Swin stages of swin_T/S/B, K2 at the style transformer's Key block (no
norms) and self block (both); K11 (ops/block_pair.py) runs it per window
on the same plan -- and every other call (f32) the scalar body.
``block_plan`` and ``tile_schedule`` give the tensor-core body's tiling,
which tests/test_torch_window_tc_plan.py replays in torch on the CPU.

Each wrapper runs its kernel for a CUDA tensor and the plain PyTorch
version below for a CPU tensor; any other device raises. The plain version
is the yardstick the kernel is held to: it rounds to the input type at the
same points as the kernel, and it computes GELU with the exact erf (the JAX
kernel uses the Abramowitz-Stegun erf, |err| <= 1.5e-7).

``LAUNCHES`` counts kernel launches per entry; a wrapper adds one only
where it launches its kernel.

The block kernel has no backward (neither has the JAX kernel): where
autograd would record the call, its CUDA branch raises instead of cutting
the output from the graph (``refuse_grad``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from mastermetastyletransfer_tpu_torch.ops import _build
from mastermetastyletransfer_tpu_torch.ops.windows import (
    relative_position_bias, window_merge, window_partition,
)

LAUNCHES = {"window_block_rows": 0, "window_block_windows": 0}

# Shared memory one thread block may use on an H100 (dynamic, opted in).
MAX_SMEM_BYTES = 232448


class BlockWeights(NamedTuple):
    """A block's parameters as the kernel takes them: the three matrices of
    the products in the compute type, everything else float32. Norms are
    None for a norm-free block."""
    wqkv: torch.Tensor      # (C, 3C) = [wq | wk | wv]
    bqkv: torch.Tensor      # (3C,)
    wp: torch.Tensor        # (C, C)
    bp: torch.Tensor        # (C,)
    rel_bias: torch.Tensor  # (heads, N, N)
    n1s: Optional[torch.Tensor]
    n1b: Optional[torch.Tensor]
    n2s: Optional[torch.Tensor]
    n2b: Optional[torch.Tensor]
    w1: torch.Tensor        # (C, hidden)
    b1: torch.Tensor        # (hidden,)
    w2: torch.Tensor        # (hidden, C)
    b2: torch.Tensor        # (C,)


def _mat(p: dict, dtype: torch.dtype) -> torch.Tensor:
    """A linear layer's kernel in the compute type."""
    return p["kernel"].to(dtype).contiguous()


def _vec(p: dict, n: int) -> torch.Tensor:
    """A linear layer's bias in float32 (zeros where it has none)."""
    if "bias" in p:
        return p["bias"].float().contiguous()
    return torch.zeros(n, dtype=torch.float32, device=p["kernel"].device)


# block_weights' cache, as ops/conv.py's _derived: kept for as long as the
# block's first tensor lives (a weak key), per (each source tensor's
# data_ptr and _version, the window, dtype and norms), so that an in-place
# update of any source (an optimizer step) misses and rebuilds. Services of
# several k share one params tree from their own threads.
_WEIGHTS: WeakIdKeyDictionary = WeakIdKeyDictionary()
_WEIGHTS_LOCK = threading.Lock()


def _sources(block_params: dict) -> List[torch.Tensor]:
    """Every tensor of a block's param dict, in a fixed order."""
    out = []
    for name in sorted(block_params):
        v = block_params[name]
        if isinstance(v, dict):
            out.extend(_sources(v))
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def block_weights(block_params: dict, window: Tuple[int, int],
                  dtype: torch.dtype, use_norm: bool, *,
                  norm2: Optional[bool] = None) -> BlockWeights:
    """Prepare a block's param dict ({"attn", "mlp", "norm1", "norm2"}, the
    JAX layout) for the kernel. ``use_norm`` takes LN1, and LN2 too unless
    ``norm2`` says otherwise (the style encoder's Key block has an optional
    LN1 and never an LN2). Cached per the source tensors, the dtype and the
    options (``_WEIGHTS``); built afresh, never kept, while a source takes
    part in autograd. A kept result is built outside inference mode, so
    that a training step can use what a served call kept."""
    srcs = _sources(block_params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in srcs):
        return _block_weights(block_params, window, dtype, use_norm, norm2)
    key = (tuple((t.data_ptr(), 0 if t.is_inference() else t._version)
                 for t in srcs), tuple(window), dtype, use_norm, norm2)
    with _WEIGHTS_LOCK:
        per_block = _WEIGHTS.setdefault(srcs[0], {})
        hit = per_block.get(key)
        if hit is not None and all(r() is t for r, t in zip(hit[0], srcs)):
            return hit[1]
        with torch.inference_mode(False):
            w = _block_weights(block_params, window, dtype, use_norm, norm2)
        for stale in [k for k in per_block if k[1:] == key[1:]]:
            del per_block[stale]    # an older version of these weights
        per_block[key] = (tuple(weakref.ref(t) for t in srcs), w)
        return w


def _block_weights(block_params: dict, window: Tuple[int, int],
                   dtype: torch.dtype, use_norm: bool,
                   norm2: Optional[bool]) -> BlockWeights:
    attn, mlp = block_params["attn"], block_params["mlp"]
    c = attn["wq"]["kernel"].shape[0]
    use = {"norm1": use_norm, "norm2": use_norm if norm2 is None else norm2}

    def norm(name, part):
        return (block_params[name][part].float().contiguous()
                if use[name] else None)

    hidden = mlp["fc1"]["kernel"].shape[1]
    return BlockWeights(
        wqkv=torch.cat([_mat(attn[k], dtype) for k in ("wq", "wk", "wv")], 1),
        bqkv=torch.cat([_vec(attn[k], c) for k in ("wq", "wk", "wv")]),
        wp=_mat(attn["proj"], dtype), bp=_vec(attn["proj"], c),
        rel_bias=relative_position_bias(
            attn["rel_bias_table"].float(), *window).contiguous(),
        n1s=norm("norm1", "scale"), n1b=norm("norm1", "bias"),
        n2s=norm("norm2", "scale"), n2b=norm("norm2", "bias"),
        w1=_mat(mlp["fc1"], dtype), b1=_vec(mlp["fc1"], hidden),
        w2=_mat(mlp["fc2"], dtype), b2=_vec(mlp["fc2"], c))


# ---------------------------------------------------------------------------
# The tensor-core body's plan (csrc/window_tc.cuh)
# ---------------------------------------------------------------------------

TC_ROWS, TC_PANEL = 64, 128
SMEM_PER_SM = 233472   # an H100 SM's shared memory; 1 KB of it per block
# The tensor-core body's forms, in order of preference: (blocks an SM,
# weight rows per ring tile, ring tiles). Two blocks of 8 warps an SM where
# C <= 128 fits (the head outputs then take the normed tile's place), else
# one block of 16 warps.
TC_FORMS = ((2, 32, 2), (1, 64, 3), (1, 32, 3))


class BlockPlan(NamedTuple):
    """How one call's block runs; built by ``block_plan`` and passed to the
    kernel (``TcPlan``). ``body`` "tc": the tensor-core body, one block
    per window, ``blocks_per_sm`` of them an SM (of 8 warps at two, of 16
    at one), the window's
    tokens padded to ``rows`` (four m16 tiles; pad keys -inf before the
    softmax, pad queries never stored), each product in panels of up to
    ``panel`` output columns, the weights streamed as tiles of ``kp`` rows
    through a ring of ``stages`` (``tile_schedule``), ``head_groups`` the
    (first column, width) panels of C whose heads' q, k and v it holds at
    once, ``smem_bytes`` its dynamic shared memory (``tc_layout``).
    "scalar": the scalar body, the other fields 0."""
    body: str
    rows: int
    panel: int
    kp: int
    stages: int
    blocks_per_sm: int
    smem_bytes: int
    head_groups: Tuple[Tuple[int, int], ...]


def _align16(b: int) -> int:
    return (b + 15) & ~15


def tc_layout(n: int, c: int, kp: int, stages: int, ob_in_ln: bool) -> dict:
    """Byte offsets and total of the tensor-core body's shared memory
    (csrc/window_tc.cuh:tc_block_layout): the f32 residual stream (n rows),
    the normed tile and the head outputs (64 rows each; with ob_in_ln one
    tile for both), a head group's q, k and v (three 64 x 128 tiles), the
    ring, the row statistics and the token offsets; bf16 rows padded by 16
    bytes."""
    sizes = (("xs", 4 * n * (c + 4)), ("ln", 2 * TC_ROWS * (c + 8)),
             ("ob", 0 if ob_in_ln else 2 * TC_ROWS * (c + 8)),
             ("qkv", 2 * 3 * TC_ROWS * (TC_PANEL + 8)),
             ("ring", 2 * stages * kp * (TC_PANEL + 8)),
             ("mean", 4 * TC_ROWS), ("rstd", 4 * TC_ROWS),
             ("toff", 8 * TC_ROWS))
    out, o = {}, 0
    for name, size in sizes:
        out[name] = out["ln"] if name == "ob" and ob_in_ln else o
        o = _align16(o + size)
    out["total"] = o
    return out


@functools.lru_cache(maxsize=None)
def block_plan(entry: str, n: int, c: int, heads: int, hidden: int,
               dtype: torch.dtype) -> BlockPlan:
    """The body one call runs: the tensor-core body for either entry at
    bfloat16 where N <= 64, C % 32 == 0, the head dim is 16, 32 or 64 and
    the MLP width a multiple of 128 (the Swin stages of swin_T/S/B, the
    style transformer's blocks at C = 256), in the
    first of TC_FORMS that C allows and whose shared memory fits that many
    blocks an SM (two where C <= 128: one head group, so that the head
    outputs may take the normed tile's place); the scalar body for every
    other call."""
    dh = c // heads if heads else 0
    if (entry in ("window_block_rows", "window_block_windows")
            and dtype == torch.bfloat16
            and 1 <= n <= TC_ROWS and c % 32 == 0 and dh * heads == c
            and dh in (16, 32, 64) and hidden >= TC_PANEL
            and hidden % TC_PANEL == 0):
        groups = tuple((c0, min(TC_PANEL, c - c0))
                       for c0 in range(0, c, TC_PANEL))
        for per_sm, kp, stages in TC_FORMS:
            if c % kp or (per_sm == 2 and c > TC_PANEL):
                continue
            smem = tc_layout(n, c, kp, stages, per_sm == 2)["total"]
            if smem <= min(MAX_SMEM_BYTES, SMEM_PER_SM // per_sm - 1024):
                return BlockPlan("tc", TC_ROWS, TC_PANEL, kp, stages,
                                 per_sm, smem, groups)
    return BlockPlan("scalar", 0, 0, 0, 0, 0, 0, ())


def tile_schedule(plan: BlockPlan, c: int, hidden: int
                  ) -> List[Tuple[str, int, int, int, int]]:
    """The weight tiles in the order the tensor-core body uses them, by the
    kernel's own arithmetic for tile t (csrc/window_tc.cuh, ``issue``):
    (matrix, first row, first column, rows, width). Per head group, its q,
    k and v panels over K = C; proj's panels over C; per 128-wide hidden
    chunk, fc1's panel over C and fc2's panels over the chunk."""
    kp, p = plan.kp, plan.panel
    nk, ng = c // kp, -(-c // p)
    out = []
    for t in range(3 * ng * nk + ng * nk):
        if t < 3 * ng * nk:
            gi, part, kt = t // (3 * nk), (t // nk) % 3, t % nk
            out.append(("wqkv", kt * kp, part * c + gi * p, kp,
                        min(p, c - gi * p)))
        else:
            pn, kt = divmod(t - 3 * ng * nk, nk)
            out.append(("wp", kt * kp, pn * p, kp, min(p, c - pn * p)))
    return out + mlp_tile_schedule(plan, c, hidden)


def mlp_tile_schedule(plan, c: int, hidden: int
                      ) -> List[Tuple[str, int, int, int, int]]:
    """The MLP's tiles, which K1's and K4's orders share and K10's forward
    takes alone (window_tc.cuh, MlpTiles; mlp_tc.cuh, FwdMlpTiles): per
    128-wide hidden chunk, fc1's panel over C and fc2's panels over the
    chunk. ``plan`` is a ``BlockPlan`` or an ``ln_mlp.MlpPlan``."""
    kp, p = plan.kp, plan.panel
    nk, ng, kpc = c // kp, -(-c // p), p // kp
    out = []
    for j in range(hidden // p):
        out += [("w1", r * kp, j * p, kp, p) for r in range(nk)]
        out += [("w2", j * p + kt * kp, pn * p, kp, min(p, c - pn * p))
                for pn in range(ng) for kt in range(kpc)]
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _ln(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
        eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * s + b


def attend(q: torch.Tensor, k: torch.Tensor, values, rel_bias: torch.Tensor,
           *, heads: int, mask: Optional[torch.Tensor] = None):
    """Window attention core of the kernels, one softmax per head shared by
    every value stream: q (already scaled), k and each v are (B, nW, N, C)
    in the compute type T; returns one (B, nW, N, C) head-output tensor in T
    per value stream. The softmax runs in f32; its numerators are rounded to
    T before the value product, and each head output is scaled by 1 / sum
    before its rounding, as the kernels do."""
    t = q.dtype
    b, nw, n, c = q.shape
    dh = c // heads

    def split_heads(z):
        return z.reshape(b, nw, n, heads, dh).transpose(2, 3).float()

    comb = rel_bias[None, None]
    if mask is not None:
        comb = mask[None, :, None] + comb
    s = split_heads(q) @ split_heads(k).transpose(-1, -2) + comb
    e = torch.exp(s - s.amax(-1, keepdim=True))
    recip = 1.0 / e.sum(-1, keepdim=True)
    p = e.to(t).float()
    return tuple(((p @ split_heads(v)) * recip).to(t).transpose(2, 3)
                 .reshape(b, nw, n, c) for v in values)


def window_block_windows_plain(x: torch.Tensor, w: BlockWeights, *,
                               heads: int,
                               mask: Optional[torch.Tensor] = None,
                               padmask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """x (B, nW, N, C) -> x + attn(LN1 x) -> + MLP(LN2 .), same layout.
    Every product runs on float32 copies of T-typed operands, which is what
    the kernel's f32-accumulated products compute."""
    t = x.dtype
    c = x.shape[-1]
    xf = x.float()
    ln = _ln(xf, w.n1s, w.n1b).to(t) if w.n1s is not None else x
    if padmask is not None:
        ln = ln * padmask.to(t)[None, :, :, None]
    qkv = (ln.float() @ w.wqkv.float() + w.bqkv).to(t)
    q, k, v = qkv.split(c, dim=-1)
    q = (q.float() * (c // heads) ** -0.5).to(t)
    (o,) = attend(q, k, (v,), w.rel_bias, heads=heads, mask=mask)
    y = xf + o.float() @ w.wp.float() + w.bp
    h2 = _ln(y, w.n2s, w.n2b) if w.n2s is not None else y
    hid = F.gelu(h2.to(t).float() @ w.w1.float() + w.b1).to(t)
    return (y + (hid.float() @ w.w2.float() + w.b2)).to(t)


def window_block_rows_plain(x: torch.Tensor, w: BlockWeights, *, heads: int,
                            window: Tuple[int, int], shift: Tuple[int, int],
                            mask: Optional[torch.Tensor] = None,
                            padmask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """x (B, Hp, Wp, C) window-padded -> same shape, plain frame: roll by
    (-sh, -sw), partition, block, merge, roll back."""
    b, hp, wp, c = x.shape
    (wh, ww), (sh, sw) = window, shift
    if sh or sw:
        x = torch.roll(x, (-sh, -sw), (1, 2))
    xw = window_partition(x, wh, ww).reshape(b, -1, wh * ww, c)
    y = window_block_windows_plain(xw, w, heads=heads, mask=mask,
                                   padmask=padmask)
    y = window_merge(y.reshape(-1, wh * ww, c), b, hp, wp, wh, ww)
    return torch.roll(y, (sh, sw), (1, 2)) if sh or sw else y


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_PTRS = ("x", "out", "wqkv", "bqkv", "wp", "bp", "rel_bias", "mask",
         "padmask", "n1s", "n1b", "n2s", "n2b", "w1", "b1", "w2", "b2")
_INTS = ("dtype", "B", "Hp", "Wp", "C", "heads", "hidden", "wh", "ww", "sh",
         "sw", "nW")


class TcPlan(ctypes.Structure):
    """The C struct ``TcPlan`` of csrc/window_tc.cuh: a BlockPlan as the
    kernels read it (K1, K2 and K3's tensor-core bodies)."""
    _fields_ = [(f, ctypes.c_longlong) for f in ("body", "rows", "panel",
                                                 "kp", "stages",
                                                 "smem_bytes")]

    @classmethod
    def of(cls, plan: BlockPlan) -> "TcPlan":
        return cls(body=plan.blocks_per_sm if plan.body == "tc" else 0,
                   rows=plan.rows,
                   panel=plan.panel, kp=plan.kp, stages=plan.stages,
                   smem_bytes=plan.smem_bytes)


class WindowBlockArgs(ctypes.Structure):
    """The C struct ``Args`` of csrc/window_block.cu, field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTRS]
                + [("scale", ctypes.c_double)]
                + [(f, ctypes.c_longlong) for f in _INTS]
                + [("plan", TcPlan)])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("window_block")
    for entry in ("mmst_window_block_rows", "mmst_window_block_windows"):
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(WindowBlockArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mmst_window_block_smem_bytes.argtypes = [ctypes.c_longlong] * 4
    lib.mmst_window_block_smem_bytes.restype = ctypes.c_longlong
    lib.mmst_window_block_attributes.argtypes = (
        [ctypes.c_longlong] * 4 + [ctypes.POINTER(ctypes.c_longlong)] * 3)
    lib.mmst_window_block_attributes.restype = ctypes.c_int
    return lib


def smem_bytes(plan: BlockPlan, n: int, c: int, heads: int,
               dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of the call's body takes."""
    if plan.body == "tc":
        return plan.smem_bytes
    return _lib().mmst_window_block_smem_bytes(
        n, c, heads, torch.finfo(dtype).bits // 8)


def kernel_attributes(plan: BlockPlan, dtype: torch.dtype, dh: int,
                      entry: str = "window_block_rows"
                      ) -> Tuple[int, int, int]:
    """(static shared memory bytes per block, dynamic shared memory opted
    in so far on this device, registers per thread) of the kernel that
    ``plan`` runs: the tensor-core kernel of head dim dh in the plan's form
    (one for both entries), or the entry's scalar kernel at ``dtype``."""
    vals = [ctypes.c_longlong() for _ in range(3)]
    err = _lib().mmst_window_block_attributes(
        TcPlan.of(plan).body, int(dtype == torch.bfloat16), dh,
        int(entry == "window_block_rows"), *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes: CUDA error {err}")
    return tuple(v.value for v in vals)


def _need(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"the kernel takes {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(entry: str, x: torch.Tensor, w: BlockWeights, *, heads: int,
            n: int, nw: int, geometry: dict,
            mask: Optional[torch.Tensor],
            padmask: Optional[torch.Tensor]) -> torch.Tensor:
    refuse_grad(entry, x, mask, padmask, *w)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x is {x.dtype}; the kernel takes float32 or "
                        "bfloat16")
    c = x.shape[-1]
    hidden = w.w1.shape[1]
    if c % heads or hidden % c:
        raise ValueError(f"C={c} must divide by heads={heads} and the MLP "
                         f"width {hidden} by C")
    dev, f32 = x.device, torch.float32
    _need("x", x, x.shape, x.dtype, dev)
    for name, shape, dtype in (
            ("wqkv", (c, 3 * c), x.dtype), ("bqkv", (3 * c,), f32),
            ("wp", (c, c), x.dtype), ("bp", (c,), f32),
            ("rel_bias", (heads, n, n), f32),
            ("w1", (c, hidden), x.dtype), ("b1", (hidden,), f32),
            ("w2", (hidden, c), x.dtype), ("b2", (c,), f32)):
        _need(name, getattr(w, name), shape, dtype, dev)
    for name in ("n1s", "n1b", "n2s", "n2b"):
        if getattr(w, name) is not None:
            _need(name, getattr(w, name), (c,), f32, dev)
    if (w.n1s is None) != (w.n1b is None) or (w.n2s is None) != (w.n2b is None):
        raise ValueError("a norm needs both its scale and its bias")
    if mask is not None:
        _need("mask", mask, (nw, n, n), f32, dev)
    if padmask is not None:
        _need("padmask", padmask, (nw, n), f32, dev)
    lib = _lib()
    plan = block_plan(entry, n, c, heads, hidden, x.dtype)
    smem = smem_bytes(plan, n, c, heads, x.dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"N={n}, C={c} needs {smem} bytes of shared memory "
                         f"per block, over the {MAX_SMEM_BYTES} available")

    out = torch.empty_like(x)
    keep = {"x": x, "out": out, "mask": mask, "padmask": padmask,
            **w._asdict()}
    args = WindowBlockArgs(
        **{f: (keep[f].data_ptr() if keep[f] is not None else None)
           for f in _PTRS},
        scale=(c // heads) ** -0.5,
        dtype=1 if x.dtype == torch.bfloat16 else 0,
        C=c, heads=heads, hidden=hidden, nW=nw, plan=TcPlan.of(plan),
        **geometry)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, f"mmst_{entry}")(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    LAUNCHES[entry] += 1
    return out


def refuse_grad(entry: str, *tensors: Optional[torch.Tensor]) -> None:
    """An evaluation kernel, which has no backward, refuses to launch where
    autograd would record it: grad enabled and an input that requires grad.
    Its output, written through ctypes, would carry no graph, and every
    gradient through it would silently be lost."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{entry} is an evaluation kernel with no backward; run it under "
            "torch.no_grad() or inference_mode(), or on inputs that do not "
            "require grad (training takes the kernels with a backward)")


def _on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel of the port for device {x.device}")


def window_block_rows(x: torch.Tensor, w: BlockWeights, *, heads: int,
                      window: Tuple[int, int], shift: Tuple[int, int],
                      mask: Optional[torch.Tensor] = None,
                      padmask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Swin block on a window-padded image (B, Hp, Wp, C), output in the
    plain frame. mask (nW, N, N) and padmask (nW, N) are in the window order
    of the rolled grid, as ops/windows.py builds them."""
    if not _on_cuda(x):
        return window_block_rows_plain(x, w, heads=heads, window=window,
                                       shift=shift, mask=mask,
                                       padmask=padmask)
    b, hp, wp, _ = x.shape
    (wh, ww), (sh, sw) = window, shift
    if hp % wh or wp % ww or not (0 <= sh < wh and 0 <= sw < ww):
        raise ValueError(f"image {hp}x{wp} is not padded to window {window},"
                         f" or shift {shift} is outside it")
    return _launch("window_block_rows", x, w, heads=heads, n=wh * ww,
                   nw=(hp // wh) * (wp // ww),
                   geometry=dict(B=b, Hp=hp, Wp=wp, wh=wh, ww=ww, sh=sh,
                                 sw=sw),
                   mask=mask, padmask=padmask)


def window_block_windows(x: torch.Tensor, w: BlockWeights, *, heads: int,
                         mask: Optional[torch.Tensor] = None,
                         padmask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Swin block on partitioned windows (B, nW, N, C)."""
    if not _on_cuda(x):
        return window_block_windows_plain(x, w, heads=heads, mask=mask,
                                          padmask=padmask)
    b, nw, n, _ = x.shape
    # The kernel reads the windows as an (nW, N) image of 1 x N windows,
    # unshifted: the rows entry's token arithmetic then gives window w's
    # token t at ((b nW + w) N + t) C.
    return _launch("window_block_windows", x, w, heads=heads, n=n, nw=nw,
                   geometry=dict(B=b, Hp=nw, Wp=n, wh=1, ww=n, sh=0, sw=0),
                   mask=mask, padmask=padmask)
