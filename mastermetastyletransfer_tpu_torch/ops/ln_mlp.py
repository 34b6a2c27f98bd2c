"""The fused [LayerNorm ->] MLP -> + residual, forward and backward (JAX
counterparts: the Pallas kernel K10 ``fused_ln_mlp_residual`` in
ops/pallas_mlp.py and its backward ``_run_bwd`` in ops/pallas_mlp_vjp.py):

    h = LN(x) (optional) ; a = h W1 + b1 ; z = GELU(a) ; y = x + z W2 + b2

``ln_mlp_residual`` is a ``torch.autograd.Function``. For a CUDA tensor its
forward and its backward each launch their kernel (csrc/ln_mlp.cu); for a
CPU tensor they run the plain versions below, the forward and the explicit
backward; any other device raises. Two bodies compute each kernel: at
bfloat16 the tensor-core bodies (csrc/mlp_tc.cuh) where ``mlp_plan`` below
says so -- every training shape -- and every other call (f32) the scalar
body. ``mlp_plan``, ``mlp_layout``, ``mlp_tile_schedule`` (window_block's,
K1's MLP order) and ``mlp_bwd_tile_schedule`` give the tensor-core bodies'
tiling, and
``weight_splits`` the row chunks of the weight-gradient product, which
tests/test_torch_mlp_tc_plan.py replays in torch on the CPU.

The plain versions are the yardstick the kernels are held to: products of
operands rounded to the input type T, summed in f32, and T roundings where
the JAX kernels round (h before fc1, GELU's output before fc2, the output;
in the backward g, da, z and h before their products, dx at the end). GELU
uses the exact erf (the JAX kernels the Abramowitz-Stegun erf, |err| <=
1.5e-7).

Backward (the math of ``_bwd_kernel``, pallas_mlp_vjp.py:36-104):

    dz = g W2^T ; da = dz * GELU'(a), GELU'(a) = Phi(a) + a phi(a)
    dW2 = z^T g ; db2 = sum g ; dW1 = h^T da ; db1 = sum da ; dh = da W1^T
    LN: dx = g + (1/sigma) (dhat - mean(dhat) - xhat mean(dhat xhat)),
    dhat = dh * scale ; dscale = sum dh xhat ; dbias = sum dh
    (no LN: dx = g + dh)

``LAUNCHES`` counts kernel launches per entry; a wrapper adds one only where
it launches its kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mastermetastyletransfer_tpu_torch.ops import _build
from mastermetastyletransfer_tpu_torch.ops.window_block import (
    MAX_SMEM_BYTES, SMEM_PER_SM, TC_FORMS, TC_PANEL, TC_ROWS, TcPlan,
    _align16, _ln, _need, _on_cuda, mlp_tile_schedule,
)

LAUNCHES = {"ln_mlp_residual": 0, "ln_mlp_residual_bwd": 0}

_INV_SQRT2 = 0.5 ** 0.5
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _tf(w: torch.Tensor, t: torch.dtype) -> torch.Tensor:
    """A weight as the kernels multiply it: rounded to T, in f32."""
    return w.to(t).float()


def _vec(b: Optional[torch.Tensor], n: int, like: torch.Tensor
         ) -> torch.Tensor:
    return (torch.zeros(n, device=like.device) if b is None
            else b.float())


# ---------------------------------------------------------------------------
# The tensor-core bodies' plan (csrc/mlp_tc.cuh)
# ---------------------------------------------------------------------------

# The forms, in order of preference: (blocks an SM, weight rows per ring
# tile, ring tiles). The forward takes K1's (two blocks of 8 warps an SM
# where C <= 128, else one of 16); the backward one block of 16 warps, a
# ring of 2 tiles of 64 rows where C % 64 == 0, else 4 of 32. (A ring of 3
# x 64 rows does not fit at C = 256; 2 x 64 ran the main kernel 21%
# faster there than 4 x 32 or 3 x 32 on an H100, half the barriers, and
# as fast as 3 x 64 at C = 128: PERF.md, PR 14.)
MLP_FWD_FORMS = TC_FORMS
MLP_BWD_FORMS = ((1, 64, 2), (1, 32, 4))


class MlpPlan(NamedTuple):
    """How one K10 call runs; built by ``mlp_plan`` and passed to the
    kernel (``TcPlan``). ``body`` "tc": the tensor-core body, one block per
    ``rows`` (64) rows of the flattened (rows, C), ``tiles`` of them (the
    last may be ragged), ``blocks_per_sm`` blocks an SM (of 8 warps at two,
    of 16 at one), each product in panels of up to ``panel`` output
    columns, the weights streamed as tiles of ``kp`` rows through a ring of
    ``stages`` (``mlp_tile_schedule``, ``mlp_bwd_tile_schedule``),
    ``smem_bytes`` its dynamic shared memory (``mlp_layout``). "scalar":
    the scalar body, the other fields 0."""
    body: str
    rows: int
    panel: int
    kp: int
    stages: int
    blocks_per_sm: int
    smem_bytes: int
    tiles: int


def mlp_layout(c: int, kp: int, stages: int, backward: bool) -> dict:
    """Byte offsets and total of the tensor-core bodies' shared memory
    (csrc/mlp_tc.cuh:tc_mlp_layout): the f32 tile xs (64 x C; the forward's
    residual sum, the backward's dh), the bf16 tile ln (64 x C; the normed
    input h), the backward's bf16 g tile and f32 chunk fa (64 x 128), the
    bf16 chunk hid (64 x 128; the forward's GELU output, the backward's
    da), the ring, the row statistics, the backward's two LN sums a row
    and the forward's row offsets; rows padded by 32 bytes (f32) and 16
    (bf16)."""
    tile = 2 * TC_ROWS * (c + 8)
    sizes = (("xs", 4 * TC_ROWS * (c + 8)), ("ln", tile),
             ("g", tile if backward else 0),
             ("fa", 4 * TC_ROWS * (TC_PANEL + 8) if backward else 0),
             ("hid", 2 * TC_ROWS * (TC_PANEL + 8)),
             ("ring", 2 * stages * kp * (TC_PANEL + 8)),
             ("mean", 4 * TC_ROWS), ("rstd", 4 * TC_ROWS),
             ("m1", 4 * TC_ROWS if backward else 0),
             ("m2", 4 * TC_ROWS if backward else 0),
             ("toff", 0 if backward else 8 * TC_ROWS))
    out, o = {}, 0
    for name, size in sizes:
        out[name] = o
        o = _align16(o + size)
    out["total"] = o
    return out


@functools.lru_cache(maxsize=None)
def mlp_plan(rows: int, c: int, hidden: int, backward: bool,
             dtype: torch.dtype) -> MlpPlan:
    """The body one call runs: the tensor-core body at bfloat16 where C %
    32 == 0 and the MLP width a multiple of 128 (every training shape: C
    128 and 256, hidden 4 C), in the first form of MLP_FWD_FORMS or
    MLP_BWD_FORMS that C allows and whose shared memory fits that many
    blocks an SM (two only where C <= 128); the scalar body for every
    other call."""
    if (dtype == torch.bfloat16 and rows >= 1 and c >= 32 and c % 32 == 0
            and hidden >= TC_PANEL and hidden % TC_PANEL == 0):
        for per_sm, kp, stages in (MLP_BWD_FORMS if backward
                                   else MLP_FWD_FORMS):
            if c % kp or (per_sm == 2 and c > TC_PANEL):
                continue
            smem = mlp_layout(c, kp, stages, backward)["total"]
            if smem <= min(MAX_SMEM_BYTES, SMEM_PER_SM // per_sm - 1024):
                return MlpPlan("tc", TC_ROWS, TC_PANEL, kp, stages, per_sm,
                               smem, -(-rows // TC_ROWS))
    return MlpPlan("scalar", 0, 0, 0, 0, 0, 0, 0)


def mlp_bwd_tile_schedule(plan: MlpPlan, c: int, hidden: int
                          ) -> List[Tuple[str, int, int, int, int]]:
    """The backward's weight tiles in the order its body uses them, by the
    kernel's own arithmetic for tile u (csrc/mlp_tc.cuh, BwdMlpTiles), as
    (matrix, first row, first column, rows, width); the forward's are
    window_block's ``mlp_tile_schedule`` (K1's MLP order). Per
    128-wide hidden chunk j, w1's panel (C, hidden) over K = C (a), w2t's
    panel (W2^T, (C, hidden)) over K = C (dz), then w1t's panels (W1^T,
    (hidden, C)) over the chunk (dh)."""
    kp, p = plan.kp, plan.panel
    nk, ng, kpc = c // kp, -(-c // p), p // kp
    out = []
    for j in range(hidden // p):
        out += [("w1", r * kp, j * p, kp, p) for r in range(nk)]
        out += [("w2t", r * kp, j * p, kp, p) for r in range(nk)]
        out += [("w1t", j * p + kt * kp, pn * p, kp, min(p, c - pn * p))
                for pn in range(ng) for kt in range(kpc)]
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def ln_mlp_residual_plain(x: torch.Tensor, w1: torch.Tensor,
                          b1: Optional[torch.Tensor], w2: torch.Tensor,
                          b2: Optional[torch.Tensor],
                          ns: Optional[torch.Tensor] = None,
                          nb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10's function on x (..., C) in T; weights as stored (float32)."""
    t = x.dtype
    c, hidden = w1.shape
    xf = x.float()
    h = _ln(xf, ns.float(), nb.float()) if ns is not None else xf
    a = h.to(t).float() @ _tf(w1, t) + _vec(b1, hidden, x)
    z = F.gelu(a)
    return (xf + (z.to(t).float() @ _tf(w2, t) + _vec(b2, c, x))).to(t)


def ln_mlp_residual_bwd_plain(g: torch.Tensor, x: torch.Tensor,
                              w1: torch.Tensor, b1: Optional[torch.Tensor],
                              w2: torch.Tensor,
                              ns: Optional[torch.Tensor] = None,
                              nb: Optional[torch.Tensor] = None):
    """K10's backward from the input alone (the forward recomputed):
    (dx in T, dW1, db1, dW2, db2, d LN scale, d LN bias), the last six in
    float32 (the norm grads None without LN)."""
    t = x.dtype
    c, hidden = w1.shape
    x2 = x.reshape(-1, c).float()
    g2 = g.reshape(-1, c).to(t).float()
    if ns is not None:
        mean = x2.mean(-1, keepdim=True)
        var = ((x2 - mean) ** 2).mean(-1, keepdim=True)
        inv = torch.rsqrt(var + 1e-5)
        xhat = (x2 - mean) * inv
        h = xhat * ns.float() + nb.float()
    else:
        h = x2
    ht = h.to(t).float()
    a = ht @ _tf(w1, t) + _vec(b1, hidden, x)
    phi_big = 0.5 * (1.0 + torch.erf(a * _INV_SQRT2))
    z = a * phi_big
    dz = g2 @ _tf(w2, t).T
    da = dz * (phi_big + a * _INV_SQRT2PI * torch.exp(-0.5 * a * a))
    dat = da.to(t).float()
    dh = dat @ _tf(w1, t).T
    dw1 = ht.T @ dat
    dw2 = z.to(t).float().T @ g2
    db1, db2 = da.sum(0), g2.sum(0)
    dns = dnb = None
    if ns is not None:
        dhat = dh * ns.float()
        m1 = dhat.mean(-1, keepdim=True)
        m2 = (dhat * xhat).mean(-1, keepdim=True)
        dx = g2 + inv * (dhat - m1 - xhat * m2)
        dns, dnb = (dh * xhat).sum(0), dh.sum(0)
    else:
        dx = g2 + dh
    return (dx.to(t).reshape(x.shape), dw1, db1, dw2, db2, dns, dnb)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_PTRS = ("x", "out", "g", "dx", "ns", "nb", "w1", "b1", "w2", "b2", "w1t",
         "w2t", "h_t", "da_t", "z_t", "part_vec", "part_w", "dw1", "db1",
         "dw2", "db2", "dns", "dnb")
_INTS = ("dtype", "rows", "C", "hidden", "wsplit")


class LnMlpArgs(ctypes.Structure):
    """The C struct ``LnMlpArgs`` of csrc/ln_mlp.cu, field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTRS]
                + [(f, ctypes.c_longlong) for f in _INTS]
                + [("plan", TcPlan)])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ln_mlp")
    for entry in LAUNCHES:
        fn = getattr(lib, f"mmst_{entry}")
        fn.argtypes = [ctypes.POINTER(LnMlpArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mmst_ln_mlp_smem_bytes.argtypes = [ctypes.c_longlong] * 4
    lib.mmst_ln_mlp_smem_bytes.restype = ctypes.c_longlong
    lib.mmst_ln_mlp_rows_per_block.argtypes = [ctypes.c_longlong]
    lib.mmst_ln_mlp_rows_per_block.restype = ctypes.c_longlong
    lib.mmst_ln_mlp_attributes.argtypes = (
        [ctypes.c_longlong] * 4 + [ctypes.POINTER(ctypes.c_longlong)] * 4)
    lib.mmst_ln_mlp_attributes.restype = ctypes.c_int
    return lib


def smem_bytes(plan: MlpPlan, c: int, hidden: int, dtype: torch.dtype,
               backward: bool) -> int:
    """Dynamic shared memory one block of the call's body takes: the
    tensor-core body where ``plan`` says so, else the scalar body."""
    if plan.body == "tc":
        return plan.smem_bytes
    return _lib().mmst_ln_mlp_smem_bytes(c, hidden,
                                         torch.finfo(dtype).bits // 8,
                                         int(backward))


def kernel_attributes(plan: MlpPlan, dtype: torch.dtype, backward: bool
                      ) -> Tuple[int, int, int, int]:
    """(static shared memory bytes per block, dynamic shared memory opted
    in so far on this device, registers per thread, local memory bytes per
    thread -- spills) of the forward's or the backward's main kernel that
    ``plan`` runs: the tensor-core kernel of its form, or the scalar one at
    ``dtype``."""
    vals = [ctypes.c_longlong() for _ in range(4)]
    err = _lib().mmst_ln_mlp_attributes(
        plan.blocks_per_sm if plan.body == "tc" else 0, plan.stages,
        int(dtype == torch.bfloat16), int(backward),
        *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes: CUDA error {err}")
    return tuple(v.value for v in vals)


# A weight-gradient block's tile of dW (rows of I, columns of J): the
# tensor-core product's at bf16, the scalar one's at f32 (grad_common.cuh).
WGRAD_TILES = {torch.bfloat16: (64, 128), torch.float32: (32, 32)}


def weight_splits(rows: int, i: int, j: int, dtype: torch.dtype) -> int:
    """Row chunks of the weight-gradient product dW (i, j) = A^T B over
    ``rows``: enough blocks (tiles x chunks) for two waves over the H100's
    132 SMs, at least 64 rows a chunk."""
    ti, tj = WGRAD_TILES[dtype]
    tiles = -(-i // ti) * -(-j // tj)
    return max(1, min(-(-264 // tiles), rows // 64))


def wgrad_chunks(rows: int, splits: int) -> List[Tuple[int, int]]:
    """The (first, end) rows of each chunk, in the order reduce_parts adds
    their partials (csrc/grad_common.cuh: ceil(rows / splits) a chunk)."""
    per = -(-rows // splits)
    return [(s * per, min(s * per + per, rows)) for s in range(splits)]


def _prepare(x, w1, b1, w2, b2, ns, nb):
    """Checks and the kernel's operands: x as (rows, C), matrices in T,
    vectors in float32."""
    t = x.dtype
    if t not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x is {t}; the kernel takes float32 or bfloat16")
    c, hidden = w1.shape
    if x.shape[-1] != c or tuple(w2.shape) != (hidden, c):
        raise ValueError(f"x (..., {x.shape[-1]}), W1 {tuple(w1.shape)} and "
                         f"W2 {tuple(w2.shape)} do not chain")
    if (ns is None) != (nb is None):
        raise ValueError("a norm needs both its scale and its bias")
    x2 = x.reshape(-1, c)
    _need("x", x2, x2.shape, t, x.device)
    if t == torch.bfloat16 and x2.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary: the bf16 "
                         "kernels read it 16 bytes a piece")
    ops = dict(w1=w1.to(t).contiguous(), w2=w2.to(t).contiguous(),
               b1=_vec(b1, hidden, x).contiguous(),
               b2=_vec(b2, c, x).contiguous(),
               ns=None if ns is None else ns.float().contiguous(),
               nb=None if nb is None else nb.float().contiguous())
    for name, shape in (("b1", (hidden,)), ("b2", (c,)), ("ns", (c,)),
                        ("nb", (c,))):
        if ops[name] is not None:
            _need(name, ops[name], shape, torch.float32, x.device)
    return x2, ops


def _call(entry: str, keep: dict, dtype: torch.dtype, device,
          plan: MlpPlan, **ints) -> None:
    args = LnMlpArgs(
        **{f: (keep[f].data_ptr() if keep.get(f) is not None else None)
           for f in _PTRS},
        dtype=int(dtype == torch.bfloat16), plan=TcPlan.of(plan), **ints)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(_lib(), f"mmst_{entry}")(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    LAUNCHES[entry] += 1


def _plan_checked(rows: int, c: int, hidden: int, dtype,
                  backward: bool) -> MlpPlan:
    plan = mlp_plan(rows, c, hidden, backward, dtype)
    smem = smem_bytes(plan, c, hidden, dtype, backward)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"C={c}, hidden={hidden} needs {smem} bytes of "
                         f"shared memory per block, over {MAX_SMEM_BYTES}")
    return plan


def ln_mlp_residual_fwd_kernel(x, w1, b1, w2, b2, ns=None, nb=None):
    """Launch K10's forward on a CUDA tensor."""
    x2, ops = _prepare(x, w1, b1, w2, b2, ns, nb)
    rows, c = x2.shape
    hidden = w1.shape[1]
    plan = _plan_checked(rows, c, hidden, x.dtype, False)
    out = torch.empty_like(x2)
    _call("ln_mlp_residual", dict(ops, x=x2, out=out), x.dtype, x.device,
          plan, rows=rows, C=c, hidden=hidden, wsplit=1)
    return out.reshape(x.shape)


def ln_mlp_residual_bwd_kernel(g, x, w1, b1, w2, ns=None, nb=None):
    """Launch K10's backward on CUDA tensors; returns what
    ``ln_mlp_residual_bwd_plain`` returns."""
    t = x.dtype
    x2, ops = _prepare(x, w1, b1, w2, None, ns, nb)
    rows, c = x2.shape
    hidden = w1.shape[1]
    if c % 32 or hidden % 32:
        raise ValueError(f"C={c} and hidden={hidden} must be multiples of 32")
    plan = _plan_checked(rows, c, hidden, t, True)
    g2 = g.reshape(rows, c).to(t).contiguous()
    if t == torch.bfloat16 and g2.data_ptr() % 16:
        raise ValueError("g must start on a 16-byte boundary: the bf16 "
                         "weight-gradient product reads it 16 bytes a piece")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    tiles = (plan.tiles if plan.body == "tc"
             else -(-rows // _lib().mmst_ln_mlp_rows_per_block(1)))
    wsplit = weight_splits(rows, c, hidden, t)
    use_norm = ns is not None
    keep = dict(
        ops, x=x2, g=g2, dx=torch.empty_like(x2),
        w1t=ops["w1"].T.contiguous(), w2t=ops["w2"].T.contiguous(),
        h_t=torch.empty_like(x2) if use_norm else None,
        da_t=torch.empty((rows, hidden), dtype=t, device=dev),
        z_t=torch.empty((rows, hidden), dtype=t, device=dev),
        part_vec=torch.empty((tiles, hidden + 3 * c), **f32),
        part_w=torch.empty((wsplit, c * hidden), **f32),
        dw1=torch.empty((c, hidden), **f32), db1=torch.empty(hidden, **f32),
        dw2=torch.empty((hidden, c), **f32), db2=torch.empty(c, **f32),
        dns=torch.empty(c, **f32) if use_norm else None,
        dnb=torch.empty(c, **f32) if use_norm else None)
    _call("ln_mlp_residual_bwd", keep, t, dev, plan, rows=rows, C=c,
          hidden=hidden, wsplit=wsplit)
    return (keep["dx"].reshape(x.shape), keep["dw1"], keep["db1"],
            keep["dw2"], keep["db2"], keep["dns"], keep["dnb"])


class _LnMlpResidual(torch.autograd.Function):
    """K10 with its backward: the kernels for CUDA tensors, the plain
    versions for CPU tensors. Only the input is kept for the backward,
    which recomputes the forward, as the JAX kernel does."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ns, nb):
        ctx.save_for_backward(x, w1, b1, w2, ns, nb)
        ctx.has_b2 = b2 is not None
        if _on_cuda(x):
            return ln_mlp_residual_fwd_kernel(x, w1, b1, w2, b2, ns, nb)
        return ln_mlp_residual_plain(x, w1, b1, w2, b2, ns, nb)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, ns, nb = ctx.saved_tensors
        bwd = (ln_mlp_residual_bwd_kernel if _on_cuda(x)
               else ln_mlp_residual_bwd_plain)
        dx, dw1, db1, dw2, db2, dns, dnb = bwd(g, x, w1, b1, w2, ns, nb)
        return (dx, dw1.to(w1.dtype), None if b1 is None else db1.to(b1.dtype),
                dw2.to(w2.dtype), db2 if ctx.has_b2 else None,
                None if ns is None else dns.to(ns.dtype),
                None if nb is None else dnb.to(nb.dtype))


def ln_mlp_residual(x: torch.Tensor, mlp_params: dict,
                    norm_params: Optional[dict] = None) -> torch.Tensor:
    """y = x + fc2(GELU(fc1(LN(x)))) with LN optional, x (..., C); the
    param dicts in the JAX layout (kernels (in, out))."""
    fc1, fc2 = mlp_params["fc1"], mlp_params["fc2"]
    ns = nb = None
    if norm_params is not None:
        ns, nb = norm_params["scale"], norm_params["bias"]
    return _LnMlpResidual.apply(x, fc1["kernel"], fc1.get("bias"),
                                fc2["kernel"], fc2.get("bias"), ns, nb)
