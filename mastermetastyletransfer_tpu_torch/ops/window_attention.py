"""Window attention with its projections, forward and backward (JAX
counterparts: the Pallas kernels K8 ``fused_window_attention`` and K9
``fused_window_attention_dual`` in ops/pallas_attention.py, and their
backward kernels ``_bwd`` and ``_bwd_dual`` in ops/pallas_attention_vjp.py),
over window tensors (B, nW, N, C):

* ``window_attention`` (K8): q, k, v are the raw window inputs; the kernel
  projects them (wq, wk, wv), attends per head with the relative-position
  bias and the shift mask, and projects the heads' output (wp);
* ``window_attention_dual`` (K9): q and k arrive projected; one softmax per
  head feeds two value streams, each through its own value projection, and
  both through the shared wp -> (sigma, mu). The style encoder's Scale and
  Shift blocks pass the same wv twice (autograd sums its two gradients).

Both are ``torch.autograd.Function``s. For a CUDA tensor the forward and
the backward each launch their kernel (csrc/window_attention.cu, one body
per direction for one or two value streams); for a CPU tensor they run the
plain versions below, the forward and the explicit backward; any other
device raises. The expanded bias (heads, N, N) is a differentiable input
(its gather from the table stays outside, so autograd does the scatter);
the shift mask (nW, N, N) is a constant.

Rounding points, as the JAX kernels: products in f32 of T-typed operands;
q * scale, k and v rounded to T after their f32 projection, the softmax
numerators before the value product, each head's output. Backward (the
docstring of pallas_attention_vjp.py): g rounded to T; dO = round(G Wp^T);
P = softmax(S); dS = P (dP - rowsum(dP P)); dq = s dS_T k, dk = s dS_T^T q,
dv = P_T^T dO; dX = round(d{q,k,v}) W^T; dW = X^T round(d{q,k,v});
db = sum d{q,k,v}; dWp = O_T^T G (O from the normalized P); d bias = sum
of dS over every window of every image.

At bfloat16 both directions run a tensor-core body where their plans
below say so -- every training shape -- the forward csrc/attn_fwd_tc.cuh
(``attn_fwd_plan``, ``attn_fwd_layout``, ``attn_fwd_tile_schedule``), the
backward csrc/attn_tc.cuh (``attn_bwd_plan``, ``attn_bwd_layout``,
``attn_bwd_tile_schedule``); every other call (f32 above all) runs the
scalar bodies. tests/test_torch_attn_tc_plan.py replays both tilings in
torch on the CPU.

``LAUNCHES`` counts kernel launches per entry; a wrapper adds one only where
it launches its kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from mastermetastyletransfer_tpu_torch.ops import _build
from mastermetastyletransfer_tpu_torch.ops.ln_mlp import weight_splits
from mastermetastyletransfer_tpu_torch.ops.window_block import (
    MAX_SMEM_BYTES, SMEM_PER_SM, TC_PANEL, TC_ROWS, TcPlan, _align16, _need,
    _on_cuda, attend,
)

LAUNCHES = {"window_attention": 0, "window_attention_bwd": 0,
            "window_attention_dual": 0, "window_attention_dual_bwd": 0}


class Proj(NamedTuple):
    """One linear layer as stored: kernel (C, C) float32, bias or None."""
    w: torch.Tensor
    b: Optional[torch.Tensor]


def _tf(w: torch.Tensor, t: torch.dtype) -> torch.Tensor:
    return w.to(t).float()


def _bias(b: Optional[torch.Tensor], c: int, like: torch.Tensor
          ) -> torch.Tensor:
    return torch.zeros(c, device=like.device) if b is None else b.float()


def _proj(x: torch.Tensor, p: Proj) -> torch.Tensor:
    """f32 projection of T-typed x through the T-rounded kernel."""
    return x.float() @ _tf(p.w, x.dtype) + _bias(p.b, x.shape[-1], x)


# ---------------------------------------------------------------------------
# The tensor-core backward's plan (csrc/attn_tc.cuh)
# ---------------------------------------------------------------------------

ATTN_DH = 32          # the head dim the tensor-core body takes
ATTN_LDS = TC_ROWS + 8  # row stride of a head's P or dS tile (bf16)
# The backward's one form: (blocks an SM, head-group width, weight rows per
# ring tile, ring tiles). One block of 16 warps an SM on 128-column head
# groups; two blocks of 8 warps on 64-column groups ran the body 5% slower
# at the style transformer's shape on an H100, though its 200 windows then
# fit one wave (twice the input tiles and ring steps; PERF.md).
ATTN_BWD_FORM = (1, 128, 64, 2)


class AttnBwdPlan(NamedTuple):
    """How one K8 or K9 backward call runs; built by ``attn_bwd_plan`` and
    passed to the kernel (``TcPlan``). ``body`` "tc": the tensor-core body,
    one block of 16 warps per window, ``blocks_per_sm`` (1) of them an SM,
    the window's tokens padded to ``rows`` (four m16 tiles), the heads
    taken ``panel`` columns (a head group) at a time, the
    weights streamed as tiles of ``kp`` rows through a ring of ``stages``
    (``attn_bwd_tile_schedule``), ``smem_bytes`` its dynamic shared memory
    (``attn_bwd_layout``). ``dx`` says where the input gradients' products
    read round(d{q,k,v}) from: "scratch", the window's rounded d-panels of
    every head group written to the *_t tensors (which the weight gradients
    read anyway) and read back after a barrier, since neither the full-width
    d-tiles nor f32 accumulators of dX fit beside a group's panels.
    "scalar": the scalar body, the other fields 0."""
    body: str
    rows: int
    panel: int
    kp: int
    stages: int
    blocks_per_sm: int
    smem_bytes: int
    dx: str


def attn_bwd_layout(c: int, gw: int, kp: int, stages: int, nv: int) -> dict:
    """Byte offsets and total of the tensor-core backward's shared memory
    (csrc/attn_tc.cuh:attn_tc_layout): a head group's panels (NV 1 qs, qc,
    k, v, dO; NV 2 qc, k, two v and two dO; 64 x (gw + 8) bf16 each), one
    region that holds either a window input tile (64 x (C + 8) bf16) or the
    group's round(P) and round(dS) tiles (64 x 72 bf16 per head each), the
    ring (stages x kp x 136 bf16) and the column sums ((NV 1: 3, NV 2: 2) x
    4 x gw f32)."""
    tile = 2 * TC_ROWS * (c + 8)
    pds = 2 * 2 * (gw // ATTN_DH) * TC_ROWS * ATTN_LDS
    sizes = (("panels", (5 if nv == 1 else 6) * 2 * TC_ROWS * (gw + 8)),
             ("u", max(tile, pds)),
             ("ring", 2 * stages * kp * (TC_PANEL + 8)),
             ("cs", 4 * (3 if nv == 1 else 2) * 4 * gw))
    out, o = {}, 0
    for name, size in sizes:
        out[name] = o
        o = _align16(o + size)
    out["total"] = o
    return out


@functools.lru_cache(maxsize=None)
def attn_bwd_plan(n: int, c: int, heads: int, nv: int,
                  dtype: torch.dtype) -> AttnBwdPlan:
    """The body one backward call runs: the tensor-core body in
    ATTN_BWD_FORM at bfloat16 where N <= 64, the head dim is 32 and the
    head group divides C (the style transformer's calls and both Swin
    stages: C 256 with 8 heads, 128 with 4); the scalar body for every
    other call."""
    per_sm, gw, kp, stages = ATTN_BWD_FORM
    if (dtype == torch.bfloat16 and 1 <= n <= TC_ROWS and nv in (1, 2)
            and heads * ATTN_DH == c and c % gw == 0):
        smem = attn_bwd_layout(c, gw, kp, stages, nv)["total"]
        if smem <= min(MAX_SMEM_BYTES, SMEM_PER_SM // per_sm - 1024):
            return AttnBwdPlan("tc", TC_ROWS, gw, kp, stages, per_sm, smem,
                               "scratch")
    return AttnBwdPlan("scalar", 0, 0, 0, 0, 0, 0, "")


def attn_bwd_tile_schedule(plan: AttnBwdPlan, c: int, nv: int
                           ) -> List[Tuple[str, int, int, int, int]]:
    """The backward's weight tiles in the order its body uses them, by the
    kernel's own arithmetic for tile u (csrc/attn_tc.cuh, AttnBwdTiles), as
    (matrix, first row, first column, rows, width): per head group, the
    group's panels of its four projections over K = C (NV 1 wq, wk, wv0 and
    wpt = Wp^T; NV 2 wv0, wv1 and wpt twice, once per stream); then per
    input gradient (NV 1 wqt, wkt, wv0t; NV 2 wv0t, wv1t: the transposes)
    the 128-column panels of the matrix over K = C."""
    kp, gw = plan.kp, plan.panel
    proj = ("wq", "wk", "wv0", "wpt") if nv == 1 else ("wv0", "wv1", "wpt",
                                                       "wpt")
    dx = ("wqt", "wkt", "wv0t") if nv == 1 else ("wv0t", "wv1t")
    out = []
    for gi in range(c // gw):
        out += [(m, kt * kp, gi * gw, kp, gw) for m in proj
                for kt in range(c // kp)]
    for m in dx:
        out += [(m, kt * kp, p0, kp, min(TC_PANEL, c - p0))
                for p0 in range(0, c, TC_PANEL) for kt in range(c // kp)]
    return out


# ---------------------------------------------------------------------------
# The tensor-core forward's plan (csrc/attn_fwd_tc.cuh)
# ---------------------------------------------------------------------------

# The forward's forms, in the order attn_fwd_plan tries them: (blocks an
# SM, weight rows per ring tile, ring tiles). Two blocks of 8 warps an SM
# with a ring of 2 tiles of 32 rows, where their shared memory fits a
# block's half of an SM (C = 128, one value stream), so that one window's
# latency hides behind the other's: at the Swin's stage 1 it ran K8 16%
# faster than one block of 16 warps; else one block of 16 warps with a
# ring of 2 tiles of 64 rows, which ran 2-3% faster than a ring of 3 at
# every training shape (PERF.md).
ATTN_FWD_FORMS = ((2, 32, 2), (1, 64, 2))


class AttnFwdPlan(NamedTuple):
    """How one K8 or K9 forward call runs; built by ``attn_fwd_plan`` and
    passed to the kernel (``TcPlan``). ``body`` "tc": the tensor-core body,
    one block per window, ``blocks_per_sm`` of them an SM (16 warps a block
    at one, 8 at two), the window's tokens padded to ``rows`` (four m16
    tiles), the heads taken ``panel`` columns (a head group) at a time, the
    weights streamed as tiles of ``kp`` rows through a ring of ``stages``
    (``attn_fwd_tile_schedule``), ``smem_bytes`` its dynamic shared memory
    (``attn_fwd_layout``). "scalar": the scalar body, the other fields 0."""
    body: str
    rows: int
    panel: int
    kp: int
    stages: int
    blocks_per_sm: int
    smem_bytes: int


def attn_fwd_layout(c: int, nv: int, kp: int, stages: int) -> dict:
    """Byte offsets and total of the tensor-core forward's shared memory
    (csrc/attn_fwd_tc.cuh:attn_fwd_tc_layout): the head-output tiles, one
    per value stream, and the input tile (64 x (C + 8) bf16 each), a head
    group's q, k and v panels (64 x 136 bf16 each) and the ring (stages x
    kp x 136 bf16)."""
    tile = 2 * TC_ROWS * (c + 8)
    sizes = (("ob", nv * tile), ("x", tile),
             ("panels", 3 * 2 * TC_ROWS * (TC_PANEL + 8)),
             ("ring", 2 * stages * kp * (TC_PANEL + 8)))
    out, o = {}, 0
    for name, size in sizes:
        out[name] = o
        o = _align16(o + size)
    out["total"] = o
    return out


@functools.lru_cache(maxsize=None)
def attn_fwd_plan(n: int, c: int, heads: int, nv: int,
                  dtype: torch.dtype) -> AttnFwdPlan:
    """The body one forward call runs: the tensor-core body at bfloat16
    where N <= 64, the head dim is 32 and C is a multiple of the 128-column
    head group (the style transformer's calls and both Swin stages: C 256
    with 8 heads, 128 with 4), in the first form of ATTN_FWD_FORMS whose
    shared memory fits a block's share of an SM; the scalar body for every
    other call."""
    if (dtype == torch.bfloat16 and 1 <= n <= TC_ROWS and nv in (1, 2)
            and heads * ATTN_DH == c and c % TC_PANEL == 0):
        for per_sm, kp, stages in ATTN_FWD_FORMS:
            smem = attn_fwd_layout(c, nv, kp, stages)["total"]
            if smem <= min(MAX_SMEM_BYTES, SMEM_PER_SM // per_sm - 1024):
                return AttnFwdPlan("tc", TC_ROWS, TC_PANEL, kp, stages,
                                   per_sm, smem)
    return AttnFwdPlan("scalar", 0, 0, 0, 0, 0, 0)


def attn_fwd_tile_schedule(plan: AttnFwdPlan, c: int, nv: int
                           ) -> List[Tuple[str, int, int, int, int]]:
    """The forward's weight tiles in the order its body uses them, by the
    kernel's own arithmetic for tile u (csrc/attn_fwd_tc.cuh,
    AttnFwdTiles), as (matrix, first row, first column, rows, width): per
    head group, the group's 128-wide panels of its projections over K = C
    (NV 1 wq, wk, wv0; NV 2 wv0, wv1); then per value stream the
    128-column panels of wp over K = C."""
    kp, gw = plan.kp, plan.panel
    proj = ("wq", "wk", "wv0") if nv == 1 else ("wv0", "wv1")
    out = []
    for gi in range(c // gw):
        out += [(m, kt * kp, gi * gw, kp, gw) for m in proj
                for kt in range(c // kp)]
    for _ in range(nv):
        out += [("wp", kt * kp, p0, kp, TC_PANEL)
                for p0 in range(0, c, TC_PANEL) for kt in range(c // kp)]
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _heads(z: torch.Tensor, heads: int) -> torch.Tensor:
    b, nw, n, c = z.shape
    return z.reshape(b, nw, n, heads, c // heads).transpose(2, 3).float()


def _merge(z: torch.Tensor) -> torch.Tensor:
    b, nw, h, n, dh = z.shape
    return z.transpose(2, 3).reshape(b, nw, n, h * dh)


def window_attention_plain(q, k, v, wq: Proj, wk: Proj, wv: Proj, wp: Proj,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor], heads: int
                           ) -> torch.Tensor:
    """K8's function: raw window inputs (B, nW, N, C) in T -> (B, nW, N, C)
    in T."""
    t, c = q.dtype, q.shape[-1]
    scale = (c // heads) ** -0.5
    qs = (_proj(q, wq) * scale).to(t)
    kc, vc = _proj(k, wk).to(t), _proj(v, wv).to(t)
    (o,) = attend(qs, kc, (vc,), bias, heads=heads, mask=mask)
    return _proj(o, wp).to(t)


def window_attention_dual_plain(q, k, v_scale, v_shift, wvs: Proj,
                                wvh: Proj, wp: Proj, bias: torch.Tensor,
                                mask: Optional[torch.Tensor], heads: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's function: q, k projected, the two value streams raw -> (sigma,
    mu), both (B, nW, N, C) in T."""
    t, c = v_scale.dtype, v_scale.shape[-1]
    scale = (c // heads) ** -0.5
    qs = (q.float() * scale).to(t)
    vs, vh = _proj(v_scale, wvs).to(t), _proj(v_shift, wvh).to(t)
    os_, oh = attend(qs, k.to(t), (vs, vh), bias, heads=heads, mask=mask)
    return _proj(os_, wp).to(t), _proj(oh, wp).to(t)


def _attn_bwd_core(qs, qc, kc, vcs: Sequence[torch.Tensor],
                   gs: Sequence[torch.Tensor], wp: Proj, bias, mask,
                   heads: int, scale: float):
    """The per-head backward shared by K8 and K9: (dq, dk, [dv per
    stream]) in f32 (B, nW, N, C), dWp, d bias (heads, N, N)."""
    t = qs.dtype
    wpt = _tf(wp.w, t)
    comb = bias.float()[None, None]
    if mask is not None:
        comb = mask[None, :, None] + comb
    s = _heads(qs, heads) @ _heads(kc, heads).transpose(-1, -2) + comb
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    pc = p.to(t).float()
    dos = [_heads((g.float() @ wpt.T).to(t), heads) for g in gs]
    vhs = [_heads(v, heads) for v in vcs]
    dwp = sum(_merge(pc @ vh).to(t).float().flatten(0, 2).T
              @ g.float().flatten(0, 2) for vh, g in zip(vhs, gs))
    dp = sum(do @ vh.transpose(-1, -2) for do, vh in zip(dos, vhs))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dsc = ds.to(t).float()
    dq = _merge(scale * (dsc @ _heads(kc, heads)))
    dk = _merge(scale * (dsc.transpose(-1, -2) @ _heads(qc, heads)))
    dvs = [_merge(pc.transpose(-1, -2) @ do) for do in dos]
    return dq, dk, dvs, dwp, ds.sum((0, 1))


def _through(x: torch.Tensor, d: torch.Tensor, p: Proj):
    """Back through a projection: (dX in T, dW, db) from the f32 grad of
    its output."""
    t = x.dtype
    dt = d.to(t).float()
    dx = (dt @ _tf(p.w, t).T).to(t)
    dw = x.float().flatten(0, 2).T @ dt.flatten(0, 2)
    return dx, dw, d.sum((0, 1, 2))


def window_attention_bwd_plain(g, q, k, v, wq: Proj, wk: Proj, wv: Proj,
                               wp: Proj, bias, mask, heads: int):
    """K8's backward from the inputs alone: (dq, dk, dv in T; dWq, dbq,
    dWk, dbk, dWv, dbv, dWp, dbp, d bias in float32)."""
    t, c = q.dtype, q.shape[-1]
    scale = (c // heads) ** -0.5
    qf = _proj(q, wq)
    qs, qc = (qf * scale).to(t), qf.to(t)
    kc, vc = _proj(k, wk).to(t), _proj(v, wv).to(t)
    gt = g.to(t)
    dq, dk, (dv,), dwp, dbias = _attn_bwd_core(qs, qc, kc, (vc,), (gt,), wp,
                                               bias, mask, heads, scale)
    dxq, dwq, dbq = _through(q, dq, wq)
    dxk, dwk, dbk = _through(k, dk, wk)
    dxv, dwv, dbv = _through(v, dv, wv)
    return (dxq, dxk, dxv, dwq, dbq, dwk, dbk, dwv, dbv, dwp,
            gt.float().sum((0, 1, 2)), dbias)


def window_attention_dual_bwd_plain(g_sigma, g_mu, q, k, v_scale, v_shift,
                                    wvs: Proj, wvh: Proj, wp: Proj, bias,
                                    mask, heads: int):
    """K9's backward: (dq, dk, dv_scale, dv_shift in T; dWvs, dbvs, dWvh,
    dbvh, dWp, dbp, d bias in float32)."""
    t, c = v_scale.dtype, v_scale.shape[-1]
    scale = (c // heads) ** -0.5
    qs = (q.float() * scale).to(t)
    vs, vh = _proj(v_scale, wvs).to(t), _proj(v_shift, wvh).to(t)
    gs, gh = g_sigma.to(t), g_mu.to(t)
    dq, dk, (dvs, dvh), dwp, dbias = _attn_bwd_core(
        qs, q.to(t), k.to(t), (vs, vh), (gs, gh), wp, bias, mask, heads,
        scale)
    dxs, dwvs, dbvs = _through(v_scale, dvs, wvs)
    dxh, dwvh, dbvh = _through(v_shift, dvh, wvh)
    dbp = (gs.float() + gh.float()).sum((0, 1, 2))
    return (dq.to(t), dk.to(t), dxs, dxh, dwvs, dbvs, dwvh, dbvh, dwp, dbp,
            dbias)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_PTRS = ("q", "k", "v0", "v1", "out0", "out1", "g0", "g1", "dq", "dk",
         "dv0", "dv1", "wq", "bq", "wk", "bk", "wv0", "bv0", "wv1", "bv1",
         "wp", "bp", "wqt", "wkt", "wv0t", "wv1t", "wpt", "rel_bias", "mask",
         "dq_t", "dk_t", "dv0_t", "dv1_t", "o0_t", "o1_t", "part_vec",
         "part_bias", "part_w", "dwq", "dwk", "dwv0", "dwv1", "dwp", "dbq",
         "dbk", "dbv0", "dbv1", "dbp", "dbias")
_INTS = ("dtype", "B", "nW", "N", "C", "heads", "nv", "wsplit")


class AttnArgs(ctypes.Structure):
    """The C struct ``AttnArgs`` of csrc/window_attention.cu, field for
    field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTRS]
                + [("scale", ctypes.c_double)]
                + [(f, ctypes.c_longlong) for f in _INTS]
                + [("plan", TcPlan)])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("window_attention")
    for entry in LAUNCHES:
        fn = getattr(lib, f"mmst_{entry}")
        fn.argtypes = [ctypes.POINTER(AttnArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mmst_window_attention_smem_bytes.argtypes = [ctypes.c_longlong] * 6
    lib.mmst_window_attention_smem_bytes.restype = ctypes.c_longlong
    lib.mmst_window_attention_attributes.argtypes = (
        [ctypes.c_longlong] * 4 + [ctypes.POINTER(ctypes.c_longlong)] * 4)
    lib.mmst_window_attention_attributes.restype = ctypes.c_int
    return lib


def _plan(n: int, c: int, heads: int, nv: int, dtype: torch.dtype,
          backward: bool):
    return (attn_bwd_plan if backward else attn_fwd_plan)(n, c, heads, nv,
                                                          dtype)


def smem_bytes(n: int, c: int, heads: int, dtype: torch.dtype, nv: int,
               backward: bool) -> int:
    """Dynamic shared memory one block of the call's body takes: the
    direction's tensor-core body where its plan says so, else the scalar
    body."""
    plan = _plan(n, c, heads, nv, dtype, backward)
    if plan.body == "tc":
        return plan.smem_bytes
    return _lib().mmst_window_attention_smem_bytes(
        n, c, heads, torch.finfo(dtype).bits // 8, nv, int(backward))


def kernel_attributes(plan, dtype: torch.dtype, nv: int, backward: bool
                      ) -> Tuple[int, int, int, int]:
    """(static shared memory bytes per block, dynamic shared memory opted
    in so far on this device, registers per thread, local memory bytes per
    thread -- spills) of the kernel a call runs: the direction's
    tensor-core kernel of ``plan``'s form (an AttnFwdPlan or AttnBwdPlan),
    or the scalar kernel of the direction at ``dtype`` (``plan`` None or
    scalar)."""
    vals = [ctypes.c_longlong() for _ in range(4)]
    body = plan.blocks_per_sm if plan is not None and plan.body == "tc" else 0
    err = _lib().mmst_window_attention_attributes(
        body, nv, int(dtype == torch.bfloat16), int(backward),
        *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes: CUDA error {err}")
    return tuple(v.value for v in vals)


def _aligned(*tensors: torch.Tensor) -> None:
    """The bf16 weight-gradient product (csrc/grad_common.cuh) reads its
    row operands 16 bytes a piece, and the tensor-core bodies
    (csrc/attn_tc.cuh, csrc/attn_fwd_tc.cuh) their inputs and weights."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the bf16 kernels' inputs and output gradients "
                         "must start on 16-byte boundaries")


def _check(xs: Sequence[torch.Tensor], projs: Sequence[Proj], bias, mask,
           heads: int, backward: bool):
    """What the kernels take (nv = the value streams among xs after q and
    k); returns (b, nw, n, c)."""
    t = xs[0].dtype
    if t not in (torch.float32, torch.bfloat16):
        raise TypeError(f"inputs are {t}; the kernels take float32 or "
                        "bfloat16")
    if xs[0].dim() != 4:
        raise ValueError(f"inputs have shape {tuple(xs[0].shape)}, not "
                         "(B, nW, N, C)")
    b, nw, n, c = xs[0].shape
    if c % heads or c % 32:
        raise ValueError(f"C={c} must divide by heads={heads} and by 32")
    dev = xs[0].device
    for i, x in enumerate(xs):
        _need(f"input {i}", x, (b, nw, n, c), t, dev)
    for p in projs:
        if tuple(p.w.shape) != (c, c) or p.w.device != dev or (
                p.b is not None and (tuple(p.b.shape) != (c,)
                                     or p.b.device != dev)):
            raise ValueError(f"a projection of shape {tuple(p.w.shape)} on "
                             f"{p.w.device} does not fit C={c} on {dev}")
    _need("bias", bias, (heads, n, n), torch.float32, dev)
    if mask is not None:
        _need("mask", mask, (nw, n, n), torch.float32, dev)
    if t == torch.bfloat16 and (
            backward or _plan(n, c, heads, len(xs) - 2, t, False).body
            == "tc"):
        _aligned(*xs)
    smem = smem_bytes(n, c, heads, t, len(xs) - 2, backward)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"N={n}, C={c} needs {smem} bytes of shared memory "
                         "per block")
    return b, nw, n, c


def _operands(projs: dict, t: torch.dtype, x: torch.Tensor,
              transposed: bool) -> dict:
    """Matrices in T (and their transposes for the backward), biases in
    float32 (zeros where the layer has none)."""
    ops = {}
    for name, p in projs.items():
        w = p.w.to(t).contiguous()
        ops[f"w{name}"] = w
        ops[f"b{name}"] = _bias(p.b, w.shape[0], x).contiguous()
        if transposed:
            ops[f"w{name}t"] = w.T.contiguous()
    return ops


def _call(entry: str, keep: dict, x: torch.Tensor, heads: int, nv: int,
          wsplit: int = 1, plan=None) -> None:
    b, nw, n, c = x.shape
    if plan is not None and plan.body == "tc":
        _aligned(*(keep[f] for f in _PTRS
                   if f.startswith("w") and keep.get(f) is not None))
    args = AttnArgs(
        **{f: (keep[f].data_ptr() if keep.get(f) is not None else None)
           for f in _PTRS},
        scale=(c // heads) ** -0.5, dtype=int(x.dtype == torch.bfloat16),
        B=b, nW=nw, N=n, C=c, heads=heads, nv=nv, wsplit=wsplit,
        plan=TcPlan() if plan is None else TcPlan.of(plan))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(_lib(), f"mmst_{entry}")(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    LAUNCHES[entry] += 1


def _bwd_scratch(x: torch.Tensor, heads: int,
                 nv: int) -> Tuple[dict, int]:
    """The backward's outputs and device scratch, and its row chunks for
    the weight gradients."""
    b, nw, n, c = x.shape
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    rows = b * nw * n
    wsplit = weight_splits(rows, c, c, x.dtype)
    return dict(
        part_vec=torch.empty((b * nw, (4 if nv == 1 else 3) * c), **f32),
        part_bias=torch.empty((b * nw, heads * n * n), **f32),
        part_w=torch.empty((wsplit, c * c), **f32),
        dbias=torch.empty((heads, n, n), **f32), dbp=torch.empty(c, **f32),
        dwp=torch.empty((c, c), **f32),
        **{f"o{s}_t": torch.empty_like(x) for s in range(nv)},
        **{f"dv{s}_t": torch.empty_like(x) for s in range(nv)},
        **{f"dwv{s}": torch.empty((c, c), **f32) for s in range(nv)},
        **{f"dbv{s}": torch.empty(c, **f32) for s in range(nv)},
        **{f"dv{s}": torch.empty_like(x) for s in range(nv)},
        dq=torch.empty_like(x), dk=torch.empty_like(x)), wsplit


def window_attention_fwd_kernel(q, k, v, wq, wk, wv, wp, bias, mask, heads):
    _check((q, k, v), (wq, wk, wv, wp), bias, mask, heads, False)
    keep = dict(_operands({"q": wq, "k": wk, "v0": wv, "p": wp}, q.dtype, q,
                          False),
                q=q, k=k, v0=v, out0=torch.empty_like(q), rel_bias=bias,
                mask=mask)
    _call("window_attention", keep, q, heads, 1, plan=attn_fwd_plan(
        *q.shape[2:], heads, 1, q.dtype))
    return keep["out0"]


def _grad(g: torch.Tensor, t: torch.dtype) -> torch.Tensor:
    """An output gradient as the backward kernels read it: contiguous in
    T, 16-byte aligned at bf16."""
    g = g.to(t).contiguous()
    if t == torch.bfloat16:
        _aligned(g)
    return g


def window_attention_bwd_kernel(g, q, k, v, wq, wk, wv, wp, bias, mask,
                                heads):
    _check((q, k, v), (wq, wk, wv, wp), bias, mask, heads, True)
    scratch, wsplit = _bwd_scratch(q, heads, 1)
    f32 = dict(dtype=torch.float32, device=q.device)
    c = q.shape[-1]
    keep = dict(_operands({"q": wq, "k": wk, "v0": wv, "p": wp}, q.dtype, q,
                          True),
                **scratch, q=q, k=k, v0=v,
                g0=_grad(g, q.dtype), rel_bias=bias, mask=mask,
                dq_t=torch.empty_like(q), dk_t=torch.empty_like(q),
                dwq=torch.empty((c, c), **f32), dwk=torch.empty((c, c), **f32),
                dbq=torch.empty(c, **f32), dbk=torch.empty(c, **f32))
    _call("window_attention_bwd", keep, q, heads, 1, wsplit,
          attn_bwd_plan(*q.shape[2:], heads, 1, q.dtype))
    return tuple(keep[f] for f in (
        "dq", "dk", "dv0", "dwq", "dbq", "dwk", "dbk", "dwv0", "dbv0", "dwp",
        "dbp", "dbias"))


def window_attention_dual_fwd_kernel(q, k, v_scale, v_shift, wvs, wvh, wp,
                                     bias, mask, heads):
    _check((q, k, v_scale, v_shift), (wvs, wvh, wp), bias, mask, heads,
           False)
    keep = dict(_operands({"v0": wvs, "v1": wvh, "p": wp}, q.dtype, q,
                          False),
                q=q, k=k, v0=v_scale, v1=v_shift, out0=torch.empty_like(q),
                out1=torch.empty_like(q), rel_bias=bias, mask=mask)
    _call("window_attention_dual", keep, q, heads, 2, plan=attn_fwd_plan(
        *q.shape[2:], heads, 2, q.dtype))
    return keep["out0"], keep["out1"]


def window_attention_dual_bwd_kernel(g_sigma, g_mu, q, k, v_scale, v_shift,
                                     wvs, wvh, wp, bias, mask, heads):
    _check((q, k, v_scale, v_shift), (wvs, wvh, wp), bias, mask, heads,
           True)
    scratch, wsplit = _bwd_scratch(q, heads, 2)
    t = q.dtype
    keep = dict(_operands({"v0": wvs, "v1": wvh, "p": wp}, t, q, True),
                **scratch, q=q, k=k, v0=v_scale, v1=v_shift,
                g0=_grad(g_sigma, t), g1=_grad(g_mu, t),
                rel_bias=bias, mask=mask)
    _call("window_attention_dual_bwd", keep, q, heads, 2, wsplit,
          attn_bwd_plan(*q.shape[2:], heads, 2, t))
    return tuple(keep[f] for f in (
        "dq", "dk", "dv0", "dv1", "dwv0", "dbv0", "dwv1", "dbv1", "dwp",
        "dbp", "dbias"))


def _grad_of(p_b: Optional[torch.Tensor], d: torch.Tensor):
    return None if p_b is None else d.to(p_b.dtype)


class _WindowAttention(torch.autograd.Function):
    """K8 with its backward: the kernels for CUDA tensors, the plain
    versions for CPU tensors; the inputs are the only residuals."""

    @staticmethod
    def forward(ctx, q, k, v, wq, bq, wk, bk, wv, bv, wp, bp, bias, mask,
                heads):
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, wq, bq, wk, bk, wv, bv, wp, bp, bias,
                              mask)
        projs = (Proj(wq, bq), Proj(wk, bk), Proj(wv, bv), Proj(wp, bp))
        if _on_cuda(q):
            return window_attention_fwd_kernel(q, k, v, *projs, bias, mask,
                                               heads)
        return window_attention_plain(q, k, v, *projs, bias, mask, heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, wq, bq, wk, bk, wv, bv, wp, bp, bias, mask = \
            ctx.saved_tensors
        projs = (Proj(wq, bq), Proj(wk, bk), Proj(wv, bv), Proj(wp, bp))
        bwd = (window_attention_bwd_kernel if _on_cuda(q)
               else window_attention_bwd_plain)
        (dq, dk, dv, dwq, dbq, dwk, dbk, dwv, dbv, dwp, dbp,
         dbias) = bwd(g.contiguous(), q, k, v, *projs, bias, mask,
                      ctx.heads)
        return (dq, dk, dv, dwq.to(wq.dtype), _grad_of(bq, dbq),
                dwk.to(wk.dtype), _grad_of(bk, dbk), dwv.to(wv.dtype),
                _grad_of(bv, dbv), dwp.to(wp.dtype), _grad_of(bp, dbp),
                dbias.to(bias.dtype), None, None)


class _WindowAttentionDual(torch.autograd.Function):
    """K9 with its backward, as ``_WindowAttention``."""

    @staticmethod
    def forward(ctx, q, k, v_scale, v_shift, wvs, bvs, wvh, bvh, wp, bp,
                bias, mask, heads):
        ctx.heads = heads
        ctx.save_for_backward(q, k, v_scale, v_shift, wvs, bvs, wvh, bvh,
                              wp, bp, bias, mask)
        projs = (Proj(wvs, bvs), Proj(wvh, bvh), Proj(wp, bp))
        if _on_cuda(q):
            return window_attention_dual_fwd_kernel(
                q, k, v_scale, v_shift, *projs, bias, mask, heads)
        return window_attention_dual_plain(q, k, v_scale, v_shift, *projs,
                                           bias, mask, heads)

    @staticmethod
    def backward(ctx, g_sigma, g_mu):
        (q, k, v_scale, v_shift, wvs, bvs, wvh, bvh, wp, bp, bias,
         mask) = ctx.saved_tensors
        projs = (Proj(wvs, bvs), Proj(wvh, bvh), Proj(wp, bp))
        if g_sigma is None:
            g_sigma = torch.zeros_like(q)
        if g_mu is None:
            g_mu = torch.zeros_like(q)
        bwd = (window_attention_dual_bwd_kernel if _on_cuda(q)
               else window_attention_dual_bwd_plain)
        (dq, dk, dvs, dvh, dwvs, dbvs, dwvh, dbvh, dwp, dbp,
         dbias) = bwd(g_sigma.contiguous(), g_mu.contiguous(), q, k,
                      v_scale, v_shift, *projs, bias, mask, ctx.heads)
        return (dq, dk, dvs, dvh, dwvs.to(wvs.dtype), _grad_of(bvs, dbvs),
                dwvh.to(wvh.dtype), _grad_of(bvh, dbvh), dwp.to(wp.dtype),
                _grad_of(bp, dbp), dbias.to(bias.dtype), None, None)


def _p(params: dict) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    return params["kernel"], params.get("bias")


def window_attention(params: dict, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], heads: int
                     ) -> torch.Tensor:
    """K8 on raw window inputs (B, nW, N, C), params {"wq", "wk", "wv",
    "proj"} in the JAX layout; bias (heads, N, N) float32, mask (nW, N, N)
    float32 or None."""
    return _WindowAttention.apply(q, k, v, *_p(params["wq"]),
                                  *_p(params["wk"]), *_p(params["wv"]),
                                  *_p(params["proj"]), bias, mask, heads)


def window_attention_dual(params: dict, q: torch.Tensor, k: torch.Tensor,
                          v_scale: torch.Tensor, v_shift: torch.Tensor,
                          bias: torch.Tensor, mask: Optional[torch.Tensor],
                          heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 on projected q, k and the raw value streams, params {"wv_scale",
    "wv_shift", "proj"}."""
    return _WindowAttentionDual.apply(
        q, k, v_scale, v_shift, *_p(params["wv_scale"]),
        *_p(params["wv_shift"]), *_p(params["proj"]), bias, mask, heads)
