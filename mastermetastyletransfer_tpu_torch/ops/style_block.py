"""The style transformer's per-window kernels (JAX counterparts: the Pallas
kernels K3 ``fused_encoder_scale_shift`` and K4 ``fused_decoder_tail`` in
ops/pallas_attention.py), over the window tensors (B, nW, N, C) of the
window-resident path (models/style_transformer.py).

* ``encoder_scale_shift``: the encoder's Scale and Shift update. One shared
  softmax from the (LN1'd, pad-zeroed) Key, two value streams through one
  wv and proj, residuals onto the raw Scale and Shift, then each stream's
  norm-free MLP residual (reference: codes/style_transformer.py:867-882);
* ``decoder_tail``: the decoder's dual-value attention from prepared q and
  k, sigma and mu through the shared proj, Query * sigma + mu, then the
  norm-free last-MLP residual (reference: codes/style_transformer.py:
  1059-1125).

Both are one CUDA source (csrc/style_block.cu), each with two bodies. At
bfloat16, where the plans below say so -- the style transformer at C =
256 --, tensor-core bodies built from K1's pieces (csrc/window_tc.cuh): K3's
(csrc/style_tc.cuh; ``style_plan``, ``style_layout``; its weights in K1's
order, ops/window_block.py:tile_schedule, the MLP being the stream's own)
and K4's (csrc/tail_tc.cuh; ``tail_plan``, ``tail_layout``,
``tail_tile_schedule``: both value streams in one block, wp streamed twice
for sigma and mu), which tests/test_torch_style_tc_plan.py and
tests/test_torch_tail_tc_plan.py replay in torch on the CPU. At float32
(no TF32), and for any other shape, the scalar bodies.

Each wrapper runs its kernel for a CUDA tensor and the plain PyTorch
version below for a CPU tensor; any other device raises. The plain version
is the yardstick the kernel is held to: it rounds to the input type where
the kernel and the JAX kernel round, and computes GELU with the exact erf
(the JAX kernels use the Abramowitz-Stegun erf, |err| <= 1.5e-7).

``LAUNCHES`` counts kernel launches per entry; a wrapper adds one only where
it launches its kernel. Both kernels are for evaluation: under autograd
their CUDA branches raise (ops/window_block.py:refuse_grad).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mastermetastyletransfer_tpu_torch.ops import _build
from mastermetastyletransfer_tpu_torch.ops.window_block import (
    MAX_SMEM_BYTES, TC_PANEL, TC_ROWS, BlockPlan, TcPlan, _align16, _ln,
    _mat, _need, _on_cuda, _vec, attend, mlp_tile_schedule, refuse_grad,
)
from mastermetastyletransfer_tpu_torch.ops.windows import (
    relative_position_bias,
)

LAUNCHES = {"encoder_scale_shift": 0, "decoder_tail": 0}


class EncoderWeights(NamedTuple):
    """The encoder's shared attention and its Scale/Shift MLPs as the kernel
    takes them: matrices in the compute type, everything else float32."""
    wqkv: torch.Tensor      # (C, 3C) = [wq | wk | wv]
    bqkv: torch.Tensor      # (3C,)
    wp: torch.Tensor        # (C, C)
    bp: torch.Tensor        # (C,)
    rel_bias: torch.Tensor  # (heads, N, N)
    n1s: Optional[torch.Tensor]
    n1b: Optional[torch.Tensor]
    s_w1: torch.Tensor      # (C, hidden), the Scale stream's MLP
    s_b1: torch.Tensor
    s_w2: torch.Tensor      # (hidden, C)
    s_b2: torch.Tensor
    h_w1: torch.Tensor      # the Shift stream's MLP
    h_b1: torch.Tensor
    h_w2: torch.Tensor
    h_b2: torch.Tensor


class DecoderTailWeights(NamedTuple):
    """The decoder's dual-value attention and its last MLP."""
    wv: torch.Tensor        # (C, 2C) = [wv_scale | wv_shift]
    bv: torch.Tensor        # (2C,)
    wp: torch.Tensor        # (C, C)
    bp: torch.Tensor        # (C,)
    rel_bias: torch.Tensor  # (heads, N, N)
    w1: torch.Tensor        # (C, hidden)
    b1: torch.Tensor
    w2: torch.Tensor        # (hidden, C)
    b2: torch.Tensor


def _mlp(mlp: dict, dtype: torch.dtype):
    hidden = mlp["fc1"]["kernel"].shape[1]
    c = mlp["fc2"]["kernel"].shape[1]
    return (_mat(mlp["fc1"], dtype), _vec(mlp["fc1"], hidden),
            _mat(mlp["fc2"], dtype), _vec(mlp["fc2"], c))


def encoder_weights(attn: dict, mlp_scale: dict, mlp_shift: dict,
                    norm1: Optional[dict], window: Tuple[int, int],
                    dtype: torch.dtype) -> EncoderWeights:
    """From the JAX layout: the shared MHA's ``attn`` dict, the two MLPs,
    and the optional LN1 ({"scale", "bias"} or None)."""
    c = attn["wq"]["kernel"].shape[0]
    return EncoderWeights(
        wqkv=torch.cat([_mat(attn[k], dtype) for k in ("wq", "wk", "wv")], 1),
        bqkv=torch.cat([_vec(attn[k], c) for k in ("wq", "wk", "wv")]),
        wp=_mat(attn["proj"], dtype), bp=_vec(attn["proj"], c),
        rel_bias=relative_position_bias(
            attn["rel_bias_table"].float(), *window).contiguous(),
        n1s=None if norm1 is None else norm1["scale"].float().contiguous(),
        n1b=None if norm1 is None else norm1["bias"].float().contiguous(),
        **dict(zip(("s_w1", "s_b1", "s_w2", "s_b2"), _mlp(mlp_scale, dtype))),
        **dict(zip(("h_w1", "h_b1", "h_w2", "h_b2"), _mlp(mlp_shift, dtype))))


def decoder_tail_weights(dual: dict, last_mlp: dict, window: Tuple[int, int],
                         dtype: torch.dtype) -> DecoderTailWeights:
    """From the JAX layout: the dual-value attention's dict and the last
    MLP."""
    c = dual["wv_scale"]["kernel"].shape[0]
    w1, b1, w2, b2 = _mlp(last_mlp, dtype)
    return DecoderTailWeights(
        wv=torch.cat([_mat(dual[k], dtype) for k in ("wv_scale", "wv_shift")],
                     1),
        bv=torch.cat([_vec(dual[k], c) for k in ("wv_scale", "wv_shift")]),
        wp=_mat(dual["proj"], dtype), bp=_vec(dual["proj"], c),
        rel_bias=relative_position_bias(
            dual["rel_bias_table"].float(), *window).contiguous(),
        w1=w1, b1=b1, w2=w2, b2=b2)


# ---------------------------------------------------------------------------
# K3's tensor-core plan (csrc/style_tc.cuh)
# ---------------------------------------------------------------------------

# K3's forms, in order of preference: one block of 16 warps an SM with a
# ring of 3 tiles of 64 weight rows (C % 64 == 0), else of 32.
STYLE_FORMS = ((1, 64, 3), (1, 32, 3))


def style_layout(n: int, c: int, kp: int, stages: int) -> dict:
    """Byte offsets and total of K3's tensor-core shared memory
    (csrc/style_tc.cuh:tc_style_layout): Key's normed view, the head
    outputs and the stream's normed view (64 x C bf16 each, rows padded by
    16 bytes), a head group's q, k and v, the ring, and the row statistics
    of both views. The f32 output sum (n x (C + 4) floats) takes the first
    two tiles' place once proj has read the head outputs."""
    tile = 2 * TC_ROWS * (c + 8)
    assert 4 * n * (c + 4) <= 2 * tile      # the f32 sum fits kt + ob
    sizes = (("kt", tile), ("ob", tile), ("vt", tile),
             ("qkv", 2 * 3 * TC_ROWS * (TC_PANEL + 8)),
             ("ring", 2 * stages * kp * (TC_PANEL + 8)),
             ("mean", 4 * 2 * TC_ROWS), ("rstd", 4 * 2 * TC_ROWS))
    out, o = {}, 0
    for name, size in sizes:
        out[name] = o
        o = _align16(o + size)
    out["xs"] = out["kt"]
    out["total"] = o
    return out


def tail_layout(n: int, c: int, kp: int, stages: int) -> dict:
    """Byte offsets and total of K4's tensor-core shared memory
    (csrc/tail_tc.cuh:tc_tail_layout): the two head-output tiles and the
    value view (64 x C bf16 each, rows padded by 16 bytes), a head group's
    q, k and v (sigma's f32 panel, 64 x 132 floats, in their place during
    proj), and the ring. The f32 output sum (n x (C + 4) floats) takes the
    two head tiles' place once proj has read them."""
    tile = 2 * TC_ROWS * (c + 8)
    qkv = 2 * 3 * TC_ROWS * (TC_PANEL + 8)
    assert 4 * n * (c + 4) <= 2 * tile      # the f32 sum fits ob_s + ob_h
    assert 4 * TC_ROWS * (TC_PANEL + 4) <= qkv   # sigma's panel fits
    sizes = (("ob_s", tile), ("ob_h", tile), ("vt", tile), ("qkv", qkv),
             ("ring", 2 * stages * kp * (TC_PANEL + 8)))
    out, o = {}, 0
    for name, size in sizes:
        out[name] = o
        o = _align16(o + size)
    out["xs"], out["sig"] = out["ob_s"], out["qkv"]
    out["total"] = o
    return out


def _plan(layout, n: int, c: int, heads: int, hidden: int,
          dtype: torch.dtype) -> BlockPlan:
    """K3's and K4's gate and forms: the tensor-core body at bfloat16 where
    N <= 64, C % 32 == 0, the head dim is 16, 32 or 64 and the MLP width a
    multiple of 128, in the first of STYLE_FORMS that C allows and whose
    ``layout`` fits a block's shared memory; else the scalar body."""
    dh = c // heads if heads else 0
    if (dtype == torch.bfloat16 and 1 <= n <= TC_ROWS and c % 32 == 0
            and dh * heads == c and dh in (16, 32, 64)
            and hidden >= TC_PANEL and hidden % TC_PANEL == 0):
        groups = tuple((c0, min(TC_PANEL, c - c0))
                       for c0 in range(0, c, TC_PANEL))
        for per_sm, kp, stages in STYLE_FORMS:
            if c % kp:
                continue
            smem = layout(n, c, kp, stages)["total"]
            if smem <= MAX_SMEM_BYTES:
                return BlockPlan("tc", TC_ROWS, TC_PANEL, kp, stages,
                                 per_sm, smem, groups)
    return BlockPlan("scalar", 0, 0, 0, 0, 0, 0, ())


@functools.lru_cache(maxsize=None)
def style_plan(n: int, c: int, heads: int, hidden: int,
               dtype: torch.dtype) -> BlockPlan:
    """The body one K3 call runs (``_plan`` over ``style_layout``): the
    tensor-core body at the style transformer's C = 256, the scalar body
    at f32."""
    return _plan(style_layout, n, c, heads, hidden, dtype)


@functools.lru_cache(maxsize=None)
def tail_plan(n: int, c: int, heads: int, hidden: int,
              dtype: torch.dtype) -> BlockPlan:
    """The body one K4 call runs (``_plan`` over ``tail_layout``, K3's
    gate): one block of 16 warps per window with a ring of 3 tiles of 64
    weight rows at the style transformer's C = 256; the scalar body at
    f32."""
    return _plan(tail_layout, n, c, heads, hidden, dtype)


def tail_tile_schedule(plan: BlockPlan, c: int, hidden: int
                       ) -> List[Tuple[str, int, int, int, int]]:
    """K4's weight tiles in the order its tensor-core body uses them, by
    the kernel's own arithmetic for tile t (csrc/tail_tc.cuh, TailTiles):
    (matrix, first row, first column, rows, width). Per value stream s and
    head group, wv's panel of the stream's columns over K = C; per panel of
    C, wp's panel over K = C twice (sigma, then mu); then the MLP as K1's
    (ops/window_block.py:tile_schedule)."""
    kp, p = plan.kp, plan.panel
    nk, ng = c // kp, -(-c // p)
    out = []
    for t in range(4 * ng * nk):
        if t < 2 * ng * nk:
            s, gi, kt = t // (ng * nk), (t // nk) % ng, t % nk
            out.append(("wv", kt * kp, s * c + gi * p, kp,
                        min(p, c - gi * p)))
        else:
            v = t - 2 * ng * nk
            pn, kt = v // (2 * nk), v % nk
            out.append(("wp", kt * kp, pn * p, kp, min(p, c - pn * p)))
    return out + mlp_tile_schedule(plan, c, hidden)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _mlp_residual(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """x + fc2(GELU(fc1 x)) on a T-typed x; the GELU output rounds to T."""
    hid = F.gelu(x.float() @ w1.float() + b1).to(x.dtype)
    return (x.float() + (hid.float() @ w2.float() + b2)).to(x.dtype)


def _zero_pad(x: torch.Tensor, padmask: Optional[torch.Tensor]):
    return x if padmask is None else x * padmask.to(x.dtype)[None, :, :, None]


def encoder_scale_shift_plain(key: torch.Tensor, scale_in: torch.Tensor,
                              shift_in: torch.Tensor, w: EncoderWeights, *,
                              heads: int,
                              mask: Optional[torch.Tensor] = None,
                              padmask: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Scale', Shift') from Key, Scale, Shift, all (B, nW, N, C)."""
    t = key.dtype
    c = key.shape[-1]

    def prep(x):
        if w.n1s is not None:
            x = _ln(x.float(), w.n1s, w.n1b).to(t)
        return _zero_pad(x, padmask)

    def proj(x, part):
        cols = slice(part * c, (part + 1) * c)
        return (x.float() @ w.wqkv[:, cols].float() + w.bqkv[cols]).to(t)

    qk = prep(key)
    q = (proj(qk, 0).float() * (c // heads) ** -0.5).to(t)
    a_s, a_h = attend(q, proj(qk, 1), (proj(prep(scale_in), 2),
                                       proj(prep(shift_in), 2)),
                      w.rel_bias, heads=heads, mask=mask)

    def update(raw, a, w1, b1, w2, b2):
        y = raw.float() + a.float() @ w.wp.float() + w.bp
        return _mlp_residual(y.to(t), w1, b1, w2, b2)

    return (update(scale_in, a_s, w.s_w1, w.s_b1, w.s_w2, w.s_b2),
            update(shift_in, a_h, w.h_w1, w.h_b1, w.h_w2, w.h_b2))


def decoder_tail_plain(q: torch.Tensor, k: torch.Tensor,
                       v_scale: torch.Tensor, v_shift: torch.Tensor,
                       query: torch.Tensor, w: DecoderTailWeights, *,
                       heads: int, mask: Optional[torch.Tensor] = None,
                       padmask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Query * sigma + mu -> + last MLP, all (B, nW, N, C); q and k are
    prepared (not re-zeroed here), the value streams raw."""
    t = q.dtype
    c = q.shape[-1]

    def proj(x, part):
        cols = slice(part * c, (part + 1) * c)
        return (_zero_pad(x, padmask).float() @ w.wv[:, cols].float()
                + w.bv[cols]).to(t)

    q = (q.float() * (c // heads) ** -0.5).to(t)
    a_s, a_h = attend(q, k, (proj(v_scale, 0), proj(v_shift, 1)),
                      w.rel_bias, heads=heads, mask=mask)
    sigma = a_s.float() @ w.wp.float() + w.bp
    mu = a_h.float() @ w.wp.float() + w.bp
    y = (query.float() * sigma + mu).to(t)
    return _mlp_residual(y, w.w1, w.b1, w.w2, w.b2)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_INTS = ("dtype", "B", "nW", "N", "C", "heads", "hidden")
_ENC_PTRS = ("key", "scale_in", "shift_in", "scale_out", "shift_out",
             "wqkv", "bqkv", "wp", "bp", "rel_bias", "mask", "padmask",
             "n1s", "n1b", "s_w1", "s_b1", "s_w2", "s_b2",
             "h_w1", "h_b1", "h_w2", "h_b2")
_DEC_PTRS = ("q", "k", "v_scale", "v_shift", "query", "out", "wv", "bv",
             "wp", "bp", "rel_bias", "mask", "padmask", "w1", "b1", "w2",
             "b2")


def _struct(name: str, ptrs) -> type:
    return type(name, (ctypes.Structure,), {"_fields_": (
        [(f, ctypes.c_void_p) for f in ptrs] + [("scale", ctypes.c_double)]
        + [(f, ctypes.c_longlong) for f in _INTS] + [("plan", TcPlan)])})


# The C structs of csrc/style_block.cu, field for field.
EncoderArgs = _struct("EncoderArgs", _ENC_PTRS)
DecoderTailArgs = _struct("DecoderTailArgs", _DEC_PTRS)
# Each entry's plan (the body and its tiling) and its C attributes entry.
_PLANS = {"encoder_scale_shift": style_plan, "decoder_tail": tail_plan}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("style_block")
    for entry, args in (("mmst_encoder_scale_shift", EncoderArgs),
                        ("mmst_decoder_tail", DecoderTailArgs)):
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mmst_style_block_smem_bytes.argtypes = [ctypes.c_longlong] * 4
    lib.mmst_style_block_smem_bytes.restype = ctypes.c_longlong
    for entry in _PLANS:
        fn = getattr(lib, f"mmst_{entry}_attributes")
        fn.argtypes = ([ctypes.c_longlong] * 3
                       + [ctypes.POINTER(ctypes.c_longlong)] * 3)
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(n: int, c: int, heads: int, dtype: torch.dtype,
               plan: Optional[BlockPlan] = None) -> int:
    """Shared memory one block of the call's body takes: the tensor-core
    body (K3's or K4's) where ``plan`` says so, else the scalar body of
    either kernel."""
    if plan is not None and plan.body == "tc":
        return plan.smem_bytes
    return _lib().mmst_style_block_smem_bytes(
        n, c, heads, torch.finfo(dtype).bits // 8)


def kernel_attributes(plan: BlockPlan, dtype: torch.dtype, dh: int,
                      entry: str = "encoder_scale_shift"
                      ) -> Tuple[int, int, int]:
    """(static shared memory bytes per block, dynamic shared memory opted
    in so far on this device, registers per thread) of the entry's kernel
    (K3's or K4's) that ``plan`` runs: the tensor-core kernel of head dim
    dh, or the scalar kernel at ``dtype``."""
    vals = [ctypes.c_longlong() for _ in range(3)]
    err = getattr(_lib(), f"mmst_{entry}_attributes")(
        int(plan.body == "tc"), int(dtype == torch.bfloat16), dh,
        *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes: CUDA error {err}")
    return tuple(v.value for v in vals)


def _weight_shapes(c: int, hidden: int, heads: int, n: int) -> dict:
    """The shape the kernels take for each field of the weight tuples."""
    mlp = {"w1": (c, hidden), "b1": (hidden,), "w2": (hidden, c), "b2": (c,)}
    return {"wqkv": (c, 3 * c), "bqkv": (3 * c,), "wv": (c, 2 * c),
            "bv": (2 * c,), "wp": (c, c), "bp": (c,),
            "rel_bias": (heads, n, n), "n1s": (c,), "n1b": (c,), **mlp,
            **{f"s_{k}": v for k, v in mlp.items()},
            **{f"h_{k}": v for k, v in mlp.items()}}


def _launch(entry: str, struct: type, windows: dict, w: NamedTuple, *,
            hidden: int, heads: int, mask: Optional[torch.Tensor],
            padmask: Optional[torch.Tensor]) -> None:
    """Check what the kernel takes and launch it. ``windows`` maps the
    struct's window-tensor fields, inputs and outputs, all (B, nW, N, C), to
    tensors; the first is the reference for shape, type and device. The
    struct's plan field gets the entry's plan (``_PLANS``)."""
    refuse_grad(entry, *windows.values(), *w, mask, padmask)
    x = next(iter(windows.values()))
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"inputs are {x.dtype}; the kernel takes float32 or "
                        "bfloat16")
    b, nw, n, c = x.shape
    if c % heads or hidden % c:
        raise ValueError(f"C={c} must divide by heads={heads} and the MLP "
                         f"width {hidden} by C")
    dev, f32 = x.device, torch.float32
    for name, t in windows.items():
        _need(name, t, x.shape, x.dtype, dev)
    shapes = _weight_shapes(c, hidden, heads, n)
    for name, t in w._asdict().items():
        if t is not None:
            # matrices in the compute type, vectors and the bias table f32
            matrix = len(shapes[name]) == 2
            _need(name, t, shapes[name], x.dtype if matrix else f32, dev)
    if mask is not None:
        _need("mask", mask, (nw, n, n), f32, dev)
    if padmask is not None:
        _need("padmask", padmask, (nw, n), f32, dev)
    plan = _PLANS[entry](n, c, heads, hidden, x.dtype)
    smem = smem_bytes(n, c, heads, x.dtype, plan)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"N={n}, C={c} needs {smem} bytes of shared memory "
                         f"per block, over the {MAX_SMEM_BYTES} available")

    keep = {**windows, **w._asdict(), "mask": mask, "padmask": padmask}
    ptrs = [f for f, kind in struct._fields_ if kind is ctypes.c_void_p]
    args = struct(
        **{f: (keep[f].data_ptr() if keep[f] is not None else None)
           for f in ptrs},
        scale=(c // heads) ** -0.5,
        dtype=1 if x.dtype == torch.bfloat16 else 0,
        B=b, nW=nw, N=n, C=c, heads=heads, hidden=hidden,
        plan=TcPlan.of(plan))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(_lib(), f"mmst_{entry}")(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    LAUNCHES[entry] += 1


def encoder_scale_shift(key: torch.Tensor, scale_in: torch.Tensor,
                        shift_in: torch.Tensor, w: EncoderWeights, *,
                        heads: int, mask: Optional[torch.Tensor] = None,
                        padmask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (Scale', Shift') from Key, Scale, Shift (B, nW, N, C); mask
    (nW, N, N) and padmask (nW, N) as ops/windows.py builds them."""
    if not _on_cuda(key):
        return encoder_scale_shift_plain(key, scale_in, shift_in, w,
                                         heads=heads, mask=mask,
                                         padmask=padmask)
    if (w.n1s is None) != (w.n1b is None):
        raise ValueError("LN1 needs both its scale and its bias")
    scale_out, shift_out = torch.empty_like(key), torch.empty_like(key)
    _launch("encoder_scale_shift", EncoderArgs,
            dict(key=key, scale_in=scale_in, shift_in=shift_in,
                 scale_out=scale_out, shift_out=shift_out), w,
            hidden=w.s_w1.shape[1], heads=heads, mask=mask, padmask=padmask)
    return scale_out, shift_out


def decoder_tail(q: torch.Tensor, k: torch.Tensor, v_scale: torch.Tensor,
                 v_shift: torch.Tensor, query: torch.Tensor,
                 w: DecoderTailWeights, *, heads: int,
                 mask: Optional[torch.Tensor] = None,
                 padmask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: the decoder tail on (B, nW, N, C) windows."""
    if not _on_cuda(q):
        return decoder_tail_plain(q, k, v_scale, v_shift, query, w,
                                  heads=heads, mask=mask, padmask=padmask)
    out = torch.empty_like(q)
    _launch("decoder_tail", DecoderTailArgs,
            dict(q=q, k=k, v_scale=v_scale, v_shift=v_shift, query=query,
                 out=out), w, hidden=w.w1.shape[1], heads=heads, mask=mask,
            padmask=padmask)
    return out
