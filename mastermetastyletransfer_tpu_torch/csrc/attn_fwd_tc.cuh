// K8's and K9's forward on Hopper's tensor cores: the bf16 body of
// mmst_window_attention (NV = 1) and mmst_window_attention_dual (NV = 2)
// (window_attention.cu has the functions and the launch,
// ops/window_attention.py:attn_fwd_plan the tiling, attn_fwd_layout the
// shared memory, attn_fwd_tile_schedule the order of the weight tiles, and
// tests/test_torch_attn_tc_plan.py replays it in torch). It computes what
// attn_fwd_kernel (window_attention.cu) computes, with the same rounding
// points (pallas_attention.py:_kernel, _kernel_dual through _attend_heads):
// NV 1 q = round((x Wq + bq) scale), k and v rounded after their f32
// projection; NV 2 qs = round(q scale), k as it comes, each value stream
// rounded after its projection; the softmax numerators rounded before the
// value product; the head outputs round((e v) / sum e); out = round(heads
// Wp + bp). Only the order of the f32 sums differs.
//
// Built from K1's pieces (window_tc.cuh) and the backward's
// (attn_tc.cuh): the weight ring TcRing over a tile schedule of its own
// (AttnFwdTiles) and its 64-row panel product with a bias epilogue, a head
// group's attention with the scores and the softmax in registers
// (tc_attend_group), the input tiles by cp.async with zero-filled pad rows
// (at_copy_rows).
//
// What bounds it: per window 8 N C^2 (NV 1) or 4 (NV + 1) N C^2 (NV 2)
// operations of projections and 4 N^2 C per stream of attention, against
// a few window tiles of bytes: the tensor cores.
//
// One block per (window, image), on the window's N <= 64 tokens padded to
// 64 rows: pad rows of every input tile are zeros, pad keys get -inf before
// the softmax, pad query rows attend to the real keys and are never stored.
// Per head group gi (128 columns of C, four heads):
//   NV 1: q, k and v in turn: the window's 64 x C input tile by cp.async,
//     then the 64-row panel product with the ring's tiles of the group's
//     columns of wq, wk, wv, the bias (and q's scale) in the epilogue, into
//     the group's q, k, v panels (64 x 128 each); then the group's
//     attention into its columns of the head-output tile;
//   NV 2: q (scaled, rounded) and k copied in; then per value stream, as
//     K4 does (tail_tc.cuh): its input tile, its panel through the ring,
//     the group's attention into the stream's head-output tile -- the
//     softmax recomputed for the second stream (2 N^2 C a head, under 2%
//     of the work), one v panel and one accumulator set.
// Then per stream, per 128-column panel of C: out_s = heads_s Wp + bp,
// stored to the output from the epilogue (wp streamed once per stream).
//
// Forms (ops/window_attention.py:ATTN_FWD_FORMS; attn_fwd_plan takes the
// first whose shared memory fits a block's share of an SM): two blocks of
// 8 warps an SM with a ring of 2 tiles of 32 rows (C = 128, one value
// stream: 104,448 bytes), 16% faster than one block at the Swin's stage 1;
// else one block of 16 warps with a ring of 2 tiles of 64 rows (154,624
// bytes for K8 at C = 256, 188,416 for K9), 2-3% faster than a ring of 3
// (PERF.md). Shared memory (attn_fwd_tc_layout): NV head-output
// tiles and the input tile (64 x (C + 8) bf16 each), the q, k, v panels
// (64 x 136 bf16 each) and the ring (S x kp x 136 bf16).

#pragma once

#include "attn_tc.cuh"

namespace {

// Shared memory of the forward body (ops/window_attention.py:
// attn_fwd_layout computes the same).
struct AttnFwdTcLayout {
  size_t ob, x, panels, ring, total;
};

__host__ __device__ inline AttnFwdTcLayout attn_fwd_tc_layout(int c, int nv,
                                                              int kp,
                                                              int stages) {
  AttnFwdTcLayout l;
  const size_t tile = 2 * kTcRows * (c + 8);
  size_t o = 0;
  l.ob = o;     o = align16(o + nv * tile);
  l.x = o;      o = align16(o + tile);
  l.panels = o; o = align16(o + 3 * 2 * kTcRows * kTcLdp);
  l.ring = o;   o = align16(o + 2 * stages * kp * kTcLdp);
  l.total = o;
  return l;
}

// The forward's weight tiles in the order its body uses them
// (ops/window_attention.py:attn_fwd_tile_schedule): per head group gi the
// group's 128-wide panels of its projections over K = C (NV 1: wq, wk,
// wv0; NV 2: wv0, wv1), then per value stream the 128-column panels of wp
// over K = C. Every matrix is C x C, row-major.
struct AttnFwdTiles {
  using bf16 = __nv_bfloat16;
  const bf16 *p0, *p1, *p2, *wp;
  int C, kp, np, nk, npan, t1, total;

  __device__ __forceinline__ AttnFwdTiles(const bf16* p0_, const bf16* p1_,
                                          const bf16* p2_, const bf16* wp_,
                                          int np_, int nv, int C_, int kp_)
      : p0(p0_), p1(p1_), p2(p2_), wp(wp_), C(C_), kp(kp_), np(np_) {
    nk = C / kp;
    npan = C / kTcPanel;
    t1 = npan * np * nk;
    total = t1 + nv * npan * nk;
  }

  __device__ __forceinline__ const bf16* tile(int u, int& ld,
                                              int& width) const {
    ld = C;
    width = kTcPanel;
    if (u < t1) {
      const int gi = u / (np * nk), part = (u / nk) % np, kt = u % nk;
      const bf16* w = part == 0 ? p0 : part == 1 ? p1 : p2;
      return w + static_cast<long long>(kt * kp) * C + gi * kTcPanel;
    }
    const int v = u - t1, pn = (v / nk) % npan, kt = v % nk;
    return wp + static_cast<long long>(kt * kp) * C + pn * kTcPanel;
  }
};

// The body on one window (blockIdx.x) of one image (blockIdx.y): a block of
// NT threads, a ring of S weight tiles of a.plan.kp rows. Fields of A as
// window_attention.cu's AttnArgs; a.plan checked by the caller.
template <int NV, int NT, int S, typename A>
__device__ __forceinline__ void attn_fwd_tc(const A& a, unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  constexpr int GW = kAtGroup, DH = kAtDh, LDP = kTcLdp;
  static_assert(GW == kTcPanel, "a head group is one panel of the ring");
  const int tid = threadIdx.x;
  const int C = static_cast<int>(a.C), N = static_cast<int>(a.N);
  const int kp = static_cast<int>(a.plan.kp), LDA = C + 8;
  const long long base =
      (static_cast<long long>(blockIdx.y) * a.nW + blockIdx.x) * N * C;
  const float scale = static_cast<float>(a.scale);
  const AttnFwdTcLayout L = attn_fwd_tc_layout(C, NV, kp, S);
  bf16* ob[2] = {reinterpret_cast<bf16*>(smem + L.ob),
                 reinterpret_cast<bf16*>(smem + L.ob) +
                     (NV == 2 ? kTcRows * LDA : 0)};
  bf16* X = reinterpret_cast<bf16*>(smem + L.x);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.panels);
  bf16* ks = qs + kTcRows * LDP;
  bf16* vs = ks + kTcRows * LDP;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* vin[2] = {static_cast<const bf16*>(a.v0) + base,
                        static_cast<const bf16*>(NV == 2 ? a.v1 : a.v0) +
                            base};
  const float* mask_w =
      a.mask != nullptr ? a.mask + static_cast<long long>(blockIdx.x) * N * N
                        : nullptr;
  // The projections of a group, in the schedule's order: NV 1 q, k, v0
  // into qs (scaled), ks, vs; NV 2 v0, v1 into vs, each followed by its
  // stream's attention.
  constexpr int NP = NV == 1 ? 3 : 2;
  auto xin = [&](int p) {
    return NV == 1 ? (p == 0 ? q : p == 1 ? k : vin[0]) : vin[p];
  };
  auto bias_of = [&](int p) {
    return NV == 1 ? (p == 0 ? a.bq : p == 1 ? a.bk : a.bv0)
                   : (p == 0 ? a.bv0 : a.bv1);
  };
  TcRing<S, NT, AttnFwdTiles> ring(
      AttnFwdTiles(static_cast<const bf16*>(NV == 1 ? a.wq : a.wv0),
                   static_cast<const bf16*>(NV == 1 ? a.wk : a.wv1),
                   static_cast<const bf16*>(a.wv0),
                   static_cast<const bf16*>(a.wp), NP, NV, C, kp),
      reinterpret_cast<bf16*>(smem + L.ring), kp);
  ring.start();

  for (int gi = 0; gi < C / GW; ++gi) {
    const int c0 = gi * GW;
    if (NV == 2) {
      // q scaled and rounded, k as it comes, pad rows zero (every warp is
      // past the previous group's attention: the barrier).
      __syncthreads();
      constexpr int vpg = GW >> 3;
      for (int i = tid; i < kTcRows * vpg; i += NT) {
        const int r = i / vpg, c = (i - r * vpg) * 8;
        uint4 uq = make_uint4(0u, 0u, 0u, 0u), uk = uq;
        if (r < N) {
          const long long off = static_cast<long long>(r) * C + c0 + c;
          const uint4 raw = *reinterpret_cast<const uint4*>(q + off);
          uq.x = scale_bf16x2(raw.x, scale);
          uq.y = scale_bf16x2(raw.y, scale);
          uq.z = scale_bf16x2(raw.z, scale);
          uq.w = scale_bf16x2(raw.w, scale);
          uk = *reinterpret_cast<const uint4*>(k + off);
        }
        *reinterpret_cast<uint4*>(qs + r * LDP + c) = uq;
        *reinterpret_cast<uint4*>(ks + r * LDP + c) = uk;
      }
    }
    for (int p = 0; p < NP; ++p) {
      // Every warp past its last read of the input tile (the previous
      // product) and of the panel this product writes (an attention).
      __syncthreads();
      at_copy_rows<NT>(xin(p), C, C, N, X, LDA);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      ring.gemm(X, LDA, C, GW);
      bf16* dst = NV == 1 ? (p == 0 ? qs : p == 1 ? ks : vs) : vs;
      const float mul = NV == 1 && p == 0 ? scale : 1.f;
      ring.epilogue(GW, bias_of(p) + c0,
                    [&](int r, int c, float a0, float a1, float b0,
                        float b1) {
        *reinterpret_cast<uint32_t*>(dst + r * LDP + c) =
            pack_bf16x2((a0 + b0) * mul, (a1 + b1) * mul);
      });
      if (NV == 2 || p == NP - 1) {
        __syncthreads();
        tc_attend_group<DH, NT>(qs, ks, vs, ob[NV == 2 ? p : 0], LDA, c0, GW,
                                N, mask_w, a.rel_bias);
      }
    }
  }

  // out_s = heads_s Wp + bp per 128-column panel (the product's first
  // barrier: every warp is past the attention).
  for (int s = 0; s < NV; ++s) {
    bf16* out = static_cast<bf16*>(s == 0 ? a.out0 : a.out1) + base;
    for (int pn = 0; pn < C / kTcPanel; ++pn) {
      ring.gemm(ob[s], LDA, C, kTcPanel);
      ring.epilogue(kTcPanel, a.bp + pn * kTcPanel,
                    [&](int r, int c, float a0, float a1, float b0,
                        float b1) {
        if (r < N)
          *reinterpret_cast<uint32_t*>(out + static_cast<long long>(r) * C +
                                       pn * kTcPanel + c) =
              pack_bf16x2(a0 + b0, a1 + b1);
      });
    }
  }
}

}  // namespace
