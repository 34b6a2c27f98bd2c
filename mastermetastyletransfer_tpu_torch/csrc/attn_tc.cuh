// K8's and K9's backward on Hopper's tensor cores: the bf16 body of
// mmst_window_attention_bwd (NV = 1) and mmst_window_attention_dual_bwd
// (NV = 2) (window_attention.cu has the functions and the launch,
// ops/window_attention.py:attn_bwd_plan the tiling, attn_bwd_layout the
// shared memory, attn_bwd_tile_schedule the order of the weight tiles, and
// tests/test_torch_attn_tc_plan.py replays it in torch). It computes what
// attn_bwd_kernel (window_attention.cu) computes, with the same rounding
// points; only the order of the f32 sums differs.
//
// Built from K1's and K10's pieces (window_tc.cuh): the weight ring TcRing
// over a tile schedule and its 64-row panel product, the scores and the
// softmax of a (head, m16 tile) in a warp's registers as tc_attend_group
// computes them, and A^T's fragments by ldmatrix.trans as
// grad_common.cuh:wgrad_tc_kernel reads them.
//
// What bounds it: per window 6 N C^2 (NV = 2) or 8 N C^2 (NV = 1)
// operations of projections and 8 to 10 N^2 C of attention, against a few
// window tiles of bytes: the tensor cores.
//
// One block per (window, image), on the window's N <= 64 tokens padded to
// 64 rows. Pad rows of every input tile are zeros; pad keys get -inf before
// the softmax, so P is 0 on them, and so are dS and every product through
// P or dS there. Pad query rows attend to the real keys (their P is not 0),
// but their g rows are zero, so dO, dP and dS are exactly 0 on them, and
// their share of P^T dO and dS^T q is 0: their rows are never stored,
// never summed into a partial, and no mask or bias is read for them.
//
// Per head group gi (gw columns of C, gw / 32 heads):
//   1. the panels of the group's columns, each a 64-row panel product of a
//      window input (a 64 x C tile, copied in by cp.async) and the ring's
//      tiles: NV 1 qs = round((q Wq + bq) scale), qc = round(q Wq + bq),
//      k, v, dO = round(g Wp^T); NV 2 the two value streams and the two
//      dO (wpt streamed once per stream), q and k copied in (qs = round(q
//      scale) in registers);
//   2. rows: a warp per (head, m16 tile of queries): S = qs k^T + mask +
//      bias, P = softmax(S) in f32 in registers; round(P) to shared memory
//      and as the A fragments of o_s = round(P) v_s (round(o_s) to the o_t
//      scratch, for dWp); dP = sum_s dO_s v_s^T, dS = P (dP - rowsum(dP P))
//      in f32 (its f32 values to part_bias), round(dS) to shared memory and
//      as the A fragments of dq = scale round(dS) k;
//   3. columns: a warp per (head, m16 tile of keys): dk = scale round(dS)^T
//      qc and dv_s = round(P)^T dO_s, A^T's fragments by ldmatrix.trans of
//      the row-major tiles of step 2;
//   each of dq, dk, dv_s rounded to its scratch (the *_t tensors, which the
//   weight gradients read; NV 2: dq and dk are the outputs), its f32 column
//   sums over the real rows to the window's part_vec row (a warp's 16 rows
//   by shuffles, then the four m16 tiles in order: no atomics).
// Then dX = round(d{q,k,v}) W^T: the rounded d-panels of every group are
// read back from the scratch this block wrote (plain loads, after a
// barrier) as 64 x C tiles, then 128-column panel products. The
// weight-gradient products and reduce_parts run after the body, as for the
// scalar one.
//
// One form (ops/window_attention.py:ATTN_BWD_FORM): one block of 16 warps
// an SM on 128-column head groups, a ring of 2 weight tiles of 64 rows (a
// third does not fit beside NV 2's panels at C = 256). Two blocks of 8
// warps an SM on 64-column groups, which put the style transformer's 200
// windows in one wave, ran the body 5% slower on an H100 (twice the input
// tiles and ring steps; PERF.md). Shared memory: the group's
// panels (5 for NV 1, 6 for NV 2), one region that holds either the input
// tile or the group's round(P) and round(dS) tiles, the ring and the
// column sums; 201,728 bytes (NV 1) and 217,088 (NV 2) at C = 256.

#pragma once

#include "window_tc.cuh"

namespace {

constexpr int kAtDh = 32;              // the head dim the body takes
constexpr int kAtLds = kTcRows + 8;    // row stride of a P or dS tile (bf16)
constexpr int kAtGroup = 128;          // columns of a head group
constexpr int kAtKp = 64;              // weight rows per ring tile
constexpr int kAtThreads = 512;        // a block: 16 warps

// Shared memory of the body (ops/window_attention.py:attn_bwd_layout
// computes the same): the panels (64 x (gw + 8) bf16 each), the union of
// the input tile (64 x (C + 8) bf16) and the P and dS tiles of the group's
// heads (64 x 72 bf16 each), the ring (stages x kp x 136 bf16) and the
// column sums ((NV 1: 3, NV 2: 2) x 4 x gw f32).
struct AttnTcLayout {
  size_t panels, u, ring, cs, total;
};

__host__ __device__ inline AttnTcLayout attn_tc_layout(int c, int gw, int kp,
                                                       int stages, int nv) {
  AttnTcLayout l;
  const size_t panel = 2 * kTcRows * (gw + 8);
  const size_t tile = 2 * kTcRows * (c + 8);
  const size_t pds = 2 * 2 * (gw / kAtDh) * kTcRows * kAtLds;
  size_t o = 0;
  l.panels = o; o = align16(o + (nv == 1 ? 5 : 6) * panel);
  l.u = o;      o = align16(o + (tile > pds ? tile : pds));
  l.ring = o;   o = align16(o + 2 * stages * kp * kTcLdp);
  l.cs = o;     o = align16(o + sizeof(float) * (nv == 1 ? 3 : 2) * 4 * gw);
  l.total = o;
  return l;
}

// The body's weight tiles in the order it uses them
// (ops/window_attention.py:attn_bwd_tile_schedule): per head group gi the
// gw-wide panels of its four projections over K = C (NV 1: wq, wk, wv0,
// wpt; NV 2: wv0, wv1, wpt, wpt), then per input gradient (NV 1: wqt, wkt,
// wv0t; NV 2: wv0t, wv1t) the 128-column panels of W^T over K = C. Every
// matrix is C x C, row-major.
struct AttnBwdTiles {
  using bf16 = __nv_bfloat16;
  const bf16 *p0, *p1, *p2, *p3, *x0, *x1, *x2;
  int C, gw, kp, nk, npan, t1, total;

  __device__ __forceinline__ AttnBwdTiles(const bf16* p0_, const bf16* p1_,
                                          const bf16* p2_, const bf16* p3_,
                                          const bf16* x0_, const bf16* x1_,
                                          const bf16* x2_, int nx, int C_,
                                          int gw_, int kp_)
      : p0(p0_), p1(p1_), p2(p2_), p3(p3_), x0(x0_), x1(x1_), x2(x2_),
        C(C_), gw(gw_), kp(kp_) {
    nk = C / kp;
    npan = (C + kTcPanel - 1) / kTcPanel;
    t1 = (C / gw) * 4 * nk;
    total = t1 + nx * npan * nk;
  }

  __device__ __forceinline__ const bf16* tile(int u, int& ld,
                                              int& width) const {
    ld = C;
    if (u < t1) {
      const int gi = u / (4 * nk), part = (u / nk) & 3, kt = u % nk;
      const bf16* w = part == 0 ? p0 : part == 1 ? p1 : part == 2 ? p2 : p3;
      width = gw;
      return w + static_cast<long long>(kt * kp) * C + gi * gw;
    }
    const int v = u - t1, x = v / (npan * nk), pn = (v / nk) % npan,
              kt = v % nk;
    const bf16* w = x == 0 ? x0 : x == 1 ? x1 : x2;
    width = min(kTcPanel, C - pn * kTcPanel);
    return w + static_cast<long long>(kt * kp) * C + pn * kTcPanel;
  }
};

// Rows 0..63 of `width` columns of x (row stride ldx) into dst (row stride
// ldd) by cp.async, 16 bytes a piece, rows >= N zero-filled. Issues only:
// the caller commits and waits.
template <int NT>
__device__ __forceinline__ void at_copy_rows(const __nv_bfloat16* x, int ldx,
                                             int width, int N,
                                             __nv_bfloat16* dst, int ldd) {
  const int vpr = width >> 3;
  for (int i = threadIdx.x; i < kTcRows * vpr; i += NT) {
    const int r = i / vpr, v = i - r * vpr;
    const bool ok = r < N;
    cp_async16(dst + r * ldd + v * 8,
               ok ? x + static_cast<long long>(r) * ldx + v * 8 : x, ok);
  }
}

// The same for a tile this block wrote before a barrier (the d-scratch):
// plain loads, four in flight a thread, then the stores. No barrier.
template <int NT>
__device__ __forceinline__ void at_load_written(const __nv_bfloat16* x,
                                                int C, int N,
                                                __nv_bfloat16* dst, int ldd) {
  constexpr int kR = 4;
  const int vpr = C >> 3, total = kTcRows * vpr;
  for (int i0 = threadIdx.x; i0 < total; i0 += NT * kR) {
    uint4 u[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int i = i0 + k * NT, r = i / vpr;
      u[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && r < N)
        u[k] = *reinterpret_cast<const uint4*>(
            x + static_cast<long long>(r) * C + (i - r * vpr) * 8);
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int i = i0 + k * NT, r = i / vpr;
      if (i < total)
        *reinterpret_cast<uint4*>(dst + r * ldd + (i - r * vpr) * 8) = u[k];
    }
  }
}

// A bf16 pair times s, rounded to bf16 again (NV 2's qs from q).
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16x2(f.x * s, f.y * s);
}

// acc (16 x DH of a warp, C fragments) = A (16 x 64, the packed bf16 A
// fragments a[ni][0..1] as the scores' layout) times B (64 x DH rows of a
// panel from column hc, row stride ldp), B's fragments by ldmatrix.trans.
template <int DH>
__device__ __forceinline__ void at_rows_times(const uint32_t (&a)[8][2],
                                              const __nv_bfloat16* B, int ldp,
                                              int hc, float (&acc)[DH / 8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) {
    const uint32_t af[4] = {a[2 * kj][0], a[2 * kj][1], a[2 * kj + 1][0],
                            a[2 * kj + 1][1]};
#pragma unroll
    for (int dj = 0; dj < DH / 16; ++dj) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(b0, b1, b2, b3,
                    B + (16 * kj + (lane & 15)) * ldp + hc + dj * 16 +
                        (lane >> 4) * 8);
      mma_bf16(acc[2 * dj], af, b0, b1);
      mma_bf16(acc[2 * dj + 1], af, b2, b3);
    }
  }
}

// acc (16 keys of tile jt x DH) = T^T B: T a 64 x 64 row-major tile
// (queries x keys, row stride kAtLds) whose transpose's fragments
// ldmatrix.trans reads, B 64 x DH rows of a panel from column hc.
template <int DH>
__device__ __forceinline__ void at_cols_times(const __nv_bfloat16* T, int jt,
                                              const __nv_bfloat16* B, int ldp,
                                              int hc, float (&acc)[DH / 8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kTcRows; kk += 16) {
    uint32_t af[4];
    ldsm_x4_trans(af[0], af[1], af[2], af[3],
                  T + (kk + (lane & 7) + ((lane >> 4) << 3)) * kAtLds +
                      16 * jt + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int dj = 0; dj < DH / 16; ++dj) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(b0, b1, b2, b3,
                    B + (kk + (lane & 15)) * ldp + hc + dj * 16 +
                        (lane >> 4) * 8);
      mma_bf16(acc[2 * dj], af, b0, b1);
      mma_bf16(acc[2 * dj + 1], af, b2, b3);
    }
  }
}

// A warp's 16 x DH result (rows r0 = 16 m + lane / 4 and r0 + 8) times mul,
// rounded to bf16 into dst (window base plus the head's first column, row
// stride C) where the row is real; with cs, the f32 column sums over the
// real rows of the 16 into cs[column] (lanes 0..3 write; the sums by
// shuffles in a fixed order).
template <int DH>
__device__ __forceinline__ void at_store(const float (&acc)[DH / 8][4],
                                         float mul, int r0, int N, int C,
                                         __nv_bfloat16* dst, float* cs) {
  const int lane = threadIdx.x & 31, q4 = lane & 3;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int col = dt * 8 + 2 * q4;
    const float v0 = acc[dt][0] * mul, v1 = acc[dt][1] * mul;
    const float v2 = acc[dt][2] * mul, v3 = acc[dt][3] * mul;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(dst + static_cast<long long>(r0) * C +
                                   col) = pack_bf16x2(v0, v1);
    if (r0 + 8 < N)
      *reinterpret_cast<uint32_t*>(dst + static_cast<long long>(r0 + 8) * C +
                                   col) = pack_bf16x2(v2, v3);
    if (cs != nullptr) {
      float s0 = (r0 < N ? v0 : 0.f) + (r0 + 8 < N ? v2 : 0.f);
      float s1 = (r0 < N ? v1 : 0.f) + (r0 + 8 < N ? v3 : 0.f);
#pragma unroll
      for (int m = 4; m <= 16; m <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, m);
        s1 += __shfl_xor_sync(0xffffffffu, s1, m);
      }
      if (lane < 4) {
        cs[col] = s0;
        cs[col + 1] = s1;
      }
    }
  }
}

// The body on one window (blockIdx.x) of one image (blockIdx.y): a block of
// kAtThreads threads, head groups of kAtGroup columns, a ring of 2 weight
// tiles of kAtKp rows. Fields of A as window_attention.cu's AttnArgs;
// a.plan checked by the caller.
template <int NV, typename A>
__device__ __forceinline__ void attn_bwd_tc(const A& a, unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = kAtThreads, GW = kAtGroup, KP = kAtKp;
  constexpr int DH = kAtDh, NW = NT / 32, LDP = GW + 8, HG = GW / DH;
  constexpr int PANEL = kTcRows * LDP;
  constexpr int NG = NV == 1 ? 3 : 2;  // column sums kept per group
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, q4 = lane & 3;
  const int C = static_cast<int>(a.C), N = static_cast<int>(a.N);
  const int heads = static_cast<int>(a.heads), LDA = C + 8;
  const long long blk = static_cast<long long>(blockIdx.y) * a.nW + blockIdx.x;
  const long long base = blk * N * C;
  const float scale = static_cast<float>(a.scale);
  const AttnTcLayout L = attn_tc_layout(C, GW, KP, 2, NV);
  bf16* pan = reinterpret_cast<bf16*>(smem + L.panels);
  bf16* qs = pan;                                // NV 1 only
  bf16* qc = pan + (NV == 1 ? PANEL : 0);
  bf16* kc = qc + PANEL;
  bf16* vc[2] = {kc + PANEL, kc + 2 * PANEL};    // vc[1]: NV 2 only
  bf16* dO[2] = {kc + (1 + NV) * PANEL, kc + (2 + NV) * PANEL};
  bf16* At = reinterpret_cast<bf16*>(smem + L.u);  // an input tile
  bf16* Pt = At;                                   // round(P) per head
  bf16* St = At + HG * kTcRows * kAtLds;           // round(dS) per head
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* vin0 = static_cast<const bf16*>(a.v0) + base;
  const bf16* vin1 = NV == 2 ? static_cast<const bf16*>(a.v1) + base : vin0;
  const bf16* g0 = static_cast<const bf16*>(a.g0) + base;
  const bf16* g1 = NV == 2 ? static_cast<const bf16*>(a.g1) + base : g0;
  bf16* o_t[2] = {static_cast<bf16*>(a.o0_t) + base,
                  static_cast<bf16*>(NV == 2 ? a.o1_t : a.o0_t) + base};
  bf16* dv_t[2] = {static_cast<bf16*>(a.dv0_t) + base,
                   static_cast<bf16*>(NV == 2 ? a.dv1_t : a.dv0_t) + base};
  bf16* dq_o = static_cast<bf16*>(NV == 1 ? a.dq_t : a.dq) + base;
  bf16* dk_o = static_cast<bf16*>(NV == 1 ? a.dk_t : a.dk) + base;
  const float* mask_w =
      a.mask != nullptr ? a.mask + static_cast<long long>(blockIdx.x) * N * N
                        : nullptr;
  float* pvec = a.part_vec + blk * (NV == 1 ? 4 : 3) * C;
  float* pbias = a.part_bias + blk * heads * N * N;
  const int slot_v = NV == 1 ? 2 : 0, slot_p = NV == 1 ? 3 : 2;

  // The projections of a group, in the schedule's order: NV 1 q, k, v0
  // and g0 (the first three with their biases) into qc (and qs), kc, vc[0]
  // and dO[0]; NV 2 v0, v1 (with biases), g0, g1 into vc[0], vc[1], dO[0],
  // dO[1]. The g tiles from first_g on.
  const int first_g = NV == 1 ? 3 : 2;
  auto xin = [&](int p) {
    return NV == 1 ? (p == 0 ? q : p == 1 ? k : p == 2 ? vin0 : g0)
                   : (p == 0 ? vin0 : p == 1 ? vin1 : p == 2 ? g0 : g1);
  };
  auto pbias_of = [&](int p) {
    return NV == 1 ? (p == 0 ? a.bq : p == 1 ? a.bk : p == 2 ? a.bv0
                                                             : nullptr)
                   : (p == 0 ? a.bv0 : p == 1 ? a.bv1 : nullptr);
  };
  auto pdst = [&](int p) {
    return NV == 1 ? (p == 0 ? qc : p == 1 ? kc : p == 2 ? vc[0] : dO[0])
                   : (p == 0 ? vc[0] : p == 1 ? vc[1] : p == 2 ? dO[0]
                                                               : dO[1]);
  };
  TcRing<2, NT, AttnBwdTiles> ring(
      AttnBwdTiles(static_cast<const bf16*>(NV == 1 ? a.wq : a.wv0),
                   static_cast<const bf16*>(NV == 1 ? a.wk : a.wv1),
                   static_cast<const bf16*>(NV == 1 ? a.wv0 : a.wpt),
                   static_cast<const bf16*>(a.wpt),
                   static_cast<const bf16*>(NV == 1 ? a.wqt : a.wv0t),
                   static_cast<const bf16*>(NV == 1 ? a.wkt : a.wv1t),
                   static_cast<const bf16*>(a.wv0t), NV == 1 ? 3 : 2, C, GW,
                   KP),
      reinterpret_cast<bf16*>(smem + L.ring), KP);
  ring.start();

  for (int gi = 0; gi < C / GW; ++gi) {
    const int c0 = gi * GW;
    // 1. The group's panels.
    if (NV == 2) {  // q and k as they come; with the first input tile
      at_copy_rows<NT>(q + c0, C, GW, N, qc, LDP);
      at_copy_rows<NT>(k + c0, C, GW, N, kc, LDP);
    }
    for (int p = 0; p < 4; ++p) {
      __syncthreads();  // every warp past its last read of the region
      at_copy_rows<NT>(xin(p), C, C, N, At, LDA);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (gi == 0 && p >= first_g) {
        // dbp's partial: the column sums of the g tiles' real rows.
        for (int c = tid; c < C; c += NT) {
          float s = 0.f;
          for (int r = 0; r < N; ++r) s += __bfloat162float(At[r * LDA + c]);
          float* d = pvec + slot_p * C + c;
          *d = (p == first_g ? 0.f : *d) + s;
        }
      }
      ring.gemm(At, LDA, C, GW);
      bf16* dst = pdst(p);
      const float* bias = pbias_of(p);
      ring.epilogue(GW, bias != nullptr ? bias + c0 : nullptr,
                    [&](int r, int c, float a0, float a1, float b0,
                        float b1) {
        const float v0 = a0 + b0, v1 = a1 + b1;
        *reinterpret_cast<uint32_t*>(dst + r * LDP + c) = pack_bf16x2(v0, v1);
        if (NV == 1 && p == 0)
          *reinterpret_cast<uint32_t*>(qs + r * LDP + c) =
              pack_bf16x2(v0 * scale, v1 * scale);
      });
    }
    __syncthreads();

    // 2. Rows: a warp per (head, m16 tile of queries).
    for (int it = warp; it < HG * 4; it += NW) {
      const int hl = it >> 2, mt = it & 3, hc = hl * DH;
      const int h = c0 / DH + hl, r0 = 16 * mt + g4;
      float sc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        uint32_t qa[4];
        ldsm_x4(qa, (NV == 1 ? qs : qc) + (16 * mt + (lane & 15)) * LDP + hc +
                        kk + (lane >> 4) * 8);
        if (NV == 2) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = scale_bf16x2(qa[e], scale);
        }
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          uint32_t kb[4];
          ldsm_x4(kb, kc + (16 * nj + (lane & 7) + ((lane >> 4) << 3)) * LDP +
                          hc + kk + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * nj], qa, kb[0], kb[1]);
          mma_bf16(sc[2 * nj + 1], qa, kb[2], kb[3]);
        }
      }
      // P = softmax(S + mask + bias) over the real keys, f32.
      const float* bh = a.rel_bias + static_cast<long long>(h) * N * N;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + (e >> 1) * 8, j = ni * 8 + 2 * q4 + (e & 1);
          float v = sc[ni][e];
          if (j >= N)
            v = -INFINITY;
          else if (i < N)
            v += (mask_w != nullptr ? __ldg(mask_w + i * N + j) : 0.f) +
                 __ldg(bh + i * N + j);
          sc[ni][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[ni][e] = expf(sc[ni][e] - mx[e >> 1]);
          sum[e >> 1] += sc[ni][e];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
        sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      }
      uint32_t pa[8][2];  // round(P), later round(dS), packed
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[ni][e] = sc[ni][e] / sum[e >> 1];
        pa[ni][0] = pack_bf16x2(sc[ni][0], sc[ni][1]);
        pa[ni][1] = pack_bf16x2(sc[ni][2], sc[ni][3]);
      }
      bf16* Ph = Pt + hl * kTcRows * kAtLds;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        *reinterpret_cast<uint32_t*>(Ph + r0 * kAtLds + ni * 8 + 2 * q4) =
            pa[ni][0];
        *reinterpret_cast<uint32_t*>(Ph + (r0 + 8) * kAtLds + ni * 8 +
                                     2 * q4) = pa[ni][1];
      }
      // round(o_s) = round(round(P) v_s) to the o_t scratch (dWp).
#pragma unroll
      for (int s = 0; s < NV; ++s) {
        float o[DH / 8][4];
        at_rows_times<DH>(pa, vc[s], LDP, hc, o);
        at_store<DH>(o, 1.f, r0, N, C, o_t[s] + c0 + hc, nullptr);
      }
      // dP = sum_s dO_s v_s^T; dS = P (dP - rowsum(dP P)).
      float dp[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[i][e] = 0.f;
#pragma unroll
      for (int s = 0; s < NV; ++s) {
#pragma unroll
        for (int kk = 0; kk < DH; kk += 16) {
          uint32_t da[4];
          ldsm_x4(da, dO[s] + (16 * mt + (lane & 15)) * LDP + hc + kk +
                          (lane >> 4) * 8);
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            uint32_t vb[4];
            ldsm_x4(vb, vc[s] + (16 * nj + (lane & 7) + ((lane >> 4) << 3)) *
                                    LDP +
                            hc + kk + ((lane >> 3) & 1) * 8);
            mma_bf16(dp[2 * nj], da, vb[0], vb[1]);
            mma_bf16(dp[2 * nj + 1], da, vb[2], vb[3]);
          }
        }
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] += dp[ni][e] * sc[ni][e];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
        rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      }
      float* pbh = pbias + static_cast<long long>(h) * N * N;
      bf16* Sh = St + hl * kTcRows * kAtLds;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + (e >> 1) * 8, j = ni * 8 + 2 * q4 + (e & 1);
          dp[ni][e] = sc[ni][e] * (dp[ni][e] - rs[e >> 1]);
          if (i < N && j < N) pbh[i * N + j] = dp[ni][e];
        }
        pa[ni][0] = pack_bf16x2(dp[ni][0], dp[ni][1]);
        pa[ni][1] = pack_bf16x2(dp[ni][2], dp[ni][3]);
        *reinterpret_cast<uint32_t*>(Sh + r0 * kAtLds + ni * 8 + 2 * q4) =
            pa[ni][0];
        *reinterpret_cast<uint32_t*>(Sh + (r0 + 8) * kAtLds + ni * 8 +
                                     2 * q4) = pa[ni][1];
      }
      // dq = scale round(dS) k.
      float dq[DH / 8][4];
      at_rows_times<DH>(pa, kc, LDP, hc, dq);
      at_store<DH>(dq, scale, r0, N, C, dq_o + c0 + hc,
                   NV == 1 ? cs + mt * GW + hc : nullptr);
    }
    __syncthreads();

    // 3. Columns: a warp per (head, m16 tile of keys).
    for (int it = warp; it < HG * 4; it += NW) {
      const int hl = it >> 2, jt = it & 3, hc = hl * DH, r0 = 16 * jt + g4;
      float acc[DH / 8][4];
      at_cols_times<DH>(St + hl * kTcRows * kAtLds, jt, qc, LDP, hc, acc);
      at_store<DH>(acc, scale, r0, N, C, dk_o + c0 + hc,
                   NV == 1 ? cs + (4 + jt) * GW + hc : nullptr);
#pragma unroll
      for (int s = 0; s < NV; ++s) {
        at_cols_times<DH>(Pt + hl * kTcRows * kAtLds, jt, dO[s], LDP, hc,
                          acc);
        at_store<DH>(acc, 1.f, r0, N, C, dv_t[s] + c0 + hc,
                     cs + ((slot_v + s) * 4 + jt) * GW + hc);
      }
    }
    __syncthreads();
    // The group's column sums, the four m16 tiles in order.
    for (int e = tid; e < NG * GW; e += NT) {
      const int sl = e / GW, c = e - sl * GW;
      const float* p = cs + sl * 4 * GW + c;
      pvec[sl * C + c0 + c] = ((p[0] + p[GW]) + p[2 * GW]) + p[3 * GW];
    }
  }
  __syncthreads();  // the d-scratch of every group written

  // dX = round(d{q,k,v}) W^T, from the scratch this block wrote.
  for (int x = 0; x < (NV == 1 ? 3 : 2); ++x) {
    const void* src = NV == 1 ? (x == 0 ? a.dq_t : x == 1 ? a.dk_t : a.dv0_t)
                              : (x == 0 ? a.dv0_t : a.dv1_t);
    void* dstv = NV == 1 ? (x == 0 ? a.dq : x == 1 ? a.dk : a.dv0)
                         : (x == 0 ? a.dv0 : a.dv1);
    bf16* dst = static_cast<bf16*>(dstv) + base;
    __syncthreads();
    at_load_written<NT>(static_cast<const bf16*>(src) + base, C, N, At, LDA);
    __syncthreads();
    for (int pn = 0; pn * kTcPanel < C; ++pn) {
      const int width = min(kTcPanel, C - pn * kTcPanel);
      ring.gemm(At, LDA, C, width);
      ring.epilogue(width, nullptr,
                    [&](int r, int c, float a0, float a1, float, float) {
        if (r < N)
          *reinterpret_cast<uint32_t*>(dst + static_cast<long long>(r) * C +
                                       pn * kTcPanel + c) =
              pack_bf16x2(a0, a1);
      });
    }
  }
}

}  // namespace
