// K10, the fused [LayerNorm ->] MLP -> + residual, and its backward on
// Hopper's tensor cores: the bf16 bodies of mmst_ln_mlp_residual and
// mmst_ln_mlp_residual_bwd (ln_mlp.cu has the functions and the launches,
// ops/ln_mlp.py:mlp_plan the tiling, mlp_layout the shared memory,
// mlp_tile_schedule and mlp_bwd_tile_schedule the order of the weight
// tiles, and tests/test_torch_mlp_tc_plan.py replays both bodies in torch).
// They compute what the scalar bodies of ln_mlp.cu compute, with the same
// rounding points; only the order of the f32 sums differs.
//
// Built from K1's pieces (window_tc.cuh): the weight ring TcRing over a
// tile schedule and its 64-row panel product (mma.sync m16n8k16 from
// ldmatrix fragments), the row statistics, and -- the forward -- K1's MLP
// steps themselves (tc_load_rows, tc_mlp_residual), which the Swin block
// and K10 share.
//
// What bounds it: 4 C hidden operations per row forward (12 backward, the
// weight gradients apart) against 4 C bytes (8 C backward): at C = 256,
// hidden 1024, some 250 to 400 operations a byte, so the tensor cores.
// Every weight tile streams through L2 once per 64-row tile: 64 operations
// per byte of L2 traffic.
//
// Tiles: 64 rows of the flattened (rows, C) a block; the last tile may be
// ragged: its pad rows are zero in every A tile, so they stay finite, and
// they are never stored nor summed.
//
// Forward (K1's steps 5-7 on a row tile): the rows into the f32 tile xs,
// LN (or the raw x) rounded into the normed tile, xs += b2; per 128-wide
// hidden chunk j, fc1's panel and round(GELU(a + b1)) into the chunk tile,
// then fc2's panels accumulate into xs; out = round(xs). Its forms are
// K1's: two blocks of 8 warps an SM (a ring of 2 tiles of 32 rows) where C
// <= 128, else one block of 16 warps (3 tiles of 64 rows): 172,032 bytes
// at C = 256.
//
// Backward, from x and g alone, per 64-row tile: h = round(LN(x)) (or x,
// stored to h_t for dW1 where there is an LN) and round(g) as bf16 tiles,
// dh = 0 in f32; per 128-wide hidden chunk j (BwdMlpTiles' order: w1's
// panel, w2t's panel, w1t's panels):
//   a_j = h W1[:, j] + b1_j; z_j = round(GELU(a_j)) to z_t (for dW2);
//       GELU'(a_j) kept in an f32 chunk tile;
//   dz_j = round(g) W2^T[:, j]; da_j = dz_j GELU'(a_j), in f32 over the
//       chunk tile (db1's column partial sums it), rounded into the bf16
//       chunk tile and to da_t (for dW1);
//   dh += round(da_j) W1^T[j, :], in f32.
// Then the column partials of db2 (sum g), the LN scale (sum dh xhat) and
// bias (sum dh), the rows' LN sums (a warp per row), and dx = round(g +
// LN^T(dh)) (or round(g + dh)). a and dz are never rounded (the JAX
// kernel keeps both in f32). One form: one block of 16 warps an SM, a ring
// of 2 tiles of 64 rows (4 of 32 where C % 64 != 0); 3 of 64 do not fit at
// C = 256, and 2 of 64 run faster than 4 or 3 of 32 (half the barriers):
// 223,232 bytes at C = 256 (h and g 33,792 each, dh 67,584, the f32 chunk
// 34,816, the bf16 chunk 17,408, the ring 34,816, the row sums 1,024).
// The weight gradients are ln_mlp.cu's: grad_common.cuh's tensor-core
// product over h_t (or x) and da_t, z_t and g.

#pragma once

#include "window_tc.cuh"

namespace {

constexpr float kInvSqrt2Pi = 0.39894228040143268f;
constexpr int kTcFLd = kTcPanel + 8;  // row stride of the f32 chunk tile

// K10's forward order: the MLP's tiles (MlpTiles) alone.
struct FwdMlpTiles : MlpTiles {
  int total;

  __device__ __forceinline__ FwdMlpTiles(const bf16* w1_, const bf16* w2_,
                                         int C_, int hidden_, int kp_)
      : MlpTiles(w1_, w2_, C_, hidden_, kp_) {
    total = count();
  }
};

// The backward's order (ops/ln_mlp.py:mlp_bwd_tile_schedule): per 128-wide
// hidden chunk j, w1's panel (C, hidden) over K = C; w2t's panel (w2t = W2^T,
// (C, hidden)) over K = C; w1t's panels (w1t = W1^T, (hidden, C)) over the
// chunk. MlpTiles' order with w1t in w2's place and w2t's panel inserted.
struct BwdMlpTiles : MlpTiles {
  const bf16* w2t;
  int per, total;

  __device__ __forceinline__ BwdMlpTiles(const bf16* w1_, const bf16* w2t_,
                                         const bf16* w1t_, int C_,
                                         int hidden_, int kp_)
      : MlpTiles(w1_, w1t_, C_, hidden_, kp_), w2t(w2t_) {
    per = tcn + nk;
    total = (hidden / kTcPanel) * per;
  }

  __device__ __forceinline__ const bf16* tile(int u, int& ld,
                                              int& width) const {
    const int j = u / per, r = u % per;
    if (r < nk) return MlpTiles::tile(j * tcn + r, ld, width);
    if (r < 2 * nk) {
      ld = hidden;
      width = kTcPanel;
      return w2t + static_cast<long long>((r - nk) * kp) * ld +
             j * kTcPanel;
    }
    return MlpTiles::tile(j * tcn + r - nk, ld, width);
  }
};

// Shared memory of the two bodies (ops/ln_mlp.py:mlp_layout computes the
// same); bf16 and f32 rows padded by 16 and 32 bytes. Forward: xs (64 x C
// f32), ln (64 x C bf16), hid (64 x 128 bf16), the ring, the row
// statistics and the rows' offsets. Backward: ln (h), g, xs (dh), fa (the
// f32 chunk), hid (the bf16 da chunk), the ring, the row statistics and the
// rows' two LN sums.
struct TcMlpLayout {
  size_t ln, g, xs, fa, hid, ring, mean, rstd, m1, m2, toff, total;
};

__host__ __device__ inline TcMlpLayout tc_mlp_layout(int c, int kp,
                                                     int stages, bool bwd) {
  TcMlpLayout l;
  const size_t tile = 2 * kTcRows * (c + 8);
  size_t o = 0;
  l.xs = o;   o = align16(o + sizeof(float) * kTcRows * (c + 8));
  l.ln = o;   o = align16(o + tile);
  l.g = o;
  if (bwd) o = align16(o + tile);
  l.fa = o;
  if (bwd) o = align16(o + sizeof(float) * kTcRows * kTcFLd);
  l.hid = o;  o = align16(o + 2 * kTcRows * kTcLdp);
  l.ring = o; o = align16(o + 2 * stages * kp * kTcLdp);
  l.mean = o; o = align16(o + sizeof(float) * kTcRows);
  l.rstd = o; o = align16(o + sizeof(float) * kTcRows);
  l.m1 = o;
  if (bwd) o = align16(o + sizeof(float) * kTcRows);
  l.m2 = o;
  if (bwd) o = align16(o + sizeof(float) * kTcRows);
  l.toff = o;
  if (!bwd) o = align16(o + sizeof(long long) * kTcRows);
  l.total = o;
  return l;
}

// The rows of this block's tile: 64 from blockIdx.x * 64, fewer in the
// last.
template <typename A>
__device__ __forceinline__ int tile_rows(const A& a, long long row0) {
  return static_cast<int>(a.rows - row0 < kTcRows ? a.rows - row0
                                                  : kTcRows);
}

// The forward on one tile: a block of NT threads, a ring of S tiles. Fields
// of A as ln_mlp.cu's LnMlpArgs.
template <int S, int NT, typename A>
__device__ __forceinline__ void ln_mlp_fwd_tc(const A& a,
                                              unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  const int C = static_cast<int>(a.C), hidden = static_cast<int>(a.hidden);
  const int kp = static_cast<int>(a.plan.kp);
  const long long row0 = static_cast<long long>(blockIdx.x) * kTcRows;
  const int N = tile_rows(a, row0);
  const TcMlpLayout L = tc_mlp_layout(C, kp, S, false);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  long long* toff = reinterpret_cast<long long*>(smem + L.toff);
  TcRing<S, NT, FwdMlpTiles> ring(
      FwdMlpTiles(static_cast<const bf16*>(a.w1),
                  static_cast<const bf16*>(a.w2), C, hidden, kp),
      reinterpret_cast<bf16*>(smem + L.ring), kp);
  ring.start();
  for (int t = threadIdx.x; t < N; t += NT) toff[t] = (row0 + t) * C;
  __syncthreads();
  tc_load_rows<NT, kLoadPlain>(static_cast<const bf16*>(a.x), toff, N, C,
                               xs, C + 8);
  __syncthreads();
  // The block's vectors under the names tc_mlp_residual reads (K1's).
  struct {
    const float *n2s, *n2b, *b1, *b2;
  } const vecs = {a.ns, a.nb, a.b1, a.b2};
  tc_mlp_residual<NT>(vecs, ring, xs, C + 8,
                      reinterpret_cast<bf16*>(smem + L.ln), C + 8,
                      reinterpret_cast<bf16*>(smem + L.hid),
                      reinterpret_cast<float*>(smem + L.mean),
                      reinterpret_cast<float*>(smem + L.rstd), toff, N, C,
                      hidden, static_cast<bf16*>(a.out));
}

// The backward on one tile: a block of NT threads, a ring of S tiles; the
// block's column partials go to part_vec's row blockIdx.x (db1 | db2 |
// d scale | d bias), as the scalar body's.
template <int S, int NT, typename A>
__device__ __forceinline__ void ln_mlp_bwd_tc(const A& a,
                                              unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = static_cast<int>(a.C), hidden = static_cast<int>(a.hidden);
  const int kp = static_cast<int>(a.plan.kp);
  const long long row0 = static_cast<long long>(blockIdx.x) * kTcRows;
  const int N = tile_rows(a, row0);
  const TcMlpLayout L = tc_mlp_layout(C, kp, S, true);
  bf16* h = reinterpret_cast<bf16*>(smem + L.ln);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.g);
  float* dh = reinterpret_cast<float*>(smem + L.xs);
  float* fa = reinterpret_cast<float*>(smem + L.fa);
  bf16* dab = reinterpret_cast<bf16*>(smem + L.hid);
  float* mean = reinterpret_cast<float*>(smem + L.mean);
  float* rstd = reinterpret_cast<float*>(smem + L.rstd);
  float* m1 = reinterpret_cast<float*>(smem + L.m1);
  float* m2 = reinterpret_cast<float*>(smem + L.m2);
  const int LDA = C + 8, LDD = C + 8;
  const bool use_norm = a.ns != nullptr;
  const bf16* x = static_cast<const bf16*>(a.x) + row0 * C;
  const bf16* g = static_cast<const bf16*>(a.g) + row0 * C;
  bf16* dx = static_cast<bf16*>(a.dx) + row0 * C;
  bf16* z_t = static_cast<bf16*>(a.z_t) + row0 * hidden;
  bf16* da_t = static_cast<bf16*>(a.da_t) + row0 * hidden;
  float* part =
      a.part_vec + static_cast<long long>(blockIdx.x) * (hidden + 3 * C);
  TcRing<S, NT, BwdMlpTiles> ring(
      BwdMlpTiles(static_cast<const bf16*>(a.w1),
                  static_cast<const bf16*>(a.w2t),
                  static_cast<const bf16*>(a.w1t), C, hidden, kp),
      reinterpret_cast<bf16*>(smem + L.ring), kp);
  const int ng = ring.tiles.ng;
  ring.start();

  // 1. h = round(LN(x)) (or x) and g as bf16 tiles, pad rows zero; h to
  //    h_t for dW1 where there is an LN; dh = 0.
  if (use_norm) {
    tc_row_stats<NT>(x, C, N, C, mean, rstd);
    __syncthreads();
  }
  for (int i = tid; i < kTcRows * (C >> 1); i += NT) {
    const int r = i / (C >> 1), c = (i - r * (C >> 1)) * 2;
    uint32_t hv = 0u, gv = 0u;
    if (r < N) {
      hv = *reinterpret_cast<const uint32_t*>(x + r * C + c);
      gv = *reinterpret_cast<const uint32_t*>(g + r * C + c);
      if (use_norm) {
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(&hv);
        const float2 s2 = __ldg(reinterpret_cast<const float2*>(a.ns + c));
        const float2 b2 = __ldg(reinterpret_cast<const float2*>(a.nb + c));
        hv = pack_bf16x2(
            (__bfloat162float(xv.x) - mean[r]) * rstd[r] * s2.x + b2.x,
            (__bfloat162float(xv.y) - mean[r]) * rstd[r] * s2.y + b2.y);
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.h_t) +
                                     (row0 + r) * C + c) = hv;
      }
    }
    *reinterpret_cast<uint32_t*>(h + r * LDA + c) = hv;
    *reinterpret_cast<uint32_t*>(gs + r * LDA + c) = gv;
    *reinterpret_cast<float2*>(dh + r * LDD + c) = make_float2(0.f, 0.f);
  }

  // 2. Per 128-wide hidden chunk j.
  for (int j = 0; j < hidden / kTcPanel; ++j) {
    const int col0 = j * kTcPanel;
    // a = h . w1 + b1: round(GELU(a)) to z_t, GELU'(a) into fa.
    ring.gemm(h, LDA, C, kTcPanel);
    ring.epilogue(kTcPanel, a.b1 + col0,
                  [&](int r, int c, float a0, float a1, float c0, float c1) {
      const float v0 = a0 + c0, v1 = a1 + c1;
      const float p0 = 0.5f * (1.f + erff(v0 * 0.70710678118654752f));
      const float p1 = 0.5f * (1.f + erff(v1 * 0.70710678118654752f));
      if (r < N)
        *reinterpret_cast<uint32_t*>(z_t + static_cast<long long>(r) *
                                               hidden + col0 + c) =
            pack_bf16x2(v0 * p0, v1 * p1);
      *reinterpret_cast<float2*>(fa + r * kTcFLd + c) = make_float2(
          p0 + v0 * kInvSqrt2Pi * expf(-0.5f * v0 * v0),
          p1 + v1 * kInvSqrt2Pi * expf(-0.5f * v1 * v1));
    });
    // dz = round(g) . W2^T; da = dz GELU'(a) in f32 over fa (the same
    // thread wrote that element above), rounded into dab and da_t.
    ring.gemm(gs, LDA, C, kTcPanel);
    ring.epilogue(kTcPanel, nullptr,
                  [&](int r, int c, float d0, float d1, float, float) {
      float2* f = reinterpret_cast<float2*>(fa + r * kTcFLd + c);
      const float2 dg = *f;
      const float2 da = make_float2(d0 * dg.x, d1 * dg.y);
      *f = da;
      const uint32_t u = pack_bf16x2(da.x, da.y);
      *reinterpret_cast<uint32_t*>(dab + r * kTcLdp + c) = u;
      if (r < N)
        *reinterpret_cast<uint32_t*>(da_t + static_cast<long long>(r) *
                                                hidden + col0 + c) = u;
    });
    __syncthreads();
    // db1's column partial: the f32 da of the real rows, in row order.
    for (int n = tid; n < kTcPanel; n += NT) {
      float s = 0.f;
      for (int r = 0; r < N; ++r) s += fa[r * kTcFLd + n];
      part[col0 + n] = s;
    }
    // dh += round(da) . W1^T, panel by panel of C.
    for (int pn = 0; pn < ng; ++pn) {
      const int width = min(kTcPanel, C - pn * kTcPanel);
      ring.gemm(dab, kTcLdp, kTcPanel, width);
      ring.epilogue(width, nullptr,
                    [&](int r, int c, float a0, float a1, float, float) {
        float2* d = reinterpret_cast<float2*>(dh + r * LDD +
                                              pn * kTcPanel + c);
        float2 v = *d;
        v.x += a0;
        v.y += a1;
        *d = v;
      });
    }
  }
  __syncthreads();

  // 3. Column partials of db2 and the norm grads over the real rows, in
  //    row order; the rows' LN sums, a warp per row.
  for (int c = tid; c < C; c += NT) {
    float sg = 0.f, sns = 0.f, snb = 0.f;
    for (int r = 0; r < N; ++r) {
      sg += __bfloat162float(gs[r * LDA + c]);
      if (use_norm) {
        const float xhat =
            (__bfloat162float(x[r * C + c]) - mean[r]) * rstd[r];
        sns += dh[r * LDD + c] * xhat;
        snb += dh[r * LDD + c];
      }
    }
    part[hidden + c] = sg;
    part[hidden + C + c] = sns;
    part[hidden + 2 * C + c] = snb;
  }
  if (use_norm) {
    for (int r = warp; r < N; r += NT / 32) {
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float dhat = dh[r * LDD + c] * __ldg(a.ns + c);
        const float xhat =
            (__bfloat162float(x[r * C + c]) - mean[r]) * rstd[r];
        s1 += dhat;
        s2 += dhat * xhat;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        m1[r] = s1 / C;
        m2[r] = s2 / C;
      }
    }
  }
  __syncthreads();

  // 4. dx = round(g + LN^T(dh)) (or round(g + dh)), two columns a thread.
  for (int i = tid; i < N * (C >> 1); i += NT) {
    const int r = i / (C >> 1), c = (i - r * (C >> 1)) * 2;
    float2 d = *reinterpret_cast<const float2*>(dh + r * LDD + c);
    if (use_norm) {
      const float2 s2 = __ldg(reinterpret_cast<const float2*>(a.ns + c));
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(x + r * C + c);
      const float x0 = (__bfloat162float(xv.x) - mean[r]) * rstd[r];
      const float x1 = (__bfloat162float(xv.y) - mean[r]) * rstd[r];
      d.x = rstd[r] * (d.x * s2.x - m1[r] - x0 * m2[r]);
      d.y = rstd[r] * (d.y * s2.y - m1[r] - x1 * m2[r]);
    }
    const __nv_bfloat162 gv =
        *reinterpret_cast<const __nv_bfloat162*>(gs + r * LDA + c);
    *reinterpret_cast<uint32_t*>(dx + r * C + c) =
        pack_bf16x2(__bfloat162float(gv.x) + d.x,
                    __bfloat162float(gv.y) + d.y);
  }
}

}  // namespace
