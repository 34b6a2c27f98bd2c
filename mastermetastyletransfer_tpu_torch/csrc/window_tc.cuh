// The Swin block on one window on Hopper's tensor cores: the bf16 body of
// K1 and K2 (mmst_window_block_rows and mmst_window_block_windows at
// bfloat16; window_block.cu has the functions and the launch,
// ops/window_block.py:block_plan the tiling, and
// tests/test_torch_window_tc_plan.py replays it in torch) and of each
// ticket of K11 (block_pair.cu), and the pieces that K3's, K4's and K10's
// bodies (style_tc.cuh, tail_tc.cuh, mlp_tc.cuh) share with it: the weight
// ring over a tile schedule, the 64-row panel product, a head group's
// attention, the row statistics and -- K10's forward -- the token load and
// the MLP half of the block (tc_load_rows, tc_mlp_residual). The
// block computes what block_window (window_common.cuh) computes, with the
// same rounding points; only the order of the f32 sums differs. A null LN1
// (K2's encoder Key block) makes the normed tile the raw input times the
// padmask, a null LN2 (the Key block too) the MLP input round(y), while the
// second residual keeps y in f32 -- as block_window.
//
// What bounds it: some 400k bf16 operations per token against 4C bytes, so
// the tensor cores. The products -- QKV, q.k^T, p.v, proj, fc1, fc2 -- run
// as mma.sync m16n8k16 (bf16 x bf16 -> f32) from ldmatrix fragments, on a
// window's 49 tokens padded to 64 rows (four m16 tiles): the pad rows of the
// normed tile are zeros, so every row stays finite; pad keys get -inf
// before the softmax, so its sums run over the real keys; pad query rows
// are never stored.
//
// Design: one block per window. Shared memory holds the window's residual
// stream in f32 (N x C), the normed tile (64 x C, bf16;
// LN1, later LN2), the head outputs (64 x C; where C <= 128, one head
// group, in the normed tile's place, which the attention no longer needs),
// one head group's q, k and v (three 64 x 128 tiles; later the MLP's hidden
// chunk) and a ring of S weight tiles (kp rows x 128 columns): stage 2's
// weights (384 KB for QKV, 512 KB for fc1) never fit, so they stream
// through the ring in one fixed order of tiles, each tile copied by every
// thread with cp.async (16 bytes, L2 only) S - 1 tiles ahead of its use,
// across the boundaries of the products and the attention between them.
// Two forms (ops/window_block.py:block_plan picks): where C <= 128, two
// blocks of 8 warps an SM (a ring of 2 tiles of 32 rows, the head outputs
// in the normed tile's place, 128 registers: 114 KB at C = 128), so that
// one window's latency hides behind the other's work; else one block of 16
// warps an SM (3 tiles of 64 rows; 224 KB at C = 256). The order
// (ops/window_block.py:tile_schedule has the same arithmetic):
//   per head group gi (a 128-column panel of C): q, k, v panels, C / kp
//     tiles each; then that group's attention;
//   proj: per 128-column panel of C, C / kp tiles;
//   per 128-wide hidden chunk j: fc1's panel, C / kp tiles; fc2's panels
//     of C, 128 / kp tiles each.
// A product's 64 x width output (width <= 128) splits over the warps as
// 4 (m16 tiles) x 2 or 4 (column parts); a warp keeps up to 8 or 4 n8
// accumulators and reads one A fragment per 16-deep step for them all (a
// part of an odd number of n8 tiles computes one more, never stored).
// Attention: a warp per (head, m16 tile); its 16 x 64 scores stay in
// registers, the softmax runs there (quad shuffles for the row max and
// sum), and the rounded numerators are the A fragments of p.v directly.
// Row statistics: a warp per row.

#pragma once

#include "mma_common.cuh"
#include "window_common.cuh"

namespace mmst {

// Mirrors BlockPlan in ops/window_block.py (the fields the kernels read):
// K1's and K2's plan (block_plan) and K3's (ops/style_block.py:style_plan).
struct TcPlan {
  long long body;        // 0 the scalar body; the tensor-core body at 1 or
                         // 2 blocks an SM (its two forms)
  long long rows;        // a window's tokens padded to m16 tiles: 64
  long long panel;       // output columns per weight panel: 128
  long long kp;          // weight rows per ring tile: 32 or 64
  long long stages;      // ring tiles: 3 (one block an SM) or 2 (two)
  long long smem_bytes;  // dynamic shared memory per block
};

}  // namespace mmst

namespace {

constexpr int kTcRows = 64;           // a window's tokens, padded
constexpr int kTcPanel = 128;         // output columns per weight panel
constexpr int kTcLdp = kTcPanel + 8;  // row stride of a panel tile (bf16)

// What every tensor-core launch checks of the plan it is given (K1, K2,
// K11; K3 and K4, whose one form is body 1): bf16, a shape the bodies take
// (N <= 64 tokens, C % 32 == 0, head dim 16, 32 or 64, hidden % 128 ==
// 0), a form of TC_FORMS (two blocks of 8 warps an SM with 2 tiles only
// where C <= 128), and shared memory equal to the body's layout (`total`)
// and within a block's share of an SM. A mismatch is refused, never run.
inline bool tc_plan_ok(const mmst::TcPlan& p, long long dtype, long long n,
                       long long c, long long heads, long long hidden,
                       size_t total) {
  const long long dh = heads ? c / heads : 0;
  const bool two = p.body == 2;
  return dtype == 1 && (p.body == 1 || two) && p.rows == kTcRows &&
         p.panel == kTcPanel && p.stages == (two ? 2 : 3) &&
         (p.kp == 32 || p.kp == 64) && n >= 1 && n <= kTcRows &&
         c % 32 == 0 && c % p.kp == 0 && heads * dh == c &&
         (dh == 16 || dh == 32 || dh == 64) && hidden % kTcPanel == 0 &&
         hidden >= kTcPanel && (!two || c <= kTcPanel) &&
         p.smem_bytes == static_cast<long long>(total) &&
         p.smem_bytes <= (two ? 115712 : 232448);
}

// Shared memory of the tensor-core body (ops/window_block.py:tc_layout
// computes the same): rows padded by 16 bytes where ldmatrix reads them,
// so that its eight rows hit distinct banks; with ob_in_ln the head outputs
// share the normed tile's place.
struct TcBlockLayout {
  size_t xs, ln, ob, qkv, ring, mean, rstd, toff, total;
};

__host__ __device__ inline TcBlockLayout tc_block_layout(int n, int c, int kp,
                                                         int stages,
                                                         bool ob_in_ln) {
  TcBlockLayout l;
  size_t o = 0;
  l.xs = o;   o = align16(o + sizeof(float) * n * (c + 4));
  l.ln = o;   o = align16(o + 2 * kTcRows * (c + 8));
  l.ob = ob_in_ln ? l.ln : o;
  if (!ob_in_ln) o = align16(o + 2 * kTcRows * (c + 8));
  l.qkv = o;  o = align16(o + 2 * 3 * kTcRows * kTcLdp);
  l.ring = o; o = align16(o + 2 * stages * kp * kTcLdp);
  l.mean = o; o = align16(o + sizeof(float) * kTcRows);
  l.rstd = o; o = align16(o + sizeof(float) * kTcRows);
  l.toff = o; o = align16(o + sizeof(long long) * kTcRows);
  l.total = o;
  return l;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The weight tiles of one block's products, in the order they are used:
// each schedule gives tile u's first element, row stride and width
// (kp rows of at most 128 columns) and counts its tiles (total). The part
// that K1's and K4's orders share: the MLP, per 128-wide hidden chunk j
// fc1's panel of w1 (C, hidden) over K = C (nk tiles), then fc2's panels of
// w2 (hidden, C) over the chunk (kpc = 128 / kp tiles each).
struct MlpTiles {
  using bf16 = __nv_bfloat16;
  const bf16 *w1, *w2;
  int C, hidden, kp, nk, ng, kpc, tcn;

  __device__ __forceinline__ MlpTiles(const bf16* w1_, const bf16* w2_,
                                      int C_, int hidden_, int kp_)
      : w1(w1_), w2(w2_), C(C_), hidden(hidden_), kp(kp_) {
    nk = C / kp;                             // tiles of K = C
    ng = (C + kTcPanel - 1) / kTcPanel;      // panels of C
    kpc = kTcPanel / kp;                     // tiles of K = 128
    tcn = nk + ng * kpc;
  }

  __device__ __forceinline__ int count() const {
    return (hidden / kTcPanel) * tcn;
  }

  __device__ __forceinline__ const bf16* tile(int v, int& ld,
                                              int& width) const {
    const int j = v / tcn, r = v % tcn;
    if (r < nk) {
      ld = hidden;
      width = kTcPanel;
      return w1 + static_cast<long long>(r * kp) * ld + j * kTcPanel;
    }
    const int pn = (r - nk) / kpc, kt = (r - nk) % kpc;
    ld = C;
    width = min(kTcPanel, C - pn * kTcPanel);
    return w2 + static_cast<long long>(j * kTcPanel + kt * kp) * ld +
           pn * kTcPanel;
  }
};

// K1's order (K2's and K3's too; ops/window_block.py:tile_schedule): per
// head group gi the q, k and v panels of wqkv (C, 3C) over K = C; proj's
// panels of wp (C, C); then the MLP.
struct BlockTiles : MlpTiles {
  const bf16 *wqkv, *wp;
  int t1, t2, total;

  __device__ __forceinline__ BlockTiles(const bf16* wqkv_, const bf16* wp_,
                                        const bf16* w1_, const bf16* w2_,
                                        int C_, int hidden_, int kp_)
      : MlpTiles(w1_, w2_, C_, hidden_, kp_), wqkv(wqkv_), wp(wp_) {
    t1 = 3 * ng * nk;
    t2 = ng * nk;
    total = t1 + t2 + count();
  }

  __device__ __forceinline__ const bf16* tile(int u, int& ld,
                                              int& width) const {
    if (u < t1) {
      const int gi = u / (3 * nk), part = (u / nk) % 3, kt = u % nk;
      ld = 3 * C;
      width = min(kTcPanel, C - gi * kTcPanel);
      return wqkv + static_cast<long long>(kt * kp) * ld + part * C +
             gi * kTcPanel;
    }
    if (u < t1 + t2) {
      const int v = u - t1, pn = v / nk, kt = v % nk;
      ld = C;
      width = min(kTcPanel, C - pn * kTcPanel);
      return wp + static_cast<long long>(kt * kp) * ld + pn * kTcPanel;
    }
    return MlpTiles::tile(u - t1 - t2, ld, width);
  }
};

// The weight ring and the 64-row products of a block of NT threads (S
// tiles of kp rows x 128 columns): the tiles in the order of the schedule
// Tiles (BlockTiles: K1's), and the products that consume them in that
// order. acc holds this warp's part of the last product's 64 x width
// output.
template <int S, int NT, typename Tiles = BlockTiles>
struct TcRing {
  using bf16 = __nv_bfloat16;
  static constexpr int NW = NT / 32;              // warps
  static constexpr int WSPLIT = NW / 4;           // column parts of a product
  static constexpr int MT = kTcPanel / (8 * WSPLIT);  // n8 tiles of a part
  Tiles tiles;
  bf16* ring;
  int kp;
  int t = 0;  // the next tile a product consumes
  float acc[MT][4];

  __device__ __forceinline__ TcRing(const Tiles& tiles_, bf16* ring_,
                                    int kp_)
      : tiles(tiles_), ring(ring_), kp(kp_) {}

  // Copy tile u into its slot (every thread a share, cp.async) and commit
  // a group, empty past the last tile.
  __device__ __forceinline__ void issue(int u) const {
    if (u < tiles.total) {
      int ld, width;
      const bf16* src = tiles.tile(u, ld, width);
      bf16* dst = ring + (u % S) * kp * kTcLdp;
      const int vpr = width >> 3;  // 16-byte pieces per row
      for (int i = threadIdx.x; i < kp * vpr; i += NT) {
        const int row = i / vpr, v = i - row * vpr;
        cp_async16(dst + row * kTcLdp + v * 8,
                   src + static_cast<long long>(row) * ld + v * 8, true);
      }
    }
    cp_async_commit();
  }

  // The first S - 1 tiles, ahead of the first product.
  __device__ __forceinline__ void start() const {
    for (int s = 0; s < S - 1; ++s) issue(s);
  }

  // One product panel: acc = A (64 x K in shared memory, row stride lda)
  // times the next K / kp tiles of the ring, width columns; each tile is
  // waited for, and the tile S - 1 ahead issued into the slot the last one
  // left (every warp is past it: the barrier).
  __device__ __forceinline__ void gemm(const bf16* A, int lda, int K,
                                       int width) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp / WSPLIT, wn = warp % WSPLIT;  // m16 tile, part
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    const int part = width / WSPLIT;          // columns of this warp
    const int npair = (part / 8 + 1) >> 1;    // n8 tile pairs
    const bf16* arow = A + (16 * wm + (lane & 15)) * lda + (lane >> 4) * 8;
    for (int k0 = 0; k0 < K; k0 += kp, ++t) {
      cp_async_wait<S - 2>();
      __syncthreads();
      issue(t + S - 1);
      const bf16* B = ring + (t % S) * kp * kTcLdp + wn * part +
                      (lane & 15) * kTcLdp + (lane >> 4) * 8;
#pragma unroll 2
      for (int kk = 0; kk < kp; kk += 16) {
        uint32_t af[4];
        ldsm_x4(af, arow + k0 + kk);
#pragma unroll
        for (int nj = 0; nj < MT / 2; ++nj) {
          if (nj < npair) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_trans(b0, b1, b2, b3, B + kk * kTcLdp + nj * 16);
            mma_bf16(acc[2 * nj], af, b0, b1);
            mma_bf16(acc[2 * nj + 1], af, b2, b3);
          }
        }
      }
    }
  }

  // The panel's outputs: put(row, column in the panel, value, next value,
  // bias, next bias) for this thread's fragment elements, rows 0..63; the
  // panel's f32 bias (null: zeros) is read first, through the read-only
  // path, so that its loads are not ordered after the puts' stores.
  template <typename Put>
  __device__ __forceinline__ void epilogue(int width, const float* bias,
                                           Put&& put) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp / WSPLIT, wn = warp % WSPLIT;
    const int g4 = lane >> 2, q4 = lane & 3;  // fragment row, column pair
    const int part = width / WSPLIT, ntile = part / 8;
    float2 bv[MT];
#pragma unroll
    for (int ni = 0; ni < MT; ++ni) {
      const int col = wn * part + ni * 8 + 2 * q4;
      bv[ni] = (ni < ntile && bias != nullptr)
                   ? __ldg(reinterpret_cast<const float2*>(bias + col))
                   : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int ni = 0; ni < MT; ++ni) {
      if (ni < ntile) {
        const int col = wn * part + ni * 8 + 2 * q4;
        put(16 * wm + g4, col, acc[ni][0], acc[ni][1], bv[ni].x, bv[ni].y);
        put(16 * wm + g4 + 8, col, acc[ni][2], acc[ni][3], bv[ni].x,
            bv[ni].y);
      }
    }
  }
};

// The attention of one head group of a block of NT threads: the heads of
// columns c0 .. c0 + wg of C (head dim DH), whose q (scaled), k and v
// panels are in qs, ks, vs (64 x kTcPanel each, row stride kTcLdp); each
// head's output (p . v) / sum, rounded to bf16, into columns c0.. of ob
// (row stride ldo), rows 0..63. A warp per (head, m16 tile): scores +
// (mask + bias) on the real keys, -inf on the pad keys, the softmax in f32
// over the row (a quad of lanes holds it), the rounded numerators as p.v's
// A fragments and the unrounded sum.
template <int DH, int NT>
__device__ __forceinline__ void tc_attend_group(
    const __nv_bfloat16* qs, const __nv_bfloat16* ks,
    const __nv_bfloat16* vs, __nv_bfloat16* ob, int ldo, int c0, int wg,
    int N, const float* mask_w, const float* rel_bias) {
  constexpr int NW = NT / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, q4 = lane & 3;
  const int hg = wg / DH;  // heads in the group
  for (int it = warp; it < hg * 4; it += NW) {
    const int hl = it >> 2, mt = it & 3;
    const int h = c0 / DH + hl, qc = hl * DH;
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      uint32_t qa[4];
      ldsm_x4(qa, qs + (16 * mt + (lane & 15)) * kTcLdp + qc + kk +
                      (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (16 * nj + (lane & 7) + ((lane >> 4) << 3)) *
                             kTcLdp +
                         qc + kk + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * nj], qa, kb[0], kb[1]);
        mma_bf16(sc[2 * nj + 1], qa, kb[2], kb[3]);
      }
    }
    const float* bh = rel_bias + static_cast<long long>(h) * N * N;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * mt + g4 + (e >> 1) * 8;
        const int j = ni * 8 + 2 * q4 + (e & 1);
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
    uint32_t pa[8][2];  // the rounded numerators, packed
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const float e0 = expf(sc[ni][0] - mx[0]), e1 = expf(sc[ni][1] - mx[0]);
      const float e2 = expf(sc[ni][2] - mx[1]), e3 = expf(sc[ni][3] - mx[1]);
      sum[0] += e0 + e1;
      sum[1] += e2 + e3;
      pa[ni][0] = pack_bf16x2(e0, e1);
      pa[ni][1] = pack_bf16x2(e2, e3);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    }
    float o[DH / 8][4];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) {
      const uint32_t a[4] = {pa[2 * kj][0], pa[2 * kj][1],
                             pa[2 * kj + 1][0], pa[2 * kj + 1][1]};
#pragma unroll
      for (int dj = 0; dj < DH / 16; ++dj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(b0, b1, b2, b3,
                      vs + (16 * kj + (lane & 15)) * kTcLdp + qc + dj * 16 +
                          (lane >> 4) * 8);
        mma_bf16(o[2 * dj], a, b0, b1);
        mma_bf16(o[2 * dj + 1], a, b2, b3);
      }
    }
    const float inv0 = 1.f / sum[0], inv1 = 1.f / sum[1];
    const int r0 = 16 * mt + g4;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      const int col = c0 + qc + dt * 8 + 2 * q4;
      *reinterpret_cast<uint32_t*>(ob + r0 * ldo + col) =
          pack_bf16x2(o[dt][0] * inv0, o[dt][1] * inv0);
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * ldo + col) =
          pack_bf16x2(o[dt][2] * inv1, o[dt][3] * inv1);
    }
  }
}

// LayerNorm statistics of rows 0..n-1 of x (row stride ld, C columns; f32
// or bf16), two passes in f32, a warp per row of a block of NT threads;
// no barrier.
template <int NT, typename TX>
__device__ __forceinline__ void tc_row_stats(const TX* x, int ld, int n,
                                             int C, float* mean,
                                             float* rstd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n; r += NT / 32) {
    const TX* row = x + r * ld;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f(row[c]);
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f(row[c]) - mu;
      v += d * d;
    }
    v = warp_sum(v);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rsqrtf(v / C + 1e-5f);
    }
  }
}

// How a body reads its input tokens, 16 bytes a piece: kLoadPlain a plain
// load (K1, K2; LDG.E.128); kLoadL2 through L2 only (__ldcg,
// LDG.E.128.STRONG.GPU: K11's second block, which reads what other thread
// blocks of the same launch wrote, so that no line an SM's L1 held from
// before can answer); kLoadReadOnly through the read-only path (__ldg,
// LDG.E.128.CONSTANT), which no body uses: it is the load that a const
// __restrict__ path may compile to. block_pair.cu's probe shows on the card
// that without a fence between, a plain or read-only load reads a line
// another SM has since overwritten, and an L2-only load does not
// (tests/test_torch_cuda_kernels.py).
constexpr int kLoadPlain = 0, kLoadL2 = 1, kLoadReadOnly = 2;

template <int kLoad>
__device__ __forceinline__ uint4 load16(const void* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  if (kLoad == kLoadL2) return __ldcg(q);
  if (kLoad == kLoadReadOnly) return __ldg(q);
  return *q;
}

// Rows 0..N-1 of a tile into the f32 tile xs (row stride ldx), 16 bytes a
// piece: row t from x[toff[t] ..] with load16<kLoad>. No barrier.
template <int NT, int kLoad>
__device__ __forceinline__ void tc_load_rows(const __nv_bfloat16* x,
                                             const long long* toff, int N,
                                             int C, float* xs, int ldx) {
  const int vpc = C >> 3;
  for (int i = threadIdx.x; i < N * vpc; i += NT) {
    const int tk = i / vpc, c = (i - tk * vpc) * 8;
    const uint4 u = load16<kLoad>(x + toff[tk] + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
    float* d = xs + tk * ldx + c;
    *reinterpret_cast<float4*>(d) =
        make_float4(__bfloat162float(e[0]), __bfloat162float(e[1]),
                    __bfloat162float(e[2]), __bfloat162float(e[3]));
    *reinterpret_cast<float4*>(d + 4) =
        make_float4(__bfloat162float(e[4]), __bfloat162float(e[5]),
                    __bfloat162float(e[6]), __bfloat162float(e[7]));
  }
}

// y -> y + fc2(GELU(fc1(LN(y)))) + b2 on a 64-row tile whose rows 0..N-1
// the f32 tile xs holds (row stride ldx; every thread past a barrier since
// they were written), then the store: K1's steps 5-7 (K2's, K11's) and the
// whole of K10's forward (mlp_tc.cuh). The ring's next tiles are the MLP's
// (MlpTiles' order). LN (p.n2s, p.n2b; null: the plain y) rounded to bf16
// into ln (row stride lda) as the MLP input, its pad rows N..63 zero, while
// xs takes p.b2; per 128-wide hidden chunk j, hid = round(GELU(ln . w1 +
// p.b1)) (row stride kTcLdp), then xs accumulates hid . w2 panel by panel;
// last, row t rounded to bf16 into out[toff[t] ..], 16 bytes a piece. The
// vectors are read from p where they are used, as the block's other steps
// read theirs (passed as pointers, ptxas spills 4 more bytes in K11).
template <int NT, typename Ring, typename W>
__device__ __forceinline__ void tc_mlp_residual(
    const W& p, Ring& ring, float* xs, int ldx, __nv_bfloat16* ln, int lda,
    __nv_bfloat16* hid, float* mean, float* rstd, const long long* toff,
    int N, int C, int hidden, __nv_bfloat16* out) {
  const int tid = threadIdx.x;
  const int ng = ring.tiles.ng;
  // LN (or the plain y) rounded to bf16 as the MLP input, pad rows zero,
  // and the residual stream takes b2.
  if (p.n2s != nullptr) {
    tc_row_stats<NT>(xs, ldx, N, C, mean, rstd);
    __syncthreads();
  }
  for (int i = tid; i < kTcRows * (C >> 1); i += NT) {
    const int r = i / (C >> 1), c = (i - r * (C >> 1)) * 2;
    if (r >= N) {
      *reinterpret_cast<uint32_t*>(ln + r * lda + c) = 0u;
      continue;
    }
    float2* d = reinterpret_cast<float2*>(xs + r * ldx + c);
    const float2 y = *d;
    float v0 = y.x, v1 = y.y;
    if (p.n2s != nullptr) {
      const float2 s2 = __ldg(reinterpret_cast<const float2*>(p.n2s + c));
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(p.n2b + c));
      v0 = (v0 - mean[r]) * rstd[r] * s2.x + b2.x;
      v1 = (v1 - mean[r]) * rstd[r] * s2.y + b2.y;
    }
    *reinterpret_cast<uint32_t*>(ln + r * lda + c) = pack_bf16x2(v0, v1);
    const float2 bb = __ldg(reinterpret_cast<const float2*>(p.b2 + c));
    *d = make_float2(y.x + bb.x, y.y + bb.y);
  }

  // The MLP by 128-wide hidden chunks: hid = GELU(ln . w1 + b1) rounded to
  // bf16, then the residual stream accumulates hid . w2.
  for (int j = 0; j < hidden / kTcPanel; ++j) {
    ring.gemm(ln, lda, C, kTcPanel);
    ring.epilogue(kTcPanel, p.b1 + j * kTcPanel,
                  [&](int r, int c, float a0, float a1, float b0, float b1) {
      *reinterpret_cast<uint32_t*>(hid + r * kTcLdp + c) =
          pack_bf16x2(gelu(a0 + b0), gelu(a1 + b1));
    });
    for (int pn = 0; pn < ng; ++pn) {
      const int width = min(kTcPanel, C - pn * kTcPanel);
      ring.gemm(hid, kTcLdp, kTcPanel, width);
      ring.epilogue(width, nullptr,
                    [&](int r, int c, float a0, float a1, float, float) {
        if (r < N) {
          float2* d = reinterpret_cast<float2*>(xs + r * ldx +
                                                pn * kTcPanel + c);
          float2 v = *d;
          v.x += a0;
          v.y += a1;
          *d = v;
        }
      });
    }
  }
  __syncthreads();

  // Store, each row where it was read, 16 bytes a piece.
  const int vpc = C >> 3;
  for (int i = tid; i < N * vpc; i += NT) {
    const int tk = i / vpc, c = (i - tk * vpc) * 8;
    const float* s = xs + tk * ldx + c;
    uint4 u;
    u.x = pack_bf16x2(s[0], s[1]);
    u.y = pack_bf16x2(s[2], s[3]);
    u.z = pack_bf16x2(s[4], s[5]);
    u.w = pack_bf16x2(s[6], s[7]);
    *reinterpret_cast<uint4*>(out + toff[tk] + c) = u;
  }
}

// The block of NT threads on one window of N <= 64 tokens, head dim DH
// (16, 32 or 64), C % 32 == 0, hidden % 128 == 0, weight tiles of kp (32
// or 64) rows in a ring of S; ob_in_ln (C <= 128 only) as the layout's.
// Fields of W as block_window's. Token t is read from x[toff[t] ..] with
// load16<kLoad> and written to out[toff[t] ..]; the caller fills toff (the
// layout's slot) and passes a barrier first. mask_w (N x N) and pm_w (N)
// as block_window's.
template <int DH, int S, int NT, int kLoad = kLoadPlain, typename W>
__device__ __forceinline__ void block_window_tc(
    const W& p, int C, int hidden, float scale, const __nv_bfloat16* x,
    __nv_bfloat16* out, int N, const float* mask_w, const float* pm_w,
    int kp, bool ob_in_ln, unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  const int tid = threadIdx.x;
  const TcBlockLayout L = tc_block_layout(N, C, kp, S, ob_in_ln);
  float* xs = reinterpret_cast<float*>(smem + L.xs);  // residual stream
  bf16* ln = reinterpret_cast<bf16*>(smem + L.ln);    // LN1, later LN2
  bf16* ob = reinterpret_cast<bf16*>(smem + L.ob);    // head outputs
  bf16* qs = reinterpret_cast<bf16*>(smem + L.qkv);   // a head group's q
  bf16* ks = qs + kTcRows * kTcLdp;
  bf16* vs = ks + kTcRows * kTcLdp;
  bf16* hid = qs;                                     // an MLP chunk
  float* mean = reinterpret_cast<float*>(smem + L.mean);
  float* rstd = reinterpret_cast<float*>(smem + L.rstd);
  const long long* toff = reinterpret_cast<const long long*>(smem + L.toff);
  const int LDX = C + 4, LDA = C + 8;
  TcRing<S, NT> ring(BlockTiles(static_cast<const bf16*>(p.wqkv),
                                static_cast<const bf16*>(p.wp),
                                static_cast<const bf16*>(p.w1),
                                static_cast<const bf16*>(p.w2), C, hidden,
                                kp),
                     reinterpret_cast<bf16*>(smem + L.ring), kp);
  const int ng = ring.tiles.ng;
  // LayerNorm statistics of the residual stream's rows, then a barrier.
  auto stats = [&]() {
    tc_row_stats<NT>(xs, LDX, N, C, mean, rstd);
    __syncthreads();
  };

  ring.start();

  // 1. The window's tokens into the f32 residual stream.
  tc_load_rows<NT, kLoad>(x, toff, N, C, xs, LDX);
  __syncthreads();

  // 2. LN1 rounded to bf16 (without LN1 the raw input, exact), pad tokens
  //    zeroed, pad rows N..63 zero (the f32 vectors through the read-only
  //    path, as the epilogues').
  if (p.n1s != nullptr) stats();
  for (int i = tid; i < kTcRows * (C >> 1); i += NT) {
    const int r = i / (C >> 1), c = (i - r * (C >> 1)) * 2;
    float v0 = 0.f, v1 = 0.f;
    if (r < N && !(pm_w != nullptr && __ldg(pm_w + r) == 0.f)) {
      v0 = xs[r * LDX + c];
      v1 = xs[r * LDX + c + 1];
      if (p.n1s != nullptr) {
        const float2 s2 = __ldg(reinterpret_cast<const float2*>(p.n1s + c));
        const float2 b2 = __ldg(reinterpret_cast<const float2*>(p.n1b + c));
        v0 = (v0 - mean[r]) * rstd[r] * s2.x + b2.x;
        v1 = (v1 - mean[r]) * rstd[r] * s2.y + b2.y;
      }
    }
    *reinterpret_cast<uint32_t*>(ln + r * LDA + c) = pack_bf16x2(v0, v1);
  }

  // 3. Per head group: its q, k, v (q scaled), then its heads' attention.
  for (int gi = 0; gi < ng; ++gi) {
    const int wg = min(kTcPanel, C - gi * kTcPanel);
    for (int part = 0; part < 3; ++part) {
      ring.gemm(ln, LDA, C, wg);
      bf16* dst = part == 0 ? qs : part == 1 ? ks : vs;
      const float* bq = p.bqkv + part * C + gi * kTcPanel;
      ring.epilogue(wg, bq, [&](int r, int c, float a0, float a1, float b0,
                                float b1) {
        float v0 = round_bf16(a0 + b0), v1 = round_bf16(a1 + b1);
        if (part == 0) {
          v0 *= scale;
          v1 *= scale;
        }
        *reinterpret_cast<uint32_t*>(dst + r * kTcLdp + c) =
            pack_bf16x2(v0, v1);
      });
    }
    __syncthreads();
    tc_attend_group<DH, NT>(qs, ks, vs, ob, LDA, gi * kTcPanel, wg, N, mask_w,
                            p.rel_bias);
  }

  // 4. y = x + proj(heads) + bp, in place in the residual stream.
  for (int pn = 0; pn < ng; ++pn) {
    const int width = min(kTcPanel, C - pn * kTcPanel);
    ring.gemm(ob, LDA, C, width);
    ring.epilogue(width, p.bp + pn * kTcPanel,
                  [&](int r, int c, float a0, float a1, float b0, float b1) {
      if (r < N) {
        float2* d =
            reinterpret_cast<float2*>(xs + r * LDX + pn * kTcPanel + c);
        float2 v = *d;
        v.x = v.x + a0 + b0;
        v.y = v.y + a1 + b1;
        *d = v;
      }
    });
  }
  __syncthreads();

  // 5-7. LN2, the MLP and the store.
  tc_mlp_residual<NT>(p, ring, xs, LDX, ln, LDA, hid, mean, rstd, toff, N,
                      C, hidden, out);
}

}  // namespace
