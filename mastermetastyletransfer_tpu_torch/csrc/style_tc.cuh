// K3, the encoder's Scale/Shift update, on Hopper's tensor cores: the bf16
// body of mmst_encoder_scale_shift (style_block.cu has the function and the
// launch, ops/style_block.py:style_plan the tiling, and
// tests/test_torch_style_tc_plan.py replays it in torch). It computes what
// the scalar K3 body computes, with the same rounding points; only the
// order of the f32 sums differs.
//
// Built from K1's pieces (window_tc.cuh): the weight ring TcRing over K1's
// tile order BlockTiles (ops/window_block.py:tile_schedule) -- per head group
// the q, k and v panels of the shared [wq | wk | wv], proj's panels, then
// per 128-wide hidden chunk fc1's panel and fc2's panels, here of the
// stream's own MLP --, its 64-row panel product, a head group's attention
// with the softmax in registers (tc_attend_group) and the row statistics.
//
// What bounds it: some 24 N C^2 bf16 operations per (window, stream)
// against 3 window tiles of bytes, so the tensor cores.
//
// Design: one block of 16 warps per (window, image, stream), as the scalar
// body: each recomputes the shared q and k (a quarter more products than
// one block for both streams) so that one stream's tiles fit. Rounding
// points (pallas_attention.py:_kernel_enc_ss): the normed views zp(LN1 x)
// (zp re-zeroes the pad tokens; without LN1 the raw tokens, exact); q =
// round(round(qk wq + bq) scale), k, v = round(. + b); the numerators; the
// head outputs; y = V_raw + heads wp + bp rounded once, round(y) being both
// the MLP's input and its residual; the GELU output; the output.
//
// Shared memory (tc_style_layout; ops/style_block.py:style_layout computes
// the same): Key's normed view kt, the head outputs ob, the stream's
// normed view vt (64 x C each, bf16), a head group's q, k, v (later the
// MLP's hidden chunk) and the ring, as K1's. No f32 residual tile during
// attention: once the v products are done, proj's epilogue writes round(y)
// over vt, reading V_raw from device memory; once proj has read ob, the
// f32 sum round(y) + b2 + MLP(round(y)) takes kt and ob's place (N x
// (C + 4) floats fit in two 64 x (C + 8) bf16 tiles). At C = 256 with kp
// 64 and 3 stages: 206,336 bytes.

#pragma once

#include "window_tc.cuh"

namespace {

struct TcStyleLayout {
  size_t kt, ob, xs, vt, qkv, ring, mean, rstd, total;
};

__host__ __device__ inline TcStyleLayout tc_style_layout(int n, int c,
                                                         int kp,
                                                         int stages) {
  (void)n;  // every tile has 64 rows; the f32 tile's n rows fit kt + ob
  TcStyleLayout l;
  const size_t tile = 2 * kTcRows * (c + 8);
  size_t o = 0;
  l.kt = o;   o = align16(o + tile);
  l.ob = o;   o = align16(o + tile);
  l.xs = l.kt;
  l.vt = o;   o = align16(o + tile);
  l.qkv = o;  o = align16(o + 2 * 3 * kTcRows * kTcLdp);
  l.ring = o; o = align16(o + 2 * stages * kp * kTcLdp);
  l.mean = o; o = align16(o + sizeof(float) * 2 * kTcRows);
  l.rstd = o; o = align16(o + sizeof(float) * 2 * kTcRows);
  l.total = o;
  return l;
}

// One block of NT threads on (window blockIdx.x, image blockIdx.y, stream
// blockIdx.z: 0 Scale, 1 Shift) of N <= 64 tokens, head dim DH (16, 32 or
// 64), C % 32 == 0, hidden % 128 == 0, weight tiles of a.plan.kp rows in a
// ring of S. Fields of A as style_block.cu's EncoderArgs.
template <int DH, int S, int NT, typename A>
__device__ __forceinline__ void encoder_scale_shift_tc(const A& a,
                                                       unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  const int tid = threadIdx.x;
  const int C = static_cast<int>(a.C), N = static_cast<int>(a.N);
  const int hidden = static_cast<int>(a.hidden);
  const int kp = static_cast<int>(a.plan.kp);
  const int w = blockIdx.x, b = blockIdx.y;
  const bool shift_stream = blockIdx.z == 1;
  const float scale = static_cast<float>(a.scale);
  const TcStyleLayout L = tc_style_layout(N, C, kp, S);
  bf16* kt = reinterpret_cast<bf16*>(smem + L.kt);    // zp(LN1 Key)
  bf16* ob = reinterpret_cast<bf16*>(smem + L.ob);    // head outputs
  bf16* vt = reinterpret_cast<bf16*>(smem + L.vt);    // zp(LN1 V), round(y)
  float* xs = reinterpret_cast<float*>(smem + L.xs);  // the f32 output sum
  bf16* qs = reinterpret_cast<bf16*>(smem + L.qkv);   // a head group's q
  bf16* ks = qs + kTcRows * kTcLdp;
  bf16* vs = ks + kTcRows * kTcLdp;
  bf16* hid = qs;                                     // an MLP chunk
  float* mean = reinterpret_cast<float*>(smem + L.mean);
  float* rstd = reinterpret_cast<float*>(smem + L.rstd);
  const int LDX = C + 4, LDA = C + 8;

  const long long base = (static_cast<long long>(b) * a.nW + w) * N * C;
  const bf16* key = static_cast<const bf16*>(a.key) + base;
  const bf16* vin =
      static_cast<const bf16*>(shift_stream ? a.shift_in : a.scale_in) + base;
  bf16* out = static_cast<bf16*>(shift_stream ? a.shift_out : a.scale_out) +
              base;
  const float* b1 = shift_stream ? a.h_b1 : a.s_b1;
  const float* b2 = shift_stream ? a.h_b2 : a.s_b2;
  const float* pm = a.padmask != nullptr
                        ? a.padmask + static_cast<long long>(w) * N
                        : nullptr;
  const float* mask_w = a.mask != nullptr
                            ? a.mask + static_cast<long long>(w) * N * N
                            : nullptr;
  TcRing<S, NT> ring(
      BlockTiles(static_cast<const bf16*>(a.wqkv),
                 static_cast<const bf16*>(a.wp),
                 static_cast<const bf16*>(shift_stream ? a.h_w1 : a.s_w1),
                 static_cast<const bf16*>(shift_stream ? a.h_w2 : a.s_w2), C,
                 hidden, kp),
      reinterpret_cast<bf16*>(smem + L.ring), kp);
  const int ng = ring.tiles.ng;

  ring.start();

  // 1. Key's and the stream's raw tokens into kt and vt, 16 bytes a piece;
  //    pad rows N..63 zero.
  const int vpc = C >> 3;
  for (int i = tid; i < kTcRows * vpc; i += NT) {
    const int r = i / vpc, c = (i - r * vpc) * 8;
    uint4 uk = make_uint4(0u, 0u, 0u, 0u), uv = uk;
    if (r < N) {
      uk = *reinterpret_cast<const uint4*>(key + r * C + c);
      uv = *reinterpret_cast<const uint4*>(vin + r * C + c);
    }
    *reinterpret_cast<uint4*>(kt + r * LDA + c) = uk;
    *reinterpret_cast<uint4*>(vt + r * LDA + c) = uv;
  }
  __syncthreads();

  // 2. In place on both tiles: LN1 (statistics of Key's rows, then the
  //    stream's) rounded to bf16, and the pad tokens zeroed.
  if (a.n1s != nullptr) {
    tc_row_stats<NT>(kt, LDA, N, C, mean, rstd);
    tc_row_stats<NT>(vt, LDA, N, C, mean + kTcRows, rstd + kTcRows);
    __syncthreads();
  }
  if (a.n1s != nullptr || pm != nullptr) {
    const int half = N * (C >> 1);
    for (int i = tid; i < 2 * half; i += NT) {
      const int s = i / half, j = i - s * half;
      const int r = j / (C >> 1), c = (j - r * (C >> 1)) * 2;
      bf16* e = (s == 0 ? kt : vt) + r * LDA + c;
      float v0 = 0.f, v1 = 0.f;
      if (!(pm != nullptr && __ldg(pm + r) == 0.f)) {
        v0 = __bfloat162float(e[0]);
        v1 = __bfloat162float(e[1]);
        if (a.n1s != nullptr) {
          const int sr = s * kTcRows + r;
          const float2 s2 = __ldg(reinterpret_cast<const float2*>(a.n1s + c));
          const float2 t2 = __ldg(reinterpret_cast<const float2*>(a.n1b + c));
          v0 = (v0 - mean[sr]) * rstd[sr] * s2.x + t2.x;
          v1 = (v1 - mean[sr]) * rstd[sr] * s2.y + t2.y;
        }
      }
      *reinterpret_cast<uint32_t*>(e) = pack_bf16x2(v0, v1);
    }
  }

  // 3. Per head group: q and k from Key's view (q scaled), v from the
  //    stream's through the shared wv, then its heads' attention.
  for (int gi = 0; gi < ng; ++gi) {
    const int wg = min(kTcPanel, C - gi * kTcPanel);
    for (int part = 0; part < 3; ++part) {
      ring.gemm(part < 2 ? kt : vt, LDA, C, wg);
      bf16* dst = part == 0 ? qs : part == 1 ? ks : vs;
      const float* bq = a.bqkv + part * C + gi * kTcPanel;
      ring.epilogue(wg, bq, [&](int r, int c, float a0, float a1, float b0,
                                float b1_) {
        float v0 = round_bf16(a0 + b0), v1 = round_bf16(a1 + b1_);
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
                            a.rel_bias);
  }

  // 4. round(y) = round(V_raw + heads . wp + bp) over the stream's view,
  //    which no product reads any more; V_raw from device memory.
  for (int pn = 0; pn < ng; ++pn) {
    const int width = min(kTcPanel, C - pn * kTcPanel);
    ring.gemm(ob, LDA, C, width);
    ring.epilogue(width, a.bp + pn * kTcPanel,
                  [&](int r, int c, float a0, float a1, float b0, float b1_) {
      if (r < N) {
        const int col = pn * kTcPanel + c;
        const bf16* raw = vin + r * C + col;
        *reinterpret_cast<uint32_t*>(vt + r * LDA + col) =
            pack_bf16x2(__bfloat162float(raw[0]) + a0 + b0,
                        __bfloat162float(raw[1]) + a1 + b1_);
      }
    });
  }
  __syncthreads();

  // 5. The f32 output sum starts at round(y) + b2, over kt and ob (proj has
  //    read ob: the barrier).
  for (int i = tid; i < N * (C >> 1); i += NT) {
    const int r = i / (C >> 1), c = (i - r * (C >> 1)) * 2;
    const bf16* y = vt + r * LDA + c;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + c));
    *reinterpret_cast<float2*>(xs + r * LDX + c) =
        make_float2(__bfloat162float(y[0]) + bb.x,
                    __bfloat162float(y[1]) + bb.y);
  }

  // 6. The stream's MLP on round(y) by 128-wide hidden chunks: hid =
  //    GELU(round(y) . w1 + b1) rounded to bf16, then the sum accumulates
  //    hid . w2.
  for (int j = 0; j < hidden / kTcPanel; ++j) {
    ring.gemm(vt, LDA, C, kTcPanel);
    ring.epilogue(kTcPanel, b1 + j * kTcPanel,
                  [&](int r, int c, float a0, float a1, float b0, float b1_) {
      *reinterpret_cast<uint32_t*>(hid + r * kTcLdp + c) =
          pack_bf16x2(gelu(a0 + b0), gelu(a1 + b1_));
    });
    for (int pn = 0; pn < ng; ++pn) {
      const int width = min(kTcPanel, C - pn * kTcPanel);
      ring.gemm(hid, kTcLdp, kTcPanel, width);
      ring.epilogue(width, nullptr,
                    [&](int r, int c, float a0, float a1, float, float) {
        if (r < N) {
          float2* d = reinterpret_cast<float2*>(xs + r * LDX +
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

  // 7. Store, 16 bytes a piece.
  for (int i = tid; i < N * vpc; i += NT) {
    const int r = i / vpc, c = (i - r * vpc) * 8;
    const float* s = xs + r * LDX + c;
    uint4 u;
    u.x = pack_bf16x2(s[0], s[1]);
    u.y = pack_bf16x2(s[2], s[3]);
    u.z = pack_bf16x2(s[4], s[5]);
    u.w = pack_bf16x2(s[6], s[7]);
    *reinterpret_cast<uint4*>(out + r * C + c) = u;
  }
}

}  // namespace
