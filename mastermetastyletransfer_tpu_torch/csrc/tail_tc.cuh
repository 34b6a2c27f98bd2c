// K4, the style transformer's decoder tail, on Hopper's tensor cores: the
// bf16 body of mmst_decoder_tail (style_block.cu has the function and the
// launch, ops/style_block.py:tail_plan the tiling and tail_tile_schedule
// the order of its weight tiles, and tests/test_torch_tail_tc_plan.py
// replays it in torch). It computes what the scalar K4 body computes, with
// the same rounding points; only the order of the f32 sums differs.
//
// Built from K1's pieces (window_tc.cuh): the weight ring TcRing over a
// schedule of its own (TailTiles), the 64-row panel product, a head group's
// attention with the softmax in registers (tc_attend_group).
//
// What bounds it: some 24 N C^2 + 6 N^2 C bf16 operations per window
// against six window tiles of bytes, so the tensor cores.
//
// Design: one block of 16 warps per (window, image), both value streams in
// it, since y mixes sigma and mu. Rounding points
// (pallas_attention.py:_kernel_dec_tail): q = round(q scale), k as given
// (q and k arrive prepared and are not re-zeroed); v_s = round(zp(V_scale)
// wv_s + bv_s) and v_h likewise (zp zeroes the pad tokens); the softmax
// numerators; the head outputs; sigma = heads_s wp + bp and mu = heads_h wp
// + bp in f32; y = Query sigma + mu in f32, rounded once; out = round(y) +
// fc2(round(GELU(fc1 round(y) + b1))) + b2.
//
// Order, each stream in turn (Scale, then Shift), each head group (a
// 128-column panel of C) in turn: the q panel (scaled, rounded) and the k
// panel straight from device memory, the v panel through the ring from the
// stream's columns of wv, then the group's attention, the softmax
// recomputed for the second stream (2 N^2 C a head, under 2% of the work).
// Then proj, per 128-column panel of C: sigma's product, parked in f32 in
// the q/k/v panels' place (idle once the attention is done), then mu's
// product against the same wp tiles streamed a second time, whose epilogue
// reads Query from device memory and writes round(y) over the value view.
// Streaming wp twice costs 14% more weight reads through L2 at C = 256; a
// product with two A tiles and two accumulator sets would read wp once, but
// holds 16 more f32 registers a thread in a body that K3 shows at 127-128
// of its 128. Then the MLP by 128-wide hidden chunks, as K3's.
//
// The ring's order (TailTiles; ops/style_block.py:tail_tile_schedule): per
// stream s, per head group gi, wv's panel [:, s C + 128 gi ..] over K = C;
// per 128-column panel pn of C, wp's panel over K = C twice (sigma, mu);
// then the MLP as K1's.
//
// Shared memory (tc_tail_layout; ops/style_block.py:tail_layout computes
// the same): the two head-output tiles ob_s and ob_h and the value view vt
// (64 x C bf16 each, rows padded by 16 bytes), a head group's q, k, v (three
// 64 x 128 tiles; sigma's f32 panel during proj; the MLP's hidden chunk
// after), and the ring. Once proj has read both head tiles, the f32 output
// sum (N x (C + 4) floats, 50,960 bytes at C = 256) takes ob_s and ob_h's
// place (67,584). At C = 256 with kp 64 and 3 stages: 205,824 bytes.

#pragma once

#include "window_tc.cuh"

namespace {

// K4's tile order: wv (C, 2C) per stream and head group; wp (C, C) twice a
// panel; the MLP.
struct TailTiles : MlpTiles {
  const bf16 *wv, *wp;
  int t1, t2, total;

  __device__ __forceinline__ TailTiles(const bf16* wv_, const bf16* wp_,
                                       const bf16* w1_, const bf16* w2_,
                                       int C_, int hidden_, int kp_)
      : MlpTiles(w1_, w2_, C_, hidden_, kp_), wv(wv_), wp(wp_) {
    t1 = 2 * ng * nk;
    t2 = 2 * ng * nk;
    total = t1 + t2 + count();
  }

  __device__ __forceinline__ const bf16* tile(int u, int& ld,
                                              int& width) const {
    if (u < t1) {
      const int s = u / (ng * nk), gi = (u / nk) % ng, kt = u % nk;
      ld = 2 * C;
      width = min(kTcPanel, C - gi * kTcPanel);
      return wv + static_cast<long long>(kt * kp) * ld + s * C +
             gi * kTcPanel;
    }
    if (u < t1 + t2) {
      const int v = u - t1, pn = v / (2 * nk), kt = v % nk;
      ld = C;
      width = min(kTcPanel, C - pn * kTcPanel);
      return wp + static_cast<long long>(kt * kp) * ld + pn * kTcPanel;
    }
    return MlpTiles::tile(u - t1 - t2, ld, width);
  }
};

constexpr int kTcSigLd = kTcPanel + 4;  // row stride of sigma's f32 panel

struct TcTailLayout {
  size_t ob_s, ob_h, xs, vt, qkv, sig, ring, total;
};

__host__ __device__ inline TcTailLayout tc_tail_layout(int n, int c, int kp,
                                                       int stages) {
  (void)n;  // every tile has 64 rows; the f32 tile's n rows fit ob_s + ob_h
  TcTailLayout l;
  const size_t tile = 2 * kTcRows * (c + 8);
  size_t o = 0;
  l.ob_s = o; o = align16(o + tile);
  l.ob_h = o; o = align16(o + tile);
  l.xs = l.ob_s;
  l.vt = o;   o = align16(o + tile);
  l.qkv = o;  o = align16(o + 2 * 3 * kTcRows * kTcLdp);
  l.sig = l.qkv;  // 64 x kTcSigLd floats fit the three panels
  l.ring = o; o = align16(o + 2 * stages * kp * kTcLdp);
  l.total = o;
  return l;
}

// One block of NT threads on (window blockIdx.x, image blockIdx.y) of N <=
// 64 tokens, head dim DH (16, 32 or 64), C % 32 == 0, hidden % 128 == 0,
// weight tiles of a.plan.kp rows in a ring of S. Fields of A as
// style_block.cu's DecoderTailArgs.
template <int DH, int S, int NT, typename A>
__device__ __forceinline__ void decoder_tail_tc(const A& a,
                                                unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  const int tid = threadIdx.x;
  const int C = static_cast<int>(a.C), N = static_cast<int>(a.N);
  const int hidden = static_cast<int>(a.hidden);
  const int kp = static_cast<int>(a.plan.kp);
  const int w = blockIdx.x, b = blockIdx.y;
  const float scale = static_cast<float>(a.scale);
  const TcTailLayout L = tc_tail_layout(N, C, kp, S);
  bf16* const obs[2] = {reinterpret_cast<bf16*>(smem + L.ob_s),
                        reinterpret_cast<bf16*>(smem + L.ob_h)};
  bf16* vt = reinterpret_cast<bf16*>(smem + L.vt);    // zp(V), then round(y)
  float* xs = reinterpret_cast<float*>(smem + L.xs);  // the f32 output sum
  bf16* qs = reinterpret_cast<bf16*>(smem + L.qkv);   // a head group's q
  bf16* ks = qs + kTcRows * kTcLdp;
  bf16* vs = ks + kTcRows * kTcLdp;
  bf16* hid = qs;                                     // an MLP chunk
  float* sig = reinterpret_cast<float*>(smem + L.sig);  // sigma's panel
  const int LDX = C + 4, LDA = C + 8;

  const long long base = (static_cast<long long>(b) * a.nW + w) * N * C;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* query = static_cast<const bf16*>(a.query) + base;
  bf16* out = static_cast<bf16*>(a.out) + base;
  const float* pm = a.padmask != nullptr
                        ? a.padmask + static_cast<long long>(w) * N
                        : nullptr;
  const float* mask_w = a.mask != nullptr
                            ? a.mask + static_cast<long long>(w) * N * N
                            : nullptr;
  TcRing<S, NT, TailTiles> ring(
      TailTiles(static_cast<const bf16*>(a.wv),
                static_cast<const bf16*>(a.wp),
                static_cast<const bf16*>(a.w1),
                static_cast<const bf16*>(a.w2), C, hidden, kp),
      reinterpret_cast<bf16*>(smem + L.ring), kp);
  const int ng = ring.tiles.ng;
  const int vpc = C >> 3;

  ring.start();

  // 1. Each value stream in turn: its raw tokens with the pad tokens
  //    zeroed into vt (pad rows N..63 zero), 16 bytes a piece; per head
  //    group the q and k panels, the v panel through the ring, then the
  //    group's attention into the stream's head tile. (vt's last reader,
  //    the previous stream's v product, passed a barrier before its
  //    attention.)
  for (int s = 0; s < 2; ++s) {
    const bf16* vin =
        static_cast<const bf16*>(s == 0 ? a.v_scale : a.v_shift) + base;
    for (int i = tid; i < kTcRows * vpc; i += NT) {
      const int r = i / vpc, c = (i - r * vpc) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < N && !(pm != nullptr && __ldg(pm + r) == 0.f))
        u = *reinterpret_cast<const uint4*>(vin + r * C + c);
      *reinterpret_cast<uint4*>(vt + r * LDA + c) = u;
    }
    for (int gi = 0; gi < ng; ++gi) {
      const int wg = min(kTcPanel, C - gi * kTcPanel);
      const int vpg = wg >> 3;
      // The previous group's attention has read qs, ks and vs.
      __syncthreads();
      for (int i = tid; i < kTcRows * vpg; i += NT) {
        const int r = i / vpg, c = (i - r * vpg) * 8;
        uint4 uq = make_uint4(0u, 0u, 0u, 0u), uk = uq;
        if (r < N) {
          const long long off = static_cast<long long>(r) * C +
                                gi * kTcPanel + c;
          const uint4 raw = *reinterpret_cast<const uint4*>(q + off);
          const bf16* e = reinterpret_cast<const bf16*>(&raw);
          uq.x = pack_bf16x2(__bfloat162float(e[0]) * scale,
                             __bfloat162float(e[1]) * scale);
          uq.y = pack_bf16x2(__bfloat162float(e[2]) * scale,
                             __bfloat162float(e[3]) * scale);
          uq.z = pack_bf16x2(__bfloat162float(e[4]) * scale,
                             __bfloat162float(e[5]) * scale);
          uq.w = pack_bf16x2(__bfloat162float(e[6]) * scale,
                             __bfloat162float(e[7]) * scale);
          uk = *reinterpret_cast<const uint4*>(k + off);
        }
        *reinterpret_cast<uint4*>(qs + r * kTcLdp + c) = uq;
        *reinterpret_cast<uint4*>(ks + r * kTcLdp + c) = uk;
      }
      ring.gemm(vt, LDA, C, wg);
      ring.epilogue(wg, a.bv + s * C + gi * kTcPanel,
                    [&](int r, int c, float a0, float a1, float b0,
                        float b1) {
        *reinterpret_cast<uint32_t*>(vs + r * kTcLdp + c) =
            pack_bf16x2(a0 + b0, a1 + b1);
      });
      __syncthreads();
      tc_attend_group<DH, NT>(qs, ks, vs, obs[s], LDA, gi * kTcPanel, wg, N,
                              mask_w, a.rel_bias);
    }
  }

  // 2. Per panel of C: sigma = heads_s . wp + bp into sig (the products'
  //    first barrier: every warp is past the attention), then mu = heads_h
  //    . wp + bp and round(y) = round(Query sigma + mu) over vt. Each
  //    thread reads back the sigma elements it wrote (one product shape).
  for (int pn = 0; pn < ng; ++pn) {
    const int width = min(kTcPanel, C - pn * kTcPanel);
    const float* bp = a.bp + pn * kTcPanel;
    ring.gemm(obs[0], LDA, C, width);
    ring.epilogue(width, bp, [&](int r, int c, float a0, float a1, float b0,
                                 float b1) {
      *reinterpret_cast<float2*>(sig + r * kTcSigLd + c) =
          make_float2(a0 + b0, a1 + b1);
    });
    ring.gemm(obs[1], LDA, C, width);
    ring.epilogue(width, bp, [&](int r, int c, float a0, float a1, float b0,
                                 float b1) {
      if (r < N) {
        const int col = pn * kTcPanel + c;
        const float2 sg = *reinterpret_cast<const float2*>(
            sig + r * kTcSigLd + c);
        const bf16* qr = query + r * C + col;
        *reinterpret_cast<uint32_t*>(vt + r * LDA + col) =
            pack_bf16x2(__bfloat162float(qr[0]) * sg.x + (a0 + b0),
                        __bfloat162float(qr[1]) * sg.y + (a1 + b1));
      }
    });
  }
  __syncthreads();

  // 3. The f32 output sum starts at round(y) + b2, over ob_s and ob_h
  //    (proj has read them: the barrier).
  for (int i = tid; i < N * (C >> 1); i += NT) {
    const int r = i / (C >> 1), c = (i - r * (C >> 1)) * 2;
    const bf16* y = vt + r * LDA + c;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b2 + c));
    *reinterpret_cast<float2*>(xs + r * LDX + c) =
        make_float2(__bfloat162float(y[0]) + bb.x,
                    __bfloat162float(y[1]) + bb.y);
  }

  // 4. The last MLP on round(y) by 128-wide hidden chunks: hid =
  //    GELU(round(y) . w1 + b1) rounded to bf16, then the sum accumulates
  //    hid . w2.
  for (int j = 0; j < hidden / kTcPanel; ++j) {
    ring.gemm(vt, LDA, C, kTcPanel);
    ring.epilogue(kTcPanel, a.b1 + j * kTcPanel,
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

  // 5. Store, 16 bytes a piece.
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
