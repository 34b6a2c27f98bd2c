// The style transformer's two per-window kernels, hand-written for Hopper.
//
// Replace the TPU kernels of mastermetastyletransfer_tpu/ops/pallas_attention.py
//
//   K3 `fused_encoder_scale_shift` (body `_kernel_enc_ss`)
//      -> mmst_encoder_scale_shift
//   K4 `fused_decoder_tail` (body `_kernel_dec_tail`)
//      -> mmst_decoder_tail
//
// Both take window tensors (B, nW, N, C) of the window-resident style
// transformer and run one softmax per head shared by two value streams.
//
// K3, the encoder's Scale/Shift update: qk = zp(LN1(Key)), v = zp(LN1(V))
// for V in {Scale, Shift}; q = round(qk wq + bq) * scale, k = qk wk + bk,
// v = v wv + bv (one shared wv); per head softmax(q k^T + bias + mask) . v;
// y = V_raw + heads . wp + bp (the raw input, un-normed and not re-zeroed,
// in f32); out = round(y) + MLP_V(round(y)), each stream with its own
// norm-free MLP. zp re-zeroes the pad tokens (padmask); LN1 is optional.
//
// K4, the decoder tail: q and k arrive prepared (their instance norms need
// image-global statistics); q * scale in T, q and k not re-zeroed; vs, vh =
// zp(raw) . wv_scale / wv_shift + b; the same shared-softmax core; sigma =
// heads_s . wp + bp and mu = heads_h . wp + bp in f32; y = Query * sigma +
// mu; out = round(y) + last_MLP(round(y)).
//
// Products accumulate in f32. Intermediates are rounded to the input type T
// where the JAX kernels round them: after LN1 / the pad zeroing, after each
// projection, after q * scale, the softmax numerators, the head outputs,
// y, and the GELU output. GELU uses the exact erf.
//
// What bounds them on an H100: per window 44 N C^2 + 6 N^2 C operations for
// K3 and 24 N C^2 + 6 N^2 C for K4 against 5 and 6 window tiles of bytes,
// some 500 operations per byte at C = 256 in bf16, so the tensor-core rate
// bounds them, not memory. Both keep every intermediate of a window in
// shared memory (device memory sees each input once and each output once,
// plus the weights through L2).
//
// Two bodies each. At bf16, where ops/style_block.py's plans say so (C %
// 32 == 0, head dim 16, 32 or 64, N <= 64, hidden % 128 == 0: the style
// transformer at C = 256), tensor-core bodies built from K1's pieces in
// window_tc.cuh (its weight ring over a tile schedule, 64-row mma.sync
// products, the softmax in registers; one block of 16 warps an SM): K3's
// in style_tc.cuh (style_plan; a block per window and stream), K4's in
// tail_tc.cuh (tail_plan; a block per window, both value streams in it). The
// C entries check the plan against the layout and refuse a mismatch. At
// f32 (no TF32), and for any other shape, the scalar bodies described next,
// whose products are scalar FMAs on the CUDA cores.
//
// Scalar design: 256 threads per block. K3 runs one block per (image, window,
// stream): each recomputes the shared q, k and softmax (some 10% more
// work) so that one stream's tiles fit in shared memory at f32 and C = 256.
// K4 needs both streams in one block (y mixes sigma and mu): it attends with
// the Scale stream, then the Shift stream, recomputing each head's softmax
// (2 N^2 C per head, under 2% of the work), and keeps two head-output tiles.
// Attention runs one head at a time; the MLP runs in hidden chunks of C.
// The f32 tile of y overlays the value tile once attention is done. Shared
// memory per block (N = 49, C = 256): 180,832 B at f32, 121,248 B at bf16.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC. Plain C interface; each entry returns the CUDA
// error code of its launch (0 on success).

#include "style_tc.cuh"
#include "tail_tc.cuh"
#include "window_common.cuh"

// The entry points' argument blocks. They stay outside the anonymous
// namespace: a type with internal linkage would hide the extern "C" entries.
namespace mmst {

// Mirrors EncoderArgs in ops/style_block.py field for field (8 bytes each).
struct EncoderArgs {
  const void* key;        // T (B, nW, N, C)
  const void* scale_in;   // T (B, nW, N, C)
  const void* shift_in;   // T (B, nW, N, C)
  void* scale_out;        // T (B, nW, N, C)
  void* shift_out;        // T (B, nW, N, C)
  const void* wqkv;       // T (C, 3C): [wq | wk | wv]
  const float* bqkv;      // (3C)
  const void* wp;         // T (C, C)
  const float* bp;        // (C)
  const float* rel_bias;  // (heads, N, N)
  const float* mask;      // (nW, N, N) or null
  const float* padmask;   // (nW, N) or null
  const float* n1s;       // (C) or null: no LN1
  const float* n1b;
  const void* s_w1;       // T (C, hidden): the Scale stream's MLP
  const float* s_b1;
  const void* s_w2;       // T (hidden, C)
  const float* s_b2;
  const void* h_w1;       // the Shift stream's MLP, same shapes
  const float* h_b1;
  const void* h_w2;
  const float* h_b2;
  double scale;           // head_dim ** -0.5
  long long dtype;        // 0 float32, 1 bfloat16
  long long B, nW, N, C, heads, hidden;
  TcPlan plan;            // the body and its tiling (window_tc.cuh)
};

// Mirrors DecoderTailArgs in ops/style_block.py field for field.
struct DecoderTailArgs {
  const void* q;          // T (B, nW, N, C), prepared
  const void* k;          // T (B, nW, N, C), prepared
  const void* v_scale;    // T (B, nW, N, C), raw
  const void* v_shift;    // T (B, nW, N, C), raw
  const void* query;      // T (B, nW, N, C)
  void* out;              // T (B, nW, N, C)
  const void* wv;         // T (C, 2C): [wv_scale | wv_shift]
  const float* bv;        // (2C)
  const void* wp;         // T (C, C)
  const float* bp;        // (C)
  const float* rel_bias;  // (heads, N, N)
  const float* mask;      // (nW, N, N) or null
  const float* padmask;   // (nW, N) or null
  const void* w1;         // T (C, hidden): last MLP
  const float* b1;
  const void* w2;         // T (hidden, C)
  const float* b2;
  double scale;
  long long dtype;
  long long B, nW, N, C, heads, hidden;
  TcPlan plan;            // the body and its tiling (window_tc.cuh)
};

}  // namespace mmst

namespace {

using mmst::DecoderTailArgs;
using mmst::EncoderArgs;

// Shared memory of one block, both kernels: two T tiles (a, ob), one tile
// (b) that holds T values during attention and the f32 y afterwards, one
// head's q/k/v, its scores, and per-row scratch.
struct Layout {
  size_t a, b, ob, qh, kh, vh, sc, rs, mean, rstd, total;
};

__host__ __device__ inline Layout smem_layout(int n, int c, int dh,
                                              int tsize) {
  const size_t tile_t = static_cast<size_t>(tsize) * n * ld_t(c, tsize);
  const size_t tile_f = sizeof(float) * n * ld_f32(c);
  const size_t head_t = static_cast<size_t>(tsize) * n * ld_t(dh, tsize);
  Layout l;
  size_t o = 0;
  l.a = o;    o = align16(o + tile_t);
  l.b = o;    o = align16(o + (tile_f > tile_t ? tile_f : tile_t));
  l.ob = o;   o = align16(o + tile_t);
  l.qh = o;   o = align16(o + head_t);
  l.kh = o;   o = align16(o + head_t);
  l.vh = o;   o = align16(o + head_t);
  l.sc = o;   o = align16(o + sizeof(float) * n * n);
  l.rs = o;   o = align16(o + sizeof(float) * n);
  l.mean = o; o = align16(o + sizeof(float) * n);
  l.rstd = o; o = align16(o + sizeof(float) * n);
  l.total = o;
  return l;
}

// In place on a T tile: LayerNorm (when s is not null), then pad tokens
// (pm[t] == 0) set to zero, rounded to T. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void norm_and_zero(T* x, int ld, int N, int C,
                                              const float* s, const float* bb,
                                              const float* pm, float* mean,
                                              float* rstd) {
  if (s == nullptr && pm == nullptr) return;
  if (s != nullptr) row_stats(x, ld, N, C, mean, rstd);
  for (int e = threadIdx.x; e < N * C; e += blockDim.x) {
    const int t = e / C, c = e % C;
    float v = to_f(x[t * ld + c]);
    if (s != nullptr) v = (v - mean[t]) * rstd[t] * s[c] + bb[c];
    if (pm != nullptr && pm[t] == 0.f) v = 0.f;
    x[t * ld + c] = from_f<T>(v);
  }
  __syncthreads();
}

// The norm-free MLP residual on y (the f32 tile ys): xin = round(y) is the
// MLP input (T tile) and the residual; hid (T tile) holds one hidden chunk
// of C at a time. Leaves round(y) + fc2(GELU(fc1 round(y))) in ys.
template <typename T>
__device__ __forceinline__ void mlp_residual(float* ys, int ldx, T* xin,
                                             T* hid, int ldt, int N, int C,
                                             int hidden, const T* w1,
                                             const float* b1, const T* w2,
                                             const float* b2) {
  for (int e = threadIdx.x; e < N * C; e += blockDim.x) {
    const int t = e / C, c = e % C;
    const float v = round_t<T>(ys[t * ldx + c]);
    xin[t * ldt + c] = from_f<T>(v);
    ys[t * ldx + c] = v + b2[c];
  }
  __syncthreads();
  for (int c0 = 0; c0 < hidden; c0 += C) {
    block_gemm(xin, ldt, N, C, w1 + c0, hidden, C, [](int n) { return n; },
               [&](int m, int n, float acc) {
                 hid[m * ldt + n] = from_f<T>(gelu(acc + b1[c0 + n]));
               });
    __syncthreads();
    block_gemm(hid, ldt, N, C, w2 + static_cast<long long>(c0) * C, C, C,
               [](int n) { return n; },
               [&](int m, int n, float acc) { ys[m * ldx + n] += acc; });
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
encoder_scale_shift_kernel(const EncoderArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(a.C);
  const int N = static_cast<int>(a.N);
  const int heads = static_cast<int>(a.heads);
  const int dh = C / heads;
  const int hidden = static_cast<int>(a.hidden);
  const int w = blockIdx.x, b = blockIdx.y;
  const bool shift_stream = blockIdx.z == 1;
  const float scale = static_cast<float>(a.scale);

  const Layout L = smem_layout(N, C, dh, sizeof(T));
  T* qk = reinterpret_cast<T*>(smem + L.a);      // zp(LN1 Key), then round(y)
  T* vt = reinterpret_cast<T*>(smem + L.b);      // zp(LN1 V)
  float* ys = reinterpret_cast<float*>(smem + L.b);  // y, after attention
  T* ob = reinterpret_cast<T*>(smem + L.ob);     // heads, then MLP hidden
  T* qh = reinterpret_cast<T*>(smem + L.qh);
  T* kh = reinterpret_cast<T*>(smem + L.kh);
  T* vh = reinterpret_cast<T*>(smem + L.vh);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* rs = reinterpret_cast<float*>(smem + L.rs);
  float* mean = reinterpret_cast<float*>(smem + L.mean);
  float* rstd = reinterpret_cast<float*>(smem + L.rstd);
  const int LDX = ld_f32(C), LDT = ld_t(C, sizeof(T));
  const int LDH = ld_t(dh, sizeof(T));

  const long long base = (static_cast<long long>(b) * a.nW + w) * N * C;
  const T* key = static_cast<const T*>(a.key) + base;
  const T* vin =
      static_cast<const T*>(shift_stream ? a.shift_in : a.scale_in) + base;
  T* out = static_cast<T*>(shift_stream ? a.shift_out : a.scale_out) + base;
  const T* wqkv = static_cast<const T*>(a.wqkv);
  const T* wp = static_cast<const T*>(a.wp);
  const T* w1 = static_cast<const T*>(shift_stream ? a.h_w1 : a.s_w1);
  const float* b1 = shift_stream ? a.h_b1 : a.s_b1;
  const T* w2 = static_cast<const T*>(shift_stream ? a.h_w2 : a.s_w2);
  const float* b2 = shift_stream ? a.h_b2 : a.s_b2;
  const float* pm =
      a.padmask != nullptr ? a.padmask + static_cast<long long>(w) * N
                           : nullptr;
  const float* mask_w =
      a.mask != nullptr ? a.mask + static_cast<long long>(w) * N * N
                        : nullptr;

  // 1. The window's raw Key and V tokens; LN1 and the pad zeroing in place.
  for (int e = threadIdx.x; e < N * C; e += blockDim.x) {
    const int t = e / C, c = e % C;
    qk[t * LDT + c] = key[e];
    vt[t * LDT + c] = vin[e];
  }
  __syncthreads();
  norm_and_zero(qk, LDT, N, C, a.n1s, a.n1b, pm, mean, rstd);
  norm_and_zero(vt, LDT, N, C, a.n1s, a.n1b, pm, mean, rstd);

  // 2. Attention, one head at a time: q and k from the Key tile (columns
  //    h*dh.. of the first two thirds of wqkv), v from the V tile.
  for (int h = 0; h < heads; ++h) {
    block_gemm(
        qk, LDT, N, C, wqkv, 3 * a.C, 2 * dh,
        [&](int n) { return (n / dh) * C + h * dh + n % dh; },
        [&](int m, int n, float acc) {
          const int part = n / dh, d = n % dh;
          const float v = round_t<T>(acc + a.bqkv[part * C + h * dh + d]);
          if (part == 0)
            qh[m * LDH + d] = from_f<T>(v * scale);
          else
            kh[m * LDH + d] = from_f<T>(v);
        });
    block_gemm(
        vt, LDT, N, C, wqkv, 3 * a.C, dh,
        [&](int n) { return 2 * C + h * dh + n; },
        [&](int m, int n, float acc) {
          vh[m * LDH + n] = from_f<T>(acc + a.bqkv[2 * C + h * dh + n]);
        });
    __syncthreads();
    attend_head(qh, kh, vh, LDH, N, dh,
                a.rel_bias + static_cast<long long>(h) * N * N, mask_w, sc,
                rs, ob, LDT, h * dh);
  }

  // 3. y = V_raw + heads . wp + bp in f32, over the V tile (no longer read).
  block_gemm(ob, LDT, N, C, wp, a.C, C, [](int n) { return n; },
             [&](int m, int n, float acc) {
               ys[m * LDX + n] =
                   to_f(vin[static_cast<long long>(m) * C + n]) + acc + a.bp[n];
             });
  __syncthreads();

  // 4. out = round(y) + MLP(round(y)).
  mlp_residual(ys, LDX, qk, ob, LDT, N, C, hidden, w1, b1, w2, b2);
  for (int e = threadIdx.x; e < N * C; e += blockDim.x) {
    const int t = e / C, c = e % C;
    out[e] = from_f<T>(ys[t * LDX + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decoder_tail_kernel(const DecoderTailArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(a.C);
  const int N = static_cast<int>(a.N);
  const int heads = static_cast<int>(a.heads);
  const int dh = C / heads;
  const int hidden = static_cast<int>(a.hidden);
  const int w = blockIdx.x, b = blockIdx.y;
  const float scale = static_cast<float>(a.scale);

  const Layout L = smem_layout(N, C, dh, sizeof(T));
  T* ob_s = reinterpret_cast<T*>(smem + L.a);    // Scale heads, then round(y)
  T* vt = reinterpret_cast<T*>(smem + L.b);      // zp(v) of one stream
  float* ys = reinterpret_cast<float*>(smem + L.b);  // y, after attention
  T* ob_h = reinterpret_cast<T*>(smem + L.ob);   // Shift heads, then hidden
  T* qh = reinterpret_cast<T*>(smem + L.qh);
  T* kh = reinterpret_cast<T*>(smem + L.kh);
  T* vh = reinterpret_cast<T*>(smem + L.vh);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* rs = reinterpret_cast<float*>(smem + L.rs);
  const int LDX = ld_f32(C), LDT = ld_t(C, sizeof(T));
  const int LDH = ld_t(dh, sizeof(T));

  const long long base = (static_cast<long long>(b) * a.nW + w) * N * C;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* query = static_cast<const T*>(a.query) + base;
  T* out = static_cast<T*>(a.out) + base;
  const T* wv = static_cast<const T*>(a.wv);
  const T* wp = static_cast<const T*>(a.wp);
  const float* pm =
      a.padmask != nullptr ? a.padmask + static_cast<long long>(w) * N
                           : nullptr;
  const float* mask_w =
      a.mask != nullptr ? a.mask + static_cast<long long>(w) * N * N
                        : nullptr;

  // 1. Each value stream in turn (Scale, then Shift): its raw tokens with
  //    the pad tokens zeroed, projected per head through its own wv, and
  //    attended with the shared softmax (recomputed for the second stream).
  for (int s = 0; s < 2; ++s) {
    const T* vin = static_cast<const T*>(s == 0 ? a.v_scale : a.v_shift) + base;
    T* ob = s == 0 ? ob_s : ob_h;
    for (int e = threadIdx.x; e < N * C; e += blockDim.x) {
      const int t = e / C, c = e % C;
      vt[t * LDT + c] =
          (pm != nullptr && pm[t] == 0.f) ? from_f<T>(0.f) : vin[e];
    }
    __syncthreads();
    for (int h = 0; h < heads; ++h) {
      for (int e = threadIdx.x; e < N * dh; e += blockDim.x) {
        const int t = e / dh, d = e % dh;
        const long long off = static_cast<long long>(t) * C + h * dh + d;
        qh[t * LDH + d] = from_f<T>(to_f(q[off]) * scale);
        kh[t * LDH + d] = k[off];
      }
      block_gemm(
          vt, LDT, N, C, wv, 2 * a.C, dh,
          [&](int n) { return s * C + h * dh + n; },
          [&](int m, int n, float acc) {
            vh[m * LDH + n] = from_f<T>(acc + a.bv[s * C + h * dh + n]);
          });
      __syncthreads();
      attend_head(qh, kh, vh, LDH, N, dh,
                  a.rel_bias + static_cast<long long>(h) * N * N, mask_w, sc,
                  rs, ob, LDT, h * dh);
    }
  }

  // 2. sigma = heads_s . wp + bp over the value tile (no longer read), then
  //    y = Query * sigma + (heads_h . wp + bp), all in f32.
  block_gemm(ob_s, LDT, N, C, wp, a.C, C, [](int n) { return n; },
             [&](int m, int n, float acc) {
               ys[m * LDX + n] = acc + a.bp[n];
             });
  __syncthreads();
  block_gemm(ob_h, LDT, N, C, wp, a.C, C, [](int n) { return n; },
             [&](int m, int n, float acc) {
               ys[m * LDX + n] =
                   to_f(query[static_cast<long long>(m) * C + n]) *
                       ys[m * LDX + n] +
                   (acc + a.bp[n]);
             });
  __syncthreads();

  // 3. out = round(y) + last_MLP(round(y)).
  mlp_residual(ys, LDX, ob_s, ob_h, LDT, N, C, hidden,
               static_cast<const T*>(a.w1), a.b1,
               static_cast<const T*>(a.w2), a.b2);
  for (int e = threadIdx.x; e < N * C; e += blockDim.x) {
    const int t = e / C, c = e % C;
    out[e] = from_f<T>(ys[t * LDX + c]);
  }
}

// K3 at bf16 on the tensor-core body: one block of NT threads per (window,
// image, stream), a ring of S tiles.
template <int DH, int S, int NT>
__global__ void __launch_bounds__(NT, 1)
encoder_scale_shift_tc_kernel(const EncoderArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  encoder_scale_shift_tc<DH, S, NT>(a, smem);
}

// The tensor-core body's launch: the plan must be one style_plan gives for
// this call (checked here), its shared memory what the layout needs.
int launch_tc(const EncoderArgs& a, cudaStream_t stream) {
  const mmst::TcPlan& p = a.plan;
  const long long c = a.C, dh = a.heads ? c / a.heads : 0;
  if (p.body != 1 ||
      !tc_plan_ok(p, a.dtype, a.N, c, a.heads, a.hidden,
                  tc_style_layout(static_cast<int>(a.N), static_cast<int>(c),
                                  static_cast<int>(p.kp), 3)
                      .total))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(a.nW), static_cast<unsigned>(a.B), 2);
  const size_t bytes = static_cast<size_t>(p.smem_bytes);
  if (dh == 16)
    return launch_kernel(encoder_scale_shift_tc_kernel<16, 3, 512>, grid,
                         bytes, stream, a, 512);
  if (dh == 32)
    return launch_kernel(encoder_scale_shift_tc_kernel<32, 3, 512>, grid,
                         bytes, stream, a, 512);
  return launch_kernel(encoder_scale_shift_tc_kernel<64, 3, 512>, grid,
                       bytes, stream, a, 512);
}

// K4 at bf16 on the tensor-core body: one block of NT threads per (window,
// image), a ring of S tiles.
template <int DH, int S, int NT>
__global__ void __launch_bounds__(NT, 1)
decoder_tail_tc_kernel(const DecoderTailArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  decoder_tail_tc<DH, S, NT>(a, smem);
}

// K4's tensor-core launch: the plan must be one tail_plan gives for this
// call (checked here), its shared memory what the layout needs.
int launch_tail_tc(const DecoderTailArgs& a, cudaStream_t stream) {
  const mmst::TcPlan& p = a.plan;
  const long long c = a.C, dh = a.heads ? c / a.heads : 0;
  if (p.body != 1 ||
      !tc_plan_ok(p, a.dtype, a.N, c, a.heads, a.hidden,
                  tc_tail_layout(static_cast<int>(a.N), static_cast<int>(c),
                                 static_cast<int>(p.kp), 3)
                      .total))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(a.nW), static_cast<unsigned>(a.B));
  const size_t bytes = static_cast<size_t>(p.smem_bytes);
  if (dh == 16)
    return launch_kernel(decoder_tail_tc_kernel<16, 3, 512>, grid, bytes,
                         stream, a, 512);
  if (dh == 32)
    return launch_kernel(decoder_tail_tc_kernel<32, 3, 512>, grid, bytes,
                         stream, a, 512);
  return launch_kernel(decoder_tail_tc_kernel<64, 3, 512>, grid, bytes,
                       stream, a, 512);
}

template <typename T, typename A, typename Kernel>
int launch(Kernel kernel, const A& a, unsigned streams, cudaStream_t stream) {
  const Layout L = smem_layout(static_cast<int>(a.N), static_cast<int>(a.C),
                               static_cast<int>(a.C / a.heads), sizeof(T));
  const dim3 grid(static_cast<unsigned>(a.nW), static_cast<unsigned>(a.B),
                  streams);
  return launch_kernel(kernel, grid, L.total, stream, a);
}

}  // namespace

extern "C" {

// Shared memory in bytes that one block of either kernel takes.
long long mmst_style_block_smem_bytes(long long n, long long c,
                                      long long heads, long long tsize) {
  return static_cast<long long>(
      smem_layout(static_cast<int>(n), static_cast<int>(c),
                  static_cast<int>(c / heads), static_cast<int>(tsize))
          .total);
}

// Static shared memory, dynamic shared memory opted in so far on the
// current device and registers per thread of K3's kernel: body 0 the
// scalar kernel at dtype (0 f32, 1 bf16), body 1 the tensor-core kernel of
// head dim dh.
int mmst_encoder_scale_shift_attributes(long long body, long long dtype,
                                        long long dh, long long* smem,
                                        long long* dyn, long long* regs) {
  if (body == 1) {
    if (dh == 16)
      return attributes_of(encoder_scale_shift_tc_kernel<16, 3, 512>, smem,
                           dyn, regs);
    if (dh == 32)
      return attributes_of(encoder_scale_shift_tc_kernel<32, 3, 512>, smem,
                           dyn, regs);
    if (dh == 64)
      return attributes_of(encoder_scale_shift_tc_kernel<64, 3, 512>, smem,
                           dyn, regs);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return attributes_of(encoder_scale_shift_kernel<__nv_bfloat16>, smem,
                         dyn, regs);
  return attributes_of(encoder_scale_shift_kernel<float>, smem, dyn, regs);
}

// The same for K4's kernels: body 0 the scalar kernel at dtype, body 1
// the tensor-core kernel of head dim dh.
int mmst_decoder_tail_attributes(long long body, long long dtype,
                                 long long dh, long long* smem,
                                 long long* dyn, long long* regs) {
  if (body == 1) {
    if (dh == 16)
      return attributes_of(decoder_tail_tc_kernel<16, 3, 512>, smem, dyn,
                           regs);
    if (dh == 32)
      return attributes_of(decoder_tail_tc_kernel<32, 3, 512>, smem, dyn,
                           regs);
    if (dh == 64)
      return attributes_of(decoder_tail_tc_kernel<64, 3, 512>, smem, dyn,
                           regs);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return attributes_of(decoder_tail_kernel<__nv_bfloat16>, smem, dyn, regs);
  return attributes_of(decoder_tail_kernel<float>, smem, dyn, regs);
}

int mmst_encoder_scale_shift(const mmst::EncoderArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->plan.body == 1) return launch_tc(*a, s);
  if (a->plan.body != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a->dtype == 1)
    return launch<__nv_bfloat16>(encoder_scale_shift_kernel<__nv_bfloat16>,
                                 *a, 2, s);
  return launch<float>(encoder_scale_shift_kernel<float>, *a, 2, s);
}

int mmst_decoder_tail(const mmst::DecoderTailArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->plan.body == 1) return launch_tail_tc(*a, s);
  if (a->plan.body != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a->dtype == 1)
    return launch<__nv_bfloat16>(decoder_tail_kernel<__nv_bfloat16>, *a, 1,
                                 s);
  return launch<float>(decoder_tail_kernel<float>, *a, 1, s);
}

}  // extern "C"
