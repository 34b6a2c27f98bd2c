// Whole Swin transformer block on 7x7 windows, hand-written for Hopper.
//
// Replaces the TPU kernels K1 `fused_window_block_rows` and K2
// `fused_window_block` of mastermetastyletransfer_tpu/ops/pallas_attention.py
// (both run `_block_compute`). One computation, two entry points:
//
//   mmst_window_block_rows     x is the window-padded NHWC image (B, Hp, Wp, C);
//                              the cyclic shift (-sh, -sw) is folded into the
//                              token index arithmetic, and each output token
//                              is written back where it was read, so the
//                              result is in the plain (un-rolled) frame.
//   mmst_window_block_windows  x is already partitioned: (B, nW, N, C).
//
// Per window: LN1 (pad tokens' normed view zeroed by the validity mask) ->
// q, k, v from one fused (C, 3C) weight -> per head q k^T * scale +
// relative-position bias + shift mask, softmax in f32, . v -> proj ->
// + residual -> optional LN2 -> fc1, GELU (erff), fc2 -> + residual.
// Products accumulate in f32. Intermediates are rounded to the input type T
// at the same points as the JAX kernel: after LN1, after the qkv projection,
// after q*scale, the softmax numerators before the value product, the head
// outputs, the LN2 output and the GELU output.
//
// What bounds it on an H100: at the slice's shapes (bf16, C = 128/256,
// 49-token windows) the work is some 400k bf16 operations per token against
// 4C bytes read and written, so the card's tensor-core rate bounds it, not
// its memory. This first version keeps every intermediate of a window in
// shared memory, so device memory sees each token once in and once out plus
// the weights through L2 -- the byte side is at its minimum -- but it does the
// products with scalar FMAs on the CUDA cores, so it runs well below that
// bound. Moving the four products to wgmma is the next step for speed.
//
// Design: one thread block of 256 threads per (image, window). Shared memory
// holds the window's residual stream in f32, the normed tile, the head
// outputs, one head's q/k/v and its 49x49 scores; the MLP hidden dimension
// runs in chunks of C so that C = 256 fits. Weights stream from device
// memory (L2-resident: every block reads the same ones). No warp shuffles:
// row statistics use one thread per row, which costs little beside the
// products and keeps every step a plain loop between barriers.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC. Plain C interface; each entry returns the CUDA
// error code of its launch (0 on success).

#include "window_common.cuh"

// The entry points' argument block. It stays outside the anonymous
// namespace: a type with internal linkage would hide the extern "C" entries.
namespace mmst {

// Mirrors WindowBlockArgs in ops/window_block.py field for field: every
// field is 8 bytes, so the two layouts agree without padding rules.
struct Args {
  const void* x;          // T
  void* out;              // T, same shape as x
  const void* wqkv;       // T (C, 3C): [wq | wk | wv]
  const float* bqkv;      // (3C)
  const void* wp;         // T (C, C)
  const float* bp;        // (C)
  const float* rel_bias;  // (heads, N, N)
  const float* mask;      // (nW, N, N) or null
  const float* padmask;   // (nW, N) or null
  const float* n1s;       // (C) or null: no LN1
  const float* n1b;
  const float* n2s;       // (C) or null: no LN2
  const float* n2b;
  const void* w1;         // T (C, hidden)
  const float* b1;        // (hidden)
  const void* w2;         // T (hidden, C)
  const float* b2;        // (C)
  double scale;           // head_dim ** -0.5
  long long dtype;        // 0 float32, 1 bfloat16
  long long B, Hp, Wp, C, heads, hidden;
  long long wh, ww, sh, sw;
  long long nW;           // windows per image
};

}  // namespace mmst

namespace {

using mmst::Args;

struct Layout {
  size_t xs, ln, ob, qh, kh, vh, sc, rs, mean, rstd, toff, total;
};

__host__ __device__ inline Layout smem_layout(int n, int c, int dh,
                                              int tsize) {
  Layout l;
  size_t o = 0;
  l.xs = o;   o = align16(o + sizeof(float) * n * ld_f32(c));
  l.ln = o;   o = align16(o + tsize * n * ld_t(c, tsize));
  l.ob = o;   o = align16(o + tsize * n * ld_t(c, tsize));
  l.qh = o;   o = align16(o + tsize * n * ld_t(dh, tsize));
  l.kh = o;   o = align16(o + tsize * n * ld_t(dh, tsize));
  l.vh = o;   o = align16(o + tsize * n * ld_t(dh, tsize));
  l.sc = o;   o = align16(o + sizeof(float) * n * n);
  l.rs = o;   o = align16(o + sizeof(float) * n);
  l.mean = o; o = align16(o + sizeof(float) * n);
  l.rstd = o; o = align16(o + sizeof(float) * n);
  l.toff = o; o = align16(o + sizeof(long long) * n);
  l.total = o;
  return l;
}

// Offset of token t of window w of image b in x (and in out).
template <bool kRows>
__device__ __forceinline__ long long token_offset(const Args& a, int b, int w,
                                                  int t) {
  const int n = static_cast<int>(a.wh * a.ww);
  if (kRows) {
    const int nww = static_cast<int>(a.Wp / a.ww);
    const int wr = w / nww, wc = w % nww;
    const int i = t / static_cast<int>(a.ww), j = t % static_cast<int>(a.ww);
    long long r = wr * a.wh + i + a.sh;
    if (r >= a.Hp) r -= a.Hp;
    long long c = wc * a.ww + j + a.sw;
    if (c >= a.Wp) c -= a.Wp;
    return ((b * a.Hp + r) * a.Wp + c) * a.C;
  }
  return ((static_cast<long long>(b) * a.nW + w) * n + t) * a.C;
}

template <typename T, bool kRows>
__global__ void __launch_bounds__(kThreads)
window_block_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(a.C);
  const int N = static_cast<int>(a.wh * a.ww);
  const int heads = static_cast<int>(a.heads);
  const int dh = C / heads;
  const int hidden = static_cast<int>(a.hidden);
  const int w = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const float scale = static_cast<float>(a.scale);

  const Layout L = smem_layout(N, C, dh, sizeof(T));
  float* xs = reinterpret_cast<float*>(smem + L.xs);  // residual stream
  T* ln = reinterpret_cast<T*>(smem + L.ln);          // LN1, later LN2 out
  T* ob = reinterpret_cast<T*>(smem + L.ob);          // heads, later hidden
  T* qh = reinterpret_cast<T*>(smem + L.qh);
  T* kh = reinterpret_cast<T*>(smem + L.kh);
  T* vh = reinterpret_cast<T*>(smem + L.vh);
  float* sc = reinterpret_cast<float*>(smem + L.sc);  // one head's scores
  float* rs = reinterpret_cast<float*>(smem + L.rs);  // 1 / softmax sums
  float* mean = reinterpret_cast<float*>(smem + L.mean);
  float* rstd = reinterpret_cast<float*>(smem + L.rstd);
  long long* toff = reinterpret_cast<long long*>(smem + L.toff);
  const int LDX = ld_f32(C), LDT = ld_t(C, sizeof(T));
  const int LDH = ld_t(dh, sizeof(T));

  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const T* wqkv = static_cast<const T*>(a.wqkv);
  const T* wp = static_cast<const T*>(a.wp);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);

  // 1. Load the window's tokens into the f32 residual stream.
  for (int t = tid; t < N; t += nthr) toff[t] = token_offset<kRows>(a, b, w, t);
  __syncthreads();
  for (int e = tid; e < N * C; e += nthr) {
    const int t = e / C, c = e % C;
    xs[t * LDX + c] = to_f(x[toff[t] + c]);
  }
  __syncthreads();

  // 2. LN1 (two-pass statistics, one thread per row), pad tokens zeroed.
  if (a.n1s != nullptr) row_stats(xs, LDX, N, C, mean, rstd);
  for (int e = tid; e < N * C; e += nthr) {
    const int t = e / C, c = e % C;
    float v = xs[t * LDX + c];
    if (a.n1s != nullptr)
      v = round_t<T>((v - mean[t]) * rstd[t] * a.n1s[c] + a.n1b[c]);
    if (a.padmask != nullptr && a.padmask[static_cast<long long>(w) * N + t] == 0.f)
      v = 0.f;
    ln[t * LDT + c] = from_f<T>(v);
  }
  __syncthreads();

  // 3. Attention, one head at a time.
  const float* mask_w =
      a.mask != nullptr ? a.mask + static_cast<long long>(w) * N * N : nullptr;
  for (int h = 0; h < heads; ++h) {
    // 3a. This head's q, k, v: columns h*dh.. of each third of wqkv.
    block_gemm(
        ln, LDT, N, C, wqkv, 3 * a.C, 3 * dh,
        [&](int n) { return (n / dh) * C + h * dh + n % dh; },
        [&](int m, int n, float acc) {
          const int part = n / dh, d = n % dh;
          const float v = round_t<T>(acc + a.bqkv[part * C + h * dh + d]);
          if (part == 0)
            qh[m * LDH + d] = from_f<T>(v * scale);
          else if (part == 1)
            kh[m * LDH + d] = from_f<T>(v);
          else
            vh[m * LDH + d] = from_f<T>(v);
        });
    __syncthreads();
    // 3b. Scores, softmax, head output into columns h*dh.. of ob.
    attend_head(qh, kh, vh, LDH, N, dh,
                a.rel_bias + static_cast<long long>(h) * N * N, mask_w, sc,
                rs, ob, LDT, h * dh);
  }

  // 4. y = x + proj(heads) + bp, in place in the residual stream.
  block_gemm(ob, LDT, N, C, wp, a.C, C, [](int n) { return n; },
             [&](int m, int n, float acc) {
               xs[m * LDX + n] = xs[m * LDX + n] + acc + a.bp[n];
             });
  __syncthreads();

  // 5. LN2 (or the plain y) rounded to T as the MLP input.
  if (a.n2s != nullptr) row_stats(xs, LDX, N, C, mean, rstd);
  for (int e = tid; e < N * C; e += nthr) {
    const int t = e / C, c = e % C;
    float v = xs[t * LDX + c];
    if (a.n2s != nullptr) v = (v - mean[t]) * rstd[t] * a.n2s[c] + a.n2b[c];
    ln[t * LDT + c] = from_f<T>(v);
  }
  __syncthreads();
  for (int e = tid; e < N * C; e += nthr) {
    const int t = e / C, c = e % C;
    xs[t * LDX + c] += a.b2[c];
  }
  __syncthreads();

  // 6. MLP over hidden chunks of C: ob = GELU(ln . w1[:, chunk] + b1), then
  //    the residual stream accumulates ob . w2[chunk, :].
  for (int c0 = 0; c0 < hidden; c0 += C) {
    block_gemm(ln, LDT, N, C, w1 + c0, a.hidden, C, [](int n) { return n; },
               [&](int m, int n, float acc) {
                 ob[m * LDT + n] = from_f<T>(gelu(acc + a.b1[c0 + n]));
               });
    __syncthreads();
    block_gemm(ob, LDT, N, C, w2 + static_cast<long long>(c0) * C, a.C, C,
               [](int n) { return n; },
               [&](int m, int n, float acc) { xs[m * LDX + n] += acc; });
    __syncthreads();
  }

  // 7. Store, each token where it was read.
  for (int e = tid; e < N * C; e += nthr) {
    const int t = e / C, c = e % C;
    out[toff[t] + c] = from_f<T>(xs[t * LDX + c]);
  }
}

template <typename T, bool kRows>
int launch(const Args& a, cudaStream_t stream) {
  const int n = static_cast<int>(a.wh * a.ww);
  const int c = static_cast<int>(a.C);
  const Layout L = smem_layout(n, c, c / static_cast<int>(a.heads), sizeof(T));
  const dim3 grid(static_cast<unsigned>(a.nW), static_cast<unsigned>(a.B));
  return launch_kernel(window_block_kernel<T, kRows>, grid, L.total, stream,
                       a);
}

template <bool kRows>
int dispatch(const Args* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 1) return launch<__nv_bfloat16, kRows>(*a, s);
  return launch<float, kRows>(*a, s);
}

}  // namespace

extern "C" {

// Shared memory in bytes that one block of the kernel takes.
long long mmst_window_block_smem_bytes(long long n, long long c,
                                       long long heads, long long tsize) {
  return static_cast<long long>(
      smem_layout(static_cast<int>(n), static_cast<int>(c),
                  static_cast<int>(c / heads), static_cast<int>(tsize))
          .total);
}

int mmst_window_block_rows(const mmst::Args* a, void* stream) {
  return dispatch<true>(a, stream);
}

int mmst_window_block_windows(const mmst::Args* a, void* stream) {
  return dispatch<false>(a, stream);
}

}  // extern "C"
