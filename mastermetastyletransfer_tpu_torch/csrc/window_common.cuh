// Pieces shared by the port's kernels (window_block.cu, block_pair.cu,
// style_block.cu, phase_conv.cu, ...): the block size, type conversion and
// rounding to the input type T, shared-memory strides, a block-wide GEMM
// with its A tile in shared memory, row statistics, one attention head over
// a window, and the whole Swin block on one window (the scalar body: K1,
// K2 and K11 at f32).
//
// No warp shuffles anywhere: every step is a plain loop between barriers.
// That keeps the sources runnable under a CPU emulation of the thread model
// (one thread per CUDA thread, a barrier for __syncthreads).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kRowBlock = 7;  // rows of A per GEMM work item

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// GELU with the exact erf, as torch.nn.GELU().
__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// Row strides in shared memory, padded by one 4-byte word so that one
// thread per row (row statistics) or per key (scores) hits distinct banks.
__host__ __device__ inline int ld_f32(int n) { return n + 1; }
__host__ __device__ inline int ld_t(int n, int tsize) {
  return n + 4 / tsize;
}
__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// out(m, n) = sum_k A[m][k] * W[k][col(n)] for m < M, n < ncols; A in shared
// memory (row stride lda), W in device memory (row stride ldw). A work item
// is kRowBlock rows of one column: a warp covers 32 neighbouring columns of
// the same rows, so its A reads are broadcasts and its W reads coalesce.
template <typename TA, typename TW, typename ColMap, typename Epi>
__device__ __forceinline__ void block_gemm(const TA* A, int lda, int M, int K,
                                           const TW* W, long long ldw,
                                           int ncols, ColMap col, Epi epi) {
  const int nrb = (M + kRowBlock - 1) / kRowBlock;
  for (int it = threadIdx.x; it < nrb * ncols; it += blockDim.x) {
    const int n = it % ncols;
    const int m0 = (it / ncols) * kRowBlock;
    const TW* wcol = W + col(n);
    const TA* arow[kRowBlock];
    float acc[kRowBlock];
#pragma unroll
    for (int r = 0; r < kRowBlock; ++r) {
      arow[r] = A + static_cast<size_t>(min(m0 + r, M - 1)) * lda;
      acc[r] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float w = to_f(wcol[k * ldw]);
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r) acc[r] += to_f(arow[r][k]) * w;
    }
#pragma unroll
    for (int r = 0; r < kRowBlock; ++r)
      if (m0 + r < M) epi(m0 + r, n, acc[r]);
  }
}

// LayerNorm statistics of rows 0..N-1 of x (row stride ld, C columns):
// two-pass mean and biased variance in f32, one thread per row. Ends with a
// barrier.
template <typename TX>
__device__ __forceinline__ void row_stats(const TX* x, int ld, int N, int C,
                                          float* mean, float* rstd) {
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += to_f(x[t * ld + c]);
    const float mu = s / C;
    float v = 0.f;
    for (int c = 0; c < C; ++c) {
      const float d = to_f(x[t * ld + c]) - mu;
      v += d * d;
    }
    mean[t] = mu;
    rstd[t] = rsqrtf(v / C + 1e-5f);
  }
  __syncthreads();
}

// One attention head of one window: scores q k^T + (mask + bias), softmax in
// f32 with the numerators rounded to T before the value product, and the
// head output (p . v) / sum rounded to T into columns col0.. of ob. qh is
// already scaled. sc (N*N f32) and rs (N f32) are scratch. Ends with a
// barrier.
template <typename T>
__device__ __forceinline__ void attend_head(
    const T* qh, const T* kh, const T* vh, int ldh, int N, int dh,
    const float* bias_h, const float* mask_w, float* sc, float* rs, T* ob,
    int ldo, int col0) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int e = tid; e < N * N; e += nthr) {
    const int i = e / N, j = e % N;
    float s = 0.f;
    for (int d = 0; d < dh; ++d)
      s += to_f(qh[i * ldh + d]) * to_f(kh[j * ldh + d]);
    const float comb = (mask_w != nullptr ? mask_w[e] : 0.f) + bias_h[e];
    sc[e] = s + comb;
  }
  __syncthreads();
  for (int i = tid; i < N; i += nthr) {
    float mx = sc[i * N];
    for (int j = 1; j < N; ++j) mx = fmaxf(mx, sc[i * N + j]);
    float sum = 0.f;
    for (int j = 0; j < N; ++j) {
      const float p = expf(sc[i * N + j] - mx);
      sum += p;
      sc[i * N + j] = round_t<T>(p);
    }
    rs[i] = 1.f / sum;
  }
  __syncthreads();
  for (int e = tid; e < N * dh; e += nthr) {
    const int i = e / dh, d = e % dh;
    float o = 0.f;
    for (int j = 0; j < N; ++j) o += sc[i * N + j] * to_f(vh[j * ldh + d]);
    ob[i * ldo + col0 + d] = from_f<T>(o * rs[i]);
  }
  __syncthreads();
}

// Shared memory of the per-window body: the window's residual stream in
// f32, the normed tile, the head outputs, one head's q/k/v and its scores,
// the row statistics and the tokens' offsets in device memory.
struct BlockLayout {
  size_t xs, ln, ob, qh, kh, vh, sc, rs, mean, rstd, toff, total;
};

__host__ __device__ inline BlockLayout block_smem_layout(int n, int c, int dh,
                                                         int tsize) {
  BlockLayout l;
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

// A load of x, through L2 only where kL2Only: the K11 kernel's second block
// reads what other thread blocks of the same launch wrote.
template <bool kL2Only>
__device__ __forceinline__ float load_x(const float* p) {
  if (kL2Only) return __ldcg(p);
  return *p;
}
template <bool kL2Only>
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  if (kL2Only) return to_f(__ldcg(p));
  return to_f(*p);
}

// The whole Swin block on one window of N tokens (kThreads threads):
// LN1 (pad tokens' normed view zeroed by the validity mask) -> q, k, v from
// one fused (C, 3C) weight -> per head q k^T * scale + relative-position
// bias + shift mask, softmax in f32, . v -> proj -> + residual -> optional
// LN2 -> fc1, GELU (erff), fc2 -> + residual. Token t is read from
// x[toff[t] ..] and its result written to out[toff[t] ..]; the caller fills
// toff (the layout's slot of `smem`) and passes a barrier first. mask_w
// (N x N) and pm_w (N) are this window's shift and validity masks, or null.
// Products accumulate in f32; intermediates round to T after LN1, after the
// qkv projection, after q * scale, the softmax numerators before the value
// product, the head outputs, the LN2 output and the GELU output.
//
// W holds the block's weights in fields named as in window_block.cu's Args:
// wqkv (C, 3C), wp (C, C), w1 (C, hidden), w2 (hidden, C) as pointers to T
// (void pointers there), and the f32 vectors bqkv, bp, rel_bias (heads, N,
// N), n1s, n1b, n2s, n2b (a null norm is no norm), b1, b2. The body reads
// them where W lies: a kernel's parameter struct stays in the constant
// bank. (Copied into a local struct first, the pointers took registers,
// and K1 ran 35-55% slower at the Swin's shapes.)
template <typename T, bool kL2Only, typename W>
__device__ void block_window(const W& p, int C, int heads, int hidden,
                             float scale, const T* x, T* out, int N,
                             const float* mask_w, const float* pm_w,
                             unsigned char* smem) {
  const int dh = C / heads;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const T* wqkv = static_cast<const T*>(p.wqkv);
  const T* wp = static_cast<const T*>(p.wp);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);
  const BlockLayout L = block_smem_layout(N, C, dh, sizeof(T));
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
  const long long* toff = reinterpret_cast<const long long*>(smem + L.toff);
  const int LDX = ld_f32(C), LDT = ld_t(C, sizeof(T));
  const int LDH = ld_t(dh, sizeof(T));
  const long long lc = C, lh = hidden;

  // 1. The window's tokens into the f32 residual stream.
  for (int e = tid; e < N * C; e += nthr) {
    const int t = e / C, c = e % C;
    xs[t * LDX + c] = load_x<kL2Only>(x + toff[t] + c);
  }
  __syncthreads();

  // 2. LN1 (two-pass statistics, one thread per row), pad tokens zeroed.
  if (p.n1s != nullptr) row_stats(xs, LDX, N, C, mean, rstd);
  for (int e = tid; e < N * C; e += nthr) {
    const int t = e / C, c = e % C;
    float v = xs[t * LDX + c];
    if (p.n1s != nullptr)
      v = round_t<T>((v - mean[t]) * rstd[t] * p.n1s[c] + p.n1b[c]);
    if (pm_w != nullptr && pm_w[t] == 0.f) v = 0.f;
    ln[t * LDT + c] = from_f<T>(v);
  }
  __syncthreads();

  // 3. Attention, one head at a time.
  for (int h = 0; h < heads; ++h) {
    // 3a. This head's q, k, v: columns h*dh.. of each third of wqkv.
    block_gemm(
        ln, LDT, N, C, wqkv, 3 * lc, 3 * dh,
        [&](int n) { return (n / dh) * C + h * dh + n % dh; },
        [&](int m, int n, float acc) {
          const int part = n / dh, d = n % dh;
          const float v = round_t<T>(acc + p.bqkv[part * C + h * dh + d]);
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
                p.rel_bias + static_cast<long long>(h) * N * N, mask_w, sc,
                rs, ob, LDT, h * dh);
  }

  // 4. y = x + proj(heads) + bp, in place in the residual stream.
  block_gemm(ob, LDT, N, C, wp, lc, C, [](int n) { return n; },
             [&](int m, int n, float acc) {
               xs[m * LDX + n] = xs[m * LDX + n] + acc + p.bp[n];
             });
  __syncthreads();

  // 5. LN2 (or the plain y) rounded to T as the MLP input.
  if (p.n2s != nullptr) row_stats(xs, LDX, N, C, mean, rstd);
  for (int e = tid; e < N * C; e += nthr) {
    const int t = e / C, c = e % C;
    float v = xs[t * LDX + c];
    if (p.n2s != nullptr) v = (v - mean[t]) * rstd[t] * p.n2s[c] + p.n2b[c];
    ln[t * LDT + c] = from_f<T>(v);
  }
  __syncthreads();
  for (int e = tid; e < N * C; e += nthr) {
    const int t = e / C, c = e % C;
    xs[t * LDX + c] += p.b2[c];
  }
  __syncthreads();

  // 6. MLP over hidden chunks of C: ob = GELU(ln . w1[:, chunk] + b1), then
  //    the residual stream accumulates ob . w2[chunk, :].
  for (int c0 = 0; c0 < hidden; c0 += C) {
    block_gemm(ln, LDT, N, C, w1 + c0, lh, C, [](int n) { return n; },
               [&](int m, int n, float acc) {
                 ob[m * LDT + n] = from_f<T>(gelu(acc + p.b1[c0 + n]));
               });
    __syncthreads();
    block_gemm(ob, LDT, N, C, w2 + static_cast<long long>(c0) * C, lc, C,
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

// The dynamic-shared-memory opt-in of a kernel on the current device.
// Above 48 KB a launch needs cudaFuncAttributeMaxDynamicSharedMemorySize
// at least its size, and that attribute is state of the function shared by
// every host thread: StylizeService runs one worker thread per service and
// ctypes drops the GIL, so two threads may launch one instantiation at two
// sizes (one K1 kernel serves both Swin stages; K5's its convs) at once.
// So the opted-in size lives in one table per library, keyed by (kernel,
// device) under a mutex, and only ever rises: a thread raises it to its
// own size if that is larger, and launches at that size or below, so no
// other thread can lower it under a launch. (The form raises to the size
// asked for rather than once to the device's
// cudaDevAttrMaxSharedMemoryPerBlockOptin: either is race-free, since the
// size launched, not the attribute, sets a block's shared memory and the
// occupancy; this one leaves the attribute as a single-threaded caller set
// it before, which is what attributes() report.) Returns the CUDA error.
struct SmemOptIns {
  std::mutex mu;
  std::map<std::pair<const void*, int>, size_t> bytes;
};

inline SmemOptIns& smem_opt_ins() {
  static SmemOptIns table;
  return table;
}

template <typename Kernel>
int opt_in_smem(Kernel kernel, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  SmemOptIns& t = smem_opt_ins();
  std::lock_guard<std::mutex> lock(t.mu);
  size_t& have = t.bytes[{reinterpret_cast<const void*>(kernel), dev}];
  if (bytes > have) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    have = bytes;
  }
  return 0;
}

// The dynamic shared memory a kernel is opted in to on the current device
// (the largest size a launch has asked for so far; 0 before any).
template <typename Kernel>
long long opted_in_smem(Kernel kernel) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  SmemOptIns& t = smem_opt_ins();
  std::lock_guard<std::mutex> lock(t.mu);
  const auto it = t.bytes.find({reinterpret_cast<const void*>(kernel), dev});
  return it == t.bytes.end() ? 0 : static_cast<long long>(it->second);
}

// A kernel's static shared memory, dynamic shared memory opted in so far on
// the current device, and registers per thread.
template <typename Kernel>
int attributes_of(Kernel kernel, long long* smem, long long* dyn,
                  long long* regs) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<long long>(attr.sharedSizeBytes);
  *dyn = opted_in_smem(kernel);
  *regs = static_cast<long long>(attr.numRegs);
  return 0;
}

// attributes_of, and the local memory (spills) per thread.
template <typename Kernel>
int local_attributes(Kernel kernel, long long* smem, long long* dyn,
                     long long* regs, long long* local) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *local = static_cast<long long>(attr.localSizeBytes);
  return attributes_of(kernel, smem, dyn, regs);
}

// Opt the kernel in to `bytes` of dynamic shared memory (opt_in_smem) and
// launch it on `grid` x `threads`; returns the CUDA error code (0 on
// success).
template <typename Kernel, typename A>
int launch_kernel(Kernel kernel, dim3 grid, size_t bytes, cudaStream_t stream,
                  const A& args, int threads = kThreads) {
  const int err = opt_in_smem(kernel, bytes);
  if (err != 0) return err;
  kernel<<<grid, threads, bytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
