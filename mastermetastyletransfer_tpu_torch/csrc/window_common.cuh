// Pieces shared by the port's kernels (window_block.cu, style_block.cu,
// phase_conv.cu): the block size, type conversion and rounding to the
// input type T,
// shared-memory strides, a block-wide GEMM with its A tile in shared memory,
// row statistics, and one attention head over a window.
//
// No warp shuffles anywhere: every step is a plain loop between barriers.
// That keeps the sources runnable under a CPU emulation of the thread model
// (one thread per CUDA thread, a barrier for __syncthreads).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// Opt the kernel in to `bytes` of dynamic shared memory and launch it on
// `grid` x kThreads; returns the CUDA error code (0 on success).
template <typename Kernel, typename A>
int launch_kernel(Kernel kernel, dim3 grid, size_t bytes, cudaStream_t stream,
                  const A& args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, bytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
