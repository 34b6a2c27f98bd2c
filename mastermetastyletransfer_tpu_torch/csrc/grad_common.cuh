// Pieces shared by the backward kernels (ln_mlp.cu, window_attention.cu):
// the weight gradient of a linear layer, summed over every row of a batch,
// and the deterministic reduction of per-block partial sums.
//
// A weight gradient dW = A^T B sums over all rows (tokens) of the batch.
// The forward's blocks each own a few rows, so the gradient is a sum across
// blocks; instead of atomics, wgrad_kernel gives every block a 32 x 32 tile
// of dW and a fixed chunk of the rows, writes its f32 partial, and
// reduce_parts_kernel adds the chunks' partials in a fixed order: the same
// inputs give the same bits on every run.
//
// No warp shuffles: plain loops between barriers, as window_common.cuh.

#pragma once

#include "window_common.cuh"

namespace {

constexpr int kWTile = 32;  // dW tile side; kThreads / kWTile rows of 4

// out = A0^T B0 (+ A1^T B1): A (rows, I) and B (rows, J) row-major in T,
// out (I, J) f32. part holds (splits, I, J) partials.
template <typename T>
struct WgradJob {
  const T* a0;
  const T* b0;
  const T* a1;  // optional second product, or null
  const T* b1;
  float* part;
  float* out;
  long long rows;
  int I, J;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(const WgradJob<T> j,
                                                         int splits) {
  __shared__ float as[kWTile][kWTile + 1];
  __shared__ float bs[kWTile][kWTile + 1];
  const int j0 = blockIdx.x * kWTile, i0 = blockIdx.y * kWTile;
  const int split = blockIdx.z;
  const long long per = (j.rows + splits - 1) / splits;
  const long long r0 = split * per;
  const long long r1 = r0 + per < j.rows ? r0 + per : j.rows;
  const int tx = threadIdx.x % kWTile, ty = threadIdx.x / kWTile;
  constexpr int kPer = kWTile * kWTile / kThreads;  // outputs per thread
  float acc[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) acc[u] = 0.f;
  for (int pair = 0; pair < 2; ++pair) {
    const T* A = pair == 0 ? j.a0 : j.a1;
    const T* B = pair == 0 ? j.b0 : j.b1;
    if (A == nullptr) continue;  // the same for every thread
    for (long long r = r0; r < r1; r += kWTile) {
      for (int e = threadIdx.x; e < kWTile * kWTile; e += blockDim.x) {
        const int rr = e / kWTile, cc = e % kWTile;
        const long long row = r + rr;
        const bool in = row < r1;
        as[rr][cc] = in && i0 + cc < j.I ? to_f(A[row * j.I + i0 + cc]) : 0.f;
        bs[rr][cc] = in && j0 + cc < j.J ? to_f(B[row * j.J + j0 + cc]) : 0.f;
      }
      __syncthreads();
      for (int rr = 0; rr < kWTile; ++rr) {
        const float bv = bs[rr][tx];
#pragma unroll
        for (int u = 0; u < kPer; ++u) acc[u] += as[rr][ty * kPer + u] * bv;
      }
      __syncthreads();
    }
  }
  float* part = j.part + static_cast<long long>(split) * j.I * j.J;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = i0 + ty * kPer + u, jj = j0 + tx;
    if (i < j.I && jj < j.J) part[static_cast<long long>(i) * j.J + jj] = acc[u];
  }
}

// out[i] = sum over p < nparts of parts[p * stride + i], for i < n, the
// parts added in order.
__global__ void __launch_bounds__(kThreads)
reduce_parts_kernel(const float* parts, long long nparts, long long stride,
                    long long n, float* out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (long long p = 0; p < nparts; ++p) s += parts[p * stride + i];
    out[i] = s;
  }
}

inline int reduce_parts(const float* parts, long long nparts,
                        long long stride, long long n, float* out,
                        cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  reduce_parts_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(parts, nparts, stride, n, out);
  return static_cast<int>(cudaGetLastError());
}

// The weight gradient of one job: partials over `splits` row chunks, then
// their sum into j.out.
template <typename T>
int wgrad(const WgradJob<T>& j, int splits, cudaStream_t stream) {
  const dim3 grid((j.J + kWTile - 1) / kWTile, (j.I + kWTile - 1) / kWTile,
                  splits);
  wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(j, splits);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long n = static_cast<long long>(j.I) * j.J;
  return reduce_parts(j.part, splits, n, n, j.out, stream);
}

}  // namespace
