// Pieces shared by the backward kernels (ln_mlp.cu, window_attention.cu):
// the weight gradient of a linear layer, summed over every row of a batch,
// and the deterministic reduction of per-block partial sums.
//
// A weight gradient dW = A^T B sums over all rows (tokens) of the batch.
// The forward's blocks each own a few rows, so the gradient is a sum across
// blocks; instead of atomics, every block of the wgrad product takes one
// tile of dW and a fixed chunk of the rows (`splits` chunks of
// ceil(rows / splits)), writes its f32 partial, and reduce_parts_kernel
// adds the chunks' partials in a fixed order: the same inputs give the same
// bits on every run. Two products: at bf16 wgrad_tc_kernel, on the tensor
// cores (64 x 128 tiles of dW, 8 warps, A^T's fragments from ldmatrix.trans
// of row-major row tiles, both operands streamed through a cp.async ring
// of 32-row stages); at f32 wgrad_kernel, 32 x 32 tiles of scalar FMAs
// (plain loops between barriers, as window_common.cuh).

#pragma once

#include <type_traits>

#include "mma_common.cuh"
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
// parts added in order. A thread issues 16 parts' loads before it adds
// them (in order), so that their latencies overlap: the sums run over a
// few columns and hundreds of parts.
__global__ void __launch_bounds__(kThreads)
reduce_parts_kernel(const float* parts, long long nparts, long long stride,
                    long long n, float* out) {
  constexpr int kBatch = 16;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    long long p = 0;
    for (; p + kBatch <= nparts; p += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v[u] = parts[(p + u) * stride + i];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s += v[u];
    }
    for (; p < nparts; ++p) s += parts[p * stride + i];
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

// The tensor-core product (bf16): a block of 8 warps per 64 x 128 tile of
// dW (blockIdx.y, blockIdx.x) and row chunk blockIdx.z; warp w holds rows
// 16 (w % 4).. of the tile and its columns 64 (w / 4).. as 8 n8
// accumulators. Each 32-row stage of A (32 x 64) and B (32 x 128) lands by
// cp.async, zero-filled past the chunk's rows and past I or J, kWgS - 1
// stages ahead of its use; the rows are the products' depth: mma's A
// operand (dW's rows) is A^T, whose fragments ldmatrix.trans reads from
// the row-major stage. I, J multiples of 8 and the operands 16-byte
// aligned (the wrapper checks).
constexpr int kWgI = 64, kWgJ = 128;  // a block's tile of dW
constexpr int kWgK = 32;              // rows a stage
constexpr int kWgS = 3;               // stages in the ring
constexpr int kWgLdA = kWgI + 8, kWgLdB = kWgJ + 8;

template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad_tc_kernel(
    const WgradJob<T> j, int splits) {
  __shared__ __align__(16) T as[kWgS][kWgK * kWgLdA];
  __shared__ __align__(16) T bs[kWgS][kWgK * kWgLdB];
  const int j0 = blockIdx.x * kWgJ, i0 = blockIdx.y * kWgI;
  const long long per = (j.rows + splits - 1) / splits;
  const long long r0 = blockIdx.z * per;
  const long long r1 = r0 + per < j.rows ? r0 + per : j.rows;
  const int steps0 =
      r1 > r0 ? static_cast<int>((r1 - r0 + kWgK - 1) / kWgK) : 0;
  const int steps = j.a1 != nullptr ? 2 * steps0 : steps0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;

  // Stage u (of the first product, then the second) into slot u % kWgS,
  // and a commit group, empty past the last stage.
  auto issue = [&](int u) {
    if (u < steps) {
      const bool second = u >= steps0;
      const T* A = second ? j.a1 : j.a0;
      const T* B = second ? j.b1 : j.b0;
      const long long rb = r0 + static_cast<long long>(u - (second ? steps0
                                                                   : 0)) *
                                    kWgK;
      T* ad = as[u % kWgS];
      T* bd = bs[u % kWgS];
      for (int i = threadIdx.x; i < kWgK * (kWgI / 8); i += kThreads) {
        const int rr = i / (kWgI / 8), col = i0 + (i % (kWgI / 8)) * 8;
        const bool ok = rb + rr < r1 && col < j.I;
        cp_async16(ad + rr * kWgLdA + (col - i0),
                   ok ? A + (rb + rr) * j.I + col : A, ok);
      }
      for (int i = threadIdx.x; i < kWgK * (kWgJ / 8); i += kThreads) {
        const int rr = i / (kWgJ / 8), col = j0 + (i % (kWgJ / 8)) * 8;
        const bool ok = rb + rr < r1 && col < j.J;
        cp_async16(bd + rr * kWgLdB + (col - j0),
                   ok ? B + (rb + rr) * j.J + col : B, ok);
      }
    }
    cp_async_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int s = 0; s < kWgS - 1; ++s) issue(s);
  for (int u = 0; u < steps; ++u) {
    cp_async_wait<kWgS - 2>();
    __syncthreads();
    issue(u + kWgS - 1);  // into the slot every warp has left
    const T* at = as[u % kWgS];
    const T* bt = bs[u % kWgS];
#pragma unroll
    for (int kk = 0; kk < kWgK; kk += 16) {
      uint32_t af[4];
      ldsm_x4_trans(af[0], af[1], af[2], af[3],
                    at + (kk + (lane & 7) + ((lane >> 4) << 3)) * kWgLdA +
                        16 * wm + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(b0, b1, b2, b3,
                      bt + (kk + (lane & 15)) * kWgLdB + wn * 64 + nj * 16 +
                          (lane >> 4) * 8);
        mma_bf16(acc[2 * nj], af, b0, b1);
        mma_bf16(acc[2 * nj + 1], af, b2, b3);
      }
    }
  }
  float* part = j.part + static_cast<long long>(blockIdx.z) * j.I * j.J;
  const int row = i0 + 16 * wm + (lane >> 2);
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = j0 + wn * 64 + ni * 8 + 2 * (lane & 3);
    if (col >= j.J) continue;
    if (row < j.I)
      *reinterpret_cast<float2*>(part + static_cast<long long>(row) * j.J +
                                 col) = make_float2(acc[ni][0], acc[ni][1]);
    if (row + 8 < j.I)
      *reinterpret_cast<float2*>(part +
                                 static_cast<long long>(row + 8) * j.J +
                                 col) = make_float2(acc[ni][2], acc[ni][3]);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The weight gradient of one job: partials over `splits` row chunks (the
// tensor-core product at bf16, where I and J are multiples of 8 and every
// operand 16-byte aligned, else cudaErrorMisalignedAddress; scalar FMAs at
// f32), then their sum into j.out.
template <typename T>
int wgrad(const WgradJob<T>& j, int splits, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (j.I % 8 || j.J % 8 || !aligned16(j.a0) || !aligned16(j.b0) ||
        (j.a1 != nullptr && (!aligned16(j.a1) || !aligned16(j.b1))))
      return static_cast<int>(cudaErrorMisalignedAddress);
    const dim3 grid((j.J + kWgJ - 1) / kWgJ, (j.I + kWgI - 1) / kWgI,
                    splits);
    wgrad_tc_kernel<T><<<grid, kThreads, 0, stream>>>(j, splits);
  } else {
    const dim3 grid((j.J + kWTile - 1) / kWTile, (j.I + kWTile - 1) / kWTile,
                    splits);
    wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(j, splits);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long n = static_cast<long long>(j.I) * j.J;
  return reduce_parts(j.part, splits, n, n, j.out, stream);
}

}  // namespace
