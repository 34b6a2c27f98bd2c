// Swin patch embedding (a ps x ps stride-ps conv) with its LayerNorm,
// hand-written for Hopper.
//
// Replaces the TPU kernel K13 `pallas_patch_embed` (body
// `_patch_embed_kernel`) of mastermetastyletransfer_tpu/ops/pallas_conv.py:
//
//   mmst_patch_embed  x (B, H, W, Cin) -> (B, H/ps, W/ps, E):
//                     y = bias + sum over the ps x ps taps and Cin of
//                     x[b, ps i + dy, ps j + dx, c] w[dy, dx, c, :], in f32,
//                     then (where LN scale and bias are given) LayerNorm over
//                     E in f32 (biased variance, eps 1e-5), rounded once to
//                     the type T of x.
//
// As in the JAX package, no model path calls it (the Swin's patch embedding
// is a space-to-depth GEMM or a strided conv, models/swin.py).
//
// What bounds it on an H100: at (16, 512, 512, 3) -> (16, 128, 128, 128)
// bf16 it reads 25 MB and writes 67 MB for 3.2 GFLOP, so the memory.
// Design: a thread block takes kTile patches of one row of patches: their
// ps x ps x Cin pixels and the (ps ps Cin, E) weights (f32) sit in shared
// memory, each thread sums whole output elements, the f32 rows of the tile
// stay in shared memory for the LayerNorm statistics (one thread per patch,
// two passes), and each output is written once.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC. Plain C interface; the entry returns the CUDA
// error code of its launch (0 on success).

#include "window_common.cuh"

// The entry point's argument block. It stays outside the anonymous
// namespace: a type with internal linkage would hide the extern "C" entry.
namespace mmst {

// Mirrors PatchArgs in ops/patch_embed.py field for field.
struct PatchArgs {
  const void* x;        // T (B, H, W, Cin)
  const void* w;        // T (ps ps Cin, E), rows in (dy, dx, c) order
  const float* bias;    // (E)
  const float* ln_s;    // (E) or null: no LayerNorm
  const float* ln_b;    // (E)
  void* out;            // T (B, H / ps, W / ps, E)
  long long dtype;      // 0 float32, 1 bfloat16
  long long B, H, W, Cin, E, ps;
};

}  // namespace mmst

namespace {

using mmst::PatchArgs;

constexpr int kTile = 32;  // patches per thread block

__host__ __device__ inline size_t patch_smem_floats(long long k,
                                                    long long e) {
  return static_cast<size_t>(k * e + kTile * k + kTile * (e + 1) +
                             2 * kTile);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_embed_kernel(const PatchArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ps = static_cast<int>(a.ps), cin = static_cast<int>(a.Cin);
  const int E = static_cast<int>(a.E), K = ps * ps * cin;
  const long long wc = a.W / ps, hc = a.H / ps;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long row = blockIdx.y, b = blockIdx.z;
  const int np = static_cast<int>(wc - p0 < kTile ? wc - p0 : kTile);
  float* Ws = reinterpret_cast<float*>(smem);     // K x E
  float* Xs = Ws + static_cast<size_t>(K) * E;    // kTile x K
  float* Ys = Xs + static_cast<size_t>(kTile) * K;  // kTile x (E + 1)
  float* mean = Ys + static_cast<size_t>(kTile) * (E + 1);
  float* rstd = mean + kTile;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);

  for (int e = tid; e < K * E; e += nthr) Ws[e] = to_f(w[e]);
  for (int e = tid; e < np * K; e += nthr) {
    const int p = e / K, k = e % K;
    const int dy = k / (ps * cin), dx = (k / cin) % ps, c = k % cin;
    Xs[e] = to_f(x[((b * a.H + row * ps + dy) * a.W + (p0 + p) * ps + dx) *
                       cin + c]);
  }
  __syncthreads();

  for (int e = tid; e < np * E; e += nthr) {
    const int p = e / E, n = e % E;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc += Xs[p * K + k] * Ws[k * E + n];
    Ys[p * (E + 1) + n] = acc + a.bias[n];
  }
  __syncthreads();

  if (a.ln_s != nullptr) row_stats(Ys, E + 1, np, E, mean, rstd);
  T* out = static_cast<T*>(a.out);
  for (int e = tid; e < np * E; e += nthr) {
    const int p = e / E, n = e % E;
    float v = Ys[p * (E + 1) + n];
    if (a.ln_s != nullptr) v = (v - mean[p]) * rstd[p] * a.ln_s[n] + a.ln_b[n];
    out[((b * hc + row) * wc + p0 + p) * E + n] = from_f<T>(v);
  }
}

template <typename T>
int launch(const PatchArgs& a, cudaStream_t stream) {
  const long long wc = a.W / a.ps;
  const dim3 grid(static_cast<unsigned>((wc + kTile - 1) / kTile),
                  static_cast<unsigned>(a.H / a.ps),
                  static_cast<unsigned>(a.B));
  return launch_kernel(patch_embed_kernel<T>, grid,
                       sizeof(float) * patch_smem_floats(
                                           a.ps * a.ps * a.Cin, a.E),
                       stream, a);
}

}  // namespace

extern "C" {

// Shared memory in bytes of one thread block, for K = ps ps Cin taps and E
// outputs.
long long mmst_patch_embed_smem_bytes(long long k, long long e) {
  return static_cast<long long>(sizeof(float) * patch_smem_floats(k, e));
}

int mmst_patch_embed(const mmst::PatchArgs* a, void* stream) {
  if (a->ps < 1 || a->W % a->ps || a->H < a->ps || a->E < 1 || a->Cin < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 1) return launch<__nv_bfloat16>(*a, s);
  return launch<float>(*a, s);
}

}  // extern "C"
