// The fused [LayerNorm ->] MLP -> + residual, forward and backward,
// hand-written for Hopper.
//
// Replaces the TPU kernels of mastermetastyletransfer_tpu/ops/
//
//   pallas_mlp.py      K10 `fused_ln_mlp_residual` (body `_kernel`)
//                      -> mmst_ln_mlp_residual
//   pallas_mlp_vjp.py  its backward `_run_bwd` (body `_bwd_kernel`)
//                      -> mmst_ln_mlp_residual_bwd
//
// Forward, per row of x (rows, C): h = LN(x) (optional), rounded to T;
// z = round(GELU(h W1 + b1)); out = round(x + z W2 + b2).
// Backward, from x and g alone (the forward recomputed): dz = round(g) W2^T,
// da = dz * GELU'(a), dh = round(da) W1^T, then the LN backward in f32 and
// dx = round(g + dx_ln) (or g + dh); dW1 = round(h)^T round(da), dW2 =
// round(z)^T round(g), db1 = sum da, db2 = sum g, d LN scale = sum dh xhat,
// d LN bias = sum dh. Products accumulate in f32; T roundings where the JAX
// kernels round them; GELU with the exact erf.
//
// What bounds it on an H100: 4 C hidden operations per row forward, 12
// backward with the weight gradients (20 with the recompute), against 4 C
// bytes (8 C) of a row: at C = 256, hidden 1024 in bf16 some 250-400
// operations per byte, the tensor-core rate, not memory.
//
// Two bodies, chosen per call by the plan the wrapper passes
// (ops/ln_mlp.py:mlp_plan; each entry refuses a plan that does not match
// its layout). At bf16 where C % 32 == 0 and hidden % 128 == 0 (every
// training shape): the tensor-core bodies of mlp_tc.cuh, one 64-row tile
// of rows a block, mma.sync products over a cp.async weight ring, the
// forward K1's own MLP steps. Every other call -- f32 above all -- the
// scalar body below: 256 threads a block, 28 rows a block forward (the
// hidden tile in T in shared memory), 14 backward, whose pre-activation a
// (f32) becomes da in place, products as scalar FMAs (block_gemm). Both
// backward bodies write round(h), round(z) and round(da) of their rows to
// device scratch and their column sums (db1, db2, the norm grads) as
// per-block partials. The weight gradients are sums over all rows, which
// grad_common.cuh's wgrad computes over fixed row chunks -- a tensor-core
// product at bf16, scalar FMAs at f32 -- and reduces in a fixed order (no
// atomics: the same inputs give the same bits). The backward reads W1^T and
// W2^T, transposed by the wrapper, so that its products read the weights
// along rows. Scalar shared memory per block at C = 256, hidden 1024, f32
// (bf16): forward 144,032 B (72,352), backward 100,864 B (86,528).
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC. Plain C interface; each entry returns the CUDA
// error code of its launches (0 on success).

#include "grad_common.cuh"
#include "mlp_tc.cuh"

namespace mmst {

// Mirrors LnMlpArgs in ops/ln_mlp.py field for field (8 bytes each).
struct LnMlpArgs {
  const void* x;      // T (rows, C)
  void* out;          // T (rows, C): forward output
  const void* g;      // T (rows, C): the output's gradient
  void* dx;           // T (rows, C)
  const float* ns;    // (C) LN scale, or null: no LN
  const float* nb;    // (C)
  const void* w1;     // T (C, hidden)
  const float* b1;    // (hidden)
  const void* w2;     // T (hidden, C)
  const float* b2;    // (C)
  const void* w1t;    // T (hidden, C) = W1^T
  const void* w2t;    // T (C, hidden) = W2^T
  void* h_t;          // T (rows, C) scratch: round(LN(x)); null without LN
  void* da_t;         // T (rows, hidden) scratch: round(da)
  void* z_t;          // T (rows, hidden) scratch: round(z)
  float* part_vec;    // (tiles, hidden + 3C): db1 | db2 | dns | dnb
  float* part_w;      // (wsplit, C * hidden)
  float* dw1;         // (C, hidden)
  float* db1;         // (hidden)
  float* dw2;         // (hidden, C)
  float* db2;         // (C)
  float* dns;         // (C), or null without LN
  float* dnb;         // (C)
  long long dtype;    // 0 float32, 1 bfloat16
  long long rows, C, hidden, wsplit;
  TcPlan plan;        // the body and its tiling (body 0: the scalar one)
};

}  // namespace mmst

namespace {

using mmst::LnMlpArgs;

constexpr int kRowsFwd = 28;
constexpr int kRowsBwd = 14;
constexpr float kInvSqrt2 = 0.70710678118654752f;

struct Layout {
  size_t h, z, g, dh, mean, rstd, m1, m2, total;
};

// Forward: h (R, C) T, z (R, hidden) T. Backward: h and g (R, C) T, the
// f32 tile of a / da (R, hidden) in z's place, dh (R, C) f32.
__host__ __device__ inline Layout smem_layout(int c, int hidden, int tsize,
                                              bool bwd) {
  const int r = bwd ? kRowsBwd : kRowsFwd;
  Layout l;
  size_t o = 0;
  l.h = o;    o = align16(o + static_cast<size_t>(tsize) * r * ld_t(c, tsize));
  l.z = o;
  o = align16(o + (bwd ? sizeof(float) * r * ld_f32(hidden)
                       : static_cast<size_t>(tsize) * r *
                             ld_t(hidden, tsize)));
  l.g = o;
  if (bwd) o = align16(o + static_cast<size_t>(tsize) * r * ld_t(c, tsize));
  l.dh = o;
  if (bwd) o = align16(o + sizeof(float) * r * ld_f32(c));
  l.mean = o; o = align16(o + sizeof(float) * r);
  l.rstd = o; o = align16(o + sizeof(float) * r);
  l.m1 = o;   o = align16(o + sizeof(float) * r);
  l.m2 = o;   o = align16(o + sizeof(float) * r);
  l.total = o;
  return l;
}

// h = LN(x) * s + b (or x) rounded to T, for the block's M rows; the row
// statistics stay in mean / rstd. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void norm_rows(const T* x, int M, int C,
                                          const float* s, const float* b,
                                          T* h, int ldh, float* mean,
                                          float* rstd) {
  if (s != nullptr) row_stats(x, C, M, C, mean, rstd);
  for (int e = threadIdx.x; e < M * C; e += blockDim.x) {
    const int t = e / C, c = e % C;
    float v = to_f(x[e]);
    if (s != nullptr) v = (v - mean[t]) * rstd[t] * s[c] + b[c];
    h[t * ldh + c] = from_f<T>(v);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_mlp_fwd_kernel(
    const LnMlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(a.C), hidden = static_cast<int>(a.hidden);
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsFwd;
  const int M = static_cast<int>(
      a.rows - row0 < kRowsFwd ? a.rows - row0 : kRowsFwd);
  const Layout L = smem_layout(C, hidden, sizeof(T), false);
  T* h = reinterpret_cast<T*>(smem + L.h);
  T* z = reinterpret_cast<T*>(smem + L.z);
  float* mean = reinterpret_cast<float*>(smem + L.mean);
  float* rstd = reinterpret_cast<float*>(smem + L.rstd);
  const int LDH = ld_t(C, sizeof(T)), LDZ = ld_t(hidden, sizeof(T));
  const T* x = static_cast<const T*>(a.x) + row0 * C;
  T* out = static_cast<T*>(a.out) + row0 * C;

  norm_rows(x, M, C, a.ns, a.nb, h, LDH, mean, rstd);
  block_gemm(h, LDH, M, C, static_cast<const T*>(a.w1), a.hidden, hidden,
             [](int n) { return n; },
             [&](int m, int n, float acc) {
               z[m * LDZ + n] = from_f<T>(gelu(acc + a.b1[n]));
             });
  __syncthreads();
  block_gemm(z, LDZ, M, hidden, static_cast<const T*>(a.w2), a.C, C,
             [](int n) { return n; },
             [&](int m, int n, float acc) {
               const long long e = static_cast<long long>(m) * C + n;
               out[e] = from_f<T>(to_f(x[e]) + (acc + a.b2[n]));
             });
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_mlp_bwd_kernel(
    const LnMlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(a.C), hidden = static_cast<int>(a.hidden);
  const int tile = blockIdx.x;
  const long long row0 = static_cast<long long>(tile) * kRowsBwd;
  const int M = static_cast<int>(
      a.rows - row0 < kRowsBwd ? a.rows - row0 : kRowsBwd);
  const Layout L = smem_layout(C, hidden, sizeof(T), true);
  T* h = reinterpret_cast<T*>(smem + L.h);
  float* af = reinterpret_cast<float*>(smem + L.z);  // a, then da
  T* gs = reinterpret_cast<T*>(smem + L.g);
  float* dh = reinterpret_cast<float*>(smem + L.dh);
  float* mean = reinterpret_cast<float*>(smem + L.mean);
  float* rstd = reinterpret_cast<float*>(smem + L.rstd);
  float* m1 = reinterpret_cast<float*>(smem + L.m1);
  float* m2 = reinterpret_cast<float*>(smem + L.m2);
  const int LDH = ld_t(C, sizeof(T)), LDA = ld_f32(hidden);
  const int LDD = ld_f32(C);
  const bool use_norm = a.ns != nullptr;
  const T* x = static_cast<const T*>(a.x) + row0 * C;
  const T* g = static_cast<const T*>(a.g) + row0 * C;
  T* dx = static_cast<T*>(a.dx) + row0 * C;
  T* da_t = static_cast<T*>(a.da_t) + row0 * hidden;
  T* z_t = static_cast<T*>(a.z_t) + row0 * hidden;
  float* part = a.part_vec + static_cast<long long>(tile) * (hidden + 3 * C);

  // 1. h (and its copy for dW1), g.
  norm_rows(x, M, C, a.ns, a.nb, h, LDH, mean, rstd);
  for (int e = threadIdx.x; e < M * C; e += blockDim.x) {
    const int t = e / C, c = e % C;
    gs[t * LDH + c] = g[e];
    if (use_norm) static_cast<T*>(a.h_t)[row0 * C + e] = h[t * LDH + c];
  }
  // 2. a = h W1 + b1, and round(z) = round(a Phi(a)) for dW2.
  block_gemm(h, LDH, M, C, static_cast<const T*>(a.w1), a.hidden, hidden,
             [](int n) { return n; },
             [&](int m, int n, float acc) {
               const float av = acc + a.b1[n];
               af[m * LDA + n] = av;
               z_t[static_cast<long long>(m) * hidden + n] = from_f<T>(
                   av * 0.5f * (1.f + erff(av * kInvSqrt2)));
             });
  __syncthreads();
  // 3. da = (g W2^T) * GELU'(a), in place of a.
  block_gemm(gs, LDH, M, C, static_cast<const T*>(a.w2t), a.hidden, hidden,
             [](int n) { return n; },
             [&](int m, int n, float acc) {
               const float av = af[m * LDA + n];
               const float dgelu = 0.5f * (1.f + erff(av * kInvSqrt2)) +
                                   av * kInvSqrt2Pi * expf(-0.5f * av * av);
               const float da = acc * dgelu;
               af[m * LDA + n] = da;
               da_t[static_cast<long long>(m) * hidden + n] = from_f<T>(da);
             });
  __syncthreads();
  // 4. db1's partial from the f32 da; then da rounded in place, by the
  //    thread that owns its column.
  for (int n = threadIdx.x; n < hidden; n += blockDim.x) {
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += af[m * LDA + n];
    part[n] = s;
    for (int m = 0; m < M; ++m) af[m * LDA + n] = round_t<T>(af[m * LDA + n]);
  }
  __syncthreads();
  // 5. dh = round(da) W1^T.
  block_gemm(af, LDA, M, hidden, static_cast<const T*>(a.w1t), a.C, C,
             [](int n) { return n; },
             [&](int m, int n, float acc) { dh[m * LDD + n] = acc; });
  __syncthreads();
  // 6. Column partials of db2 and the norm grads; per-row LN sums.
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sg = 0.f, sns = 0.f, snb = 0.f;
    for (int m = 0; m < M; ++m) {
      sg += to_f(gs[m * LDH + c]);
      if (use_norm) {
        const float xhat =
            (to_f(x[static_cast<long long>(m) * C + c]) - mean[m]) * rstd[m];
        sns += dh[m * LDD + c] * xhat;
        snb += dh[m * LDD + c];
      }
    }
    part[hidden + c] = sg;
    part[hidden + C + c] = sns;
    part[hidden + 2 * C + c] = snb;
  }
  if (use_norm) {
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      float s1 = 0.f, s2 = 0.f;
      for (int c = 0; c < C; ++c) {
        const float dhat = dh[m * LDD + c] * a.ns[c];
        const float xhat =
            (to_f(x[static_cast<long long>(m) * C + c]) - mean[m]) * rstd[m];
        s1 += dhat;
        s2 += dhat * xhat;
      }
      m1[m] = s1 / C;
      m2[m] = s2 / C;
    }
  }
  __syncthreads();
  // 7. dx = g + LN^T(dh) (or g + dh).
  for (int e = threadIdx.x; e < M * C; e += blockDim.x) {
    const int t = e / C, c = e % C;
    float d = dh[t * LDD + c];
    if (use_norm) {
      const float xhat = (to_f(x[e]) - mean[t]) * rstd[t];
      d = rstd[t] * (d * a.ns[c] - m1[t] - xhat * m2[t]);
    }
    dx[e] = from_f<T>(to_f(gs[t * LDH + c]) + d);
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, const LnMlpArgs& a, bool bwd, cudaStream_t s) {
  const Layout L = smem_layout(static_cast<int>(a.C),
                               static_cast<int>(a.hidden), sizeof(T), bwd);
  const int r = bwd ? kRowsBwd : kRowsFwd;
  const dim3 grid(static_cast<unsigned>((a.rows + r - 1) / r));
  return launch_kernel(kernel, grid, L.total, s, a);
}

// The tensor-core bodies' kernels: one 64-row tile a block. The forward
// in K1's two forms (two blocks of 8 warps an SM with a ring of 2 tiles,
// or one of 16 warps with 3), the backward one block of 16 warps an SM
// with a ring of S tiles (2 of 64 rows, or 4 of 32 where C % 64 != 0).
template <int S, int MINB, int NT>
__global__ void __launch_bounds__(NT, MINB)
ln_mlp_fwd_tc_kernel(const LnMlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  ln_mlp_fwd_tc<S, NT>(a, smem);
}

template <int S>
__global__ void __launch_bounds__(512, 1)
ln_mlp_bwd_tc_kernel(const LnMlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  ln_mlp_bwd_tc<S, 512>(a, smem);
}

// What a tensor-core launch checks of the plan it is given: bf16, C % 32
// == 0, hidden a multiple of 128, a form of ops/ln_mlp.py's MLP_FWD_FORMS
// or MLP_BWD_FORMS (blocks an SM, kp, stages; two blocks an SM only where
// C <= 128), 64-row tiles, 128-column panels, and shared memory equal to
// the body's layout and within a block's share of an SM. A mismatch is
// refused, never run.
inline bool mlp_plan_ok(const LnMlpArgs& a, bool bwd) {
  const mmst::TcPlan& p = a.plan;
  const bool form =
      bwd ? p.body == 1 && ((p.kp == 64 && p.stages == 2) ||
                            (p.kp == 32 && p.stages == 4))
          : (p.body == 2 && p.kp == 32 && p.stages == 2 &&
             a.C <= kTcPanel) ||
                (p.body == 1 && (p.kp == 64 || p.kp == 32) &&
                 p.stages == 3);
  return form && a.dtype == 1 && a.rows >= 1 && p.rows == kTcRows &&
         p.panel == kTcPanel && a.C >= 32 && a.C % 32 == 0 &&
         a.C % p.kp == 0 && a.hidden >= kTcPanel &&
         a.hidden % kTcPanel == 0 &&
         p.smem_bytes ==
             static_cast<long long>(
                 tc_mlp_layout(static_cast<int>(a.C),
                               static_cast<int>(p.kp),
                               static_cast<int>(p.stages), bwd)
                     .total) &&
         p.smem_bytes <= (p.body == 2 ? 115712 : 232448);
}

int launch_tc(const LnMlpArgs& a, bool bwd, cudaStream_t s) {
  if (!mlp_plan_ok(a, bwd)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((a.rows + kTcRows - 1) / kTcRows));
  const size_t bytes = static_cast<size_t>(a.plan.smem_bytes);
  if (bwd)
    return a.plan.stages == 2
               ? launch_kernel(ln_mlp_bwd_tc_kernel<2>, grid, bytes, s, a,
                               512)
               : launch_kernel(ln_mlp_bwd_tc_kernel<4>, grid, bytes, s, a,
                               512);
  return a.plan.body == 2
             ? launch_kernel(ln_mlp_fwd_tc_kernel<2, 2, 256>, grid, bytes, s,
                             a, 256)
             : launch_kernel(ln_mlp_fwd_tc_kernel<3, 1, 512>, grid, bytes, s,
                             a, 512);
}

// The forward: the plan's body.
int forward(const LnMlpArgs& a, cudaStream_t s) {
  if (a.plan.body == 1 || a.plan.body == 2) return launch_tc(a, false, s);
  if (a.plan.body != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a.dtype == 1)
    return launch<__nv_bfloat16>(ln_mlp_fwd_kernel<__nv_bfloat16>, a, false,
                                 s);
  return launch<float>(ln_mlp_fwd_kernel<float>, a, false, s);
}

// The backward: the plan's main body, then the two weight gradients and
// the reductions of the column partials (one row of part_vec per tile of
// the body).
template <typename T>
int backward(const LnMlpArgs& a, cudaStream_t s) {
  const bool tc = a.plan.body == 1;
  if (a.plan.body != 0 && !tc) return static_cast<int>(cudaErrorInvalidValue);
  int err = tc ? launch_tc(a, true, s)
               : launch<T>(ln_mlp_bwd_kernel<T>, a, true, s);
  if (err != 0) return err;
  const int C = static_cast<int>(a.C), hidden = static_cast<int>(a.hidden);
  const int splits = static_cast<int>(a.wsplit);
  const T* h = static_cast<const T*>(a.ns != nullptr ? a.h_t : a.x);
  err = wgrad(WgradJob<T>{h, static_cast<const T*>(a.da_t), nullptr, nullptr,
                          a.part_w, a.dw1, a.rows, C, hidden},
              splits, s);
  if (err != 0) return err;
  err = wgrad(WgradJob<T>{static_cast<const T*>(a.z_t),
                          static_cast<const T*>(a.g), nullptr, nullptr,
                          a.part_w, a.dw2, a.rows, hidden, C},
              splits, s);
  if (err != 0) return err;
  const int r = tc ? kTcRows : kRowsBwd;
  const long long tiles = (a.rows + r - 1) / r;
  const long long stride = hidden + 3LL * C;
  err = reduce_parts(a.part_vec, tiles, stride, hidden, a.db1, s);
  if (err != 0) return err;
  err = reduce_parts(a.part_vec + hidden, tiles, stride, C, a.db2, s);
  if (err != 0 || a.ns == nullptr) return err;
  err = reduce_parts(a.part_vec + hidden + C, tiles, stride, C, a.dns, s);
  if (err != 0) return err;
  return reduce_parts(a.part_vec + hidden + 2 * C, tiles, stride, C, a.dnb,
                      s);
}

}  // namespace

extern "C" {

// Shared memory in bytes of one block of the scalar forward (bwd 0) or
// backward (bwd 1) row kernel.
long long mmst_ln_mlp_smem_bytes(long long c, long long hidden,
                                 long long tsize, long long bwd) {
  return static_cast<long long>(
      smem_layout(static_cast<int>(c), static_cast<int>(hidden),
                  static_cast<int>(tsize), bwd != 0)
          .total);
}

// Rows per block of the scalar forward (bwd 0) or backward (bwd 1).
long long mmst_ln_mlp_rows_per_block(long long bwd) {
  return bwd != 0 ? kRowsBwd : kRowsFwd;
}

// Static shared memory, dynamic shared memory opted in so far on the
// current device, registers and local memory (spills) per thread of the
// kernel of the forward (bwd 0) or backward (bwd 1): body 0 the scalar
// kernel at dtype (0 f32, 1 bf16), body 1 or 2 the tensor-core kernel at
// that many blocks an SM with a ring of `stages`.
int mmst_ln_mlp_attributes(long long body, long long stages, long long dtype,
                           long long bwd, long long* smem, long long* dyn,
                           long long* regs, long long* local) {
  if (bwd != 0) {
    if (body == 1 && stages == 2)
      return local_attributes(ln_mlp_bwd_tc_kernel<2>, smem, dyn, regs,
                              local);
    if (body == 1 && stages == 4)
      return local_attributes(ln_mlp_bwd_tc_kernel<4>, smem, dyn, regs,
                              local);
    if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
    return dtype == 1 ? local_attributes(ln_mlp_bwd_kernel<__nv_bfloat16>,
                                         smem, dyn, regs, local)
                      : local_attributes(ln_mlp_bwd_kernel<float>, smem, dyn,
                                         regs, local);
  }
  if (body == 2)
    return local_attributes(ln_mlp_fwd_tc_kernel<2, 2, 256>, smem, dyn, regs,
                            local);
  if (body == 1)
    return local_attributes(ln_mlp_fwd_tc_kernel<3, 1, 512>, smem, dyn, regs,
                            local);
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 1 ? local_attributes(ln_mlp_fwd_kernel<__nv_bfloat16>,
                                       smem, dyn, regs, local)
                    : local_attributes(ln_mlp_fwd_kernel<float>, smem, dyn,
                                       regs, local);
}

int mmst_ln_mlp_residual(const mmst::LnMlpArgs* a, void* stream) {
  return forward(*a, static_cast<cudaStream_t>(stream));
}

int mmst_ln_mlp_residual_bwd(const mmst::LnMlpArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 1) return backward<__nv_bfloat16>(*a, s);
  return backward<float>(*a, s);
}

}  // extern "C"
