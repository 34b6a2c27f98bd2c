// Window attention with its projections, forward and backward, hand-written
// for Hopper: one body per direction, templated on the number of value
// streams NV.
//
// Replaces the TPU kernels of mastermetastyletransfer_tpu/ops/
//
//   pallas_attention.py      K8 `fused_window_attention` (`_kernel`)
//                            -> mmst_window_attention (NV = 1)
//                            K9 `fused_window_attention_dual`
//                            (`_kernel_dual`) -> mmst_window_attention_dual
//                            (NV = 2)
//   pallas_attention_vjp.py  their backward kernels `_bwd_kernel`
//                            (`_bwd`) and `_bwd_kernel_dual` (`_bwd_dual`)
//                            -> mmst_window_attention_bwd,
//                               mmst_window_attention_dual_bwd
//
// Over window tensors (B, nW, N, C). NV = 1: q, k, v are raw inputs,
// projected in the kernel (wq, wk, wv); NV = 2: q and k arrive projected
// and two value streams are projected (wv0, wv1). Per head: S = q_s k^T +
// bias + mask, P = softmax(S), o = P v per stream; out_s = o_s wp + bp.
// Rounding to T, as the JAX kernels: q * scale, k and v after their f32
// projection, the softmax numerators (forward) or P (backward) before the
// value product, the head outputs, g; in the backward dO = round(g wp^T),
// dS before its products, d{q,k,v} before the input-grad and weight-grad
// products (their bias grads sum the f32 values).
//
// Backward per head (pallas_attention_vjp.py:1-23): dP = sum_s dO_s v_s^T,
// dS = P (dP - rowsum(dP P)), dq = scale dS k, dk = scale dS^T q, dv_s =
// P^T dO_s; dX = round(d{q,k,v}) W^T (NV = 1: q, k and v; NV = 2: the
// value streams, dq and dk are the outputs themselves); dW = X^T
// round(d{q,k,v}), dWp = sum_s round(o_s)^T g_s, d bias = sum over windows
// of dS. It recomputes the forward from the raw window inputs (flash
// style: the inputs are the only residuals).
//
// What bounds it on an H100: per window 8 N C^2 (NV = 1) or 6 N C^2
// (NV = 2) operations of projections, and 4 N^2 C per stream of attention,
// against a few window tiles of bytes: some 400 operations per byte at
// C = 256 in bf16, so the tensor-core rate, not memory.
//
// At bf16 both directions run on the tensor cores where the plan the
// wrapper passes says so (ops/window_attention.py:attn_fwd_plan,
// attn_bwd_plan; every training shape: N <= 64, head dim 32, C a multiple
// of the 128-column head group): the forward attn_fwd_tc.cuh, the backward
// attn_tc.cuh, each one block per window, head group by head group,
// mma.sync products over a cp.async weight ring; each entry refuses a plan
// that does not match its layout. Every other call (f32 above all) runs
// the scalar bodies below, scalar FMAs on the CUDA cores, one head at a
// time in shared memory, far below that bound.
//
// Scalar design: one block of 256 threads per (window, image). The forward
// keeps a head's q, k, v (N x dh) and scores in shared memory and the
// heads' output tiles (N x C per stream); the projection GEMMs read the
// window's inputs from device memory (each row broadcast to a warp). The
// backward keeps a head's q_s, q, k, v_s, dO_s, P and dS (N x dh and N x
// N) and writes the rounded d{q,k,v} and head outputs of its window to
// device scratch; the input grads then read them back through W^T
// (transposed by the wrapper) after a barrier. Weight, bias and
// relative-bias grads sum over every window: each block (of either body)
// writes f32 partials of its own window, and grad_common.cuh sums them in
// a fixed order (deterministic, no atomics). Shared memory per block at
// N = 49, C = 256, 8 heads, f32 (bf16): forward 79,648 B (45,152) with one
// value stream, 130,032 B (70,448) with two; backward 58,320 B (42,640)
// and 71,280 B (49,328).
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC. Plain C interface; each entry returns the CUDA
// error code of its launches (0 on success).

#include "attn_fwd_tc.cuh"
#include "grad_common.cuh"

namespace mmst {

// Mirrors AttnArgs in ops/window_attention.py field for field (8 bytes
// each). Window tensors are T (B, nW, N, C); matrices T (C, C) (the "t"
// ones transposed); vectors f32 (C). Unused fields are null.
struct AttnArgs {
  const void* q;      // NV 1: raw q input; NV 2: projected q
  const void* k;      // NV 1: raw k input; NV 2: projected k
  const void* v0;     // raw value inputs
  const void* v1;
  void* out0;         // forward outputs
  void* out1;
  const void* g0;     // the outputs' gradients
  const void* g1;
  void* dq;           // input gradients
  void* dk;
  void* dv0;
  void* dv1;
  const void* wq;
  const float* bq;
  const void* wk;
  const float* bk;
  const void* wv0;
  const float* bv0;
  const void* wv1;
  const float* bv1;
  const void* wp;
  const float* bp;
  const void* wqt;
  const void* wkt;
  const void* wv0t;
  const void* wv1t;
  const void* wpt;
  const float* rel_bias;  // (heads, N, N)
  const float* mask;      // (nW, N, N) or null
  void* dq_t;         // scratch, window layout: round(dq), round(dk) (NV 1),
  void* dk_t;
  void* dv0_t;        // round(dv_s),
  void* dv1_t;
  void* o0_t;         // round(o_s)
  void* o1_t;
  float* part_vec;    // (B nW, nvec C): NV 1 bq | bk | bv0 | bp;
                      //                 NV 2 bv0 | bv1 | bp
  float* part_bias;   // (B nW, heads N N)
  float* part_w;      // (wsplit, C C)
  float* dwq;         // (C, C) weight grads
  float* dwk;
  float* dwv0;
  float* dwv1;
  float* dwp;
  float* dbq;         // (C) bias grads
  float* dbk;
  float* dbv0;
  float* dbv1;
  float* dbp;
  float* dbias;       // (heads, N, N)
  double scale;       // head_dim ** -0.5
  long long dtype;    // 0 float32, 1 bfloat16
  long long B, nW, N, C, heads, nv, wsplit;
  TcPlan plan;        // the call's body and its tiling (body 0: the
                      // scalar one; else the tensor-core body's form)
};

}  // namespace mmst

namespace {

using mmst::AttnArgs;

template <int NV>
struct Streams {
  const void* v[2];
  const float* bv[2];
  const void* wv[2];
  const void* wvt[2];
  const void* g[2];
  void* out[2];
  void* dv[2];
  void* dv_t[2];
  void* o_t[2];
  __device__ explicit Streams(const AttnArgs& a)
      : v{a.v0, a.v1}, bv{a.bv0, a.bv1}, wv{a.wv0, a.wv1},
        wvt{a.wv0t, a.wv1t}, g{a.g0, a.g1}, out{a.out0, a.out1},
        dv{a.dv0, a.dv1}, dv_t{a.dv0_t, a.dv1_t}, o_t{a.o0_t, a.o1_t} {}
};

// Forward: qh, kh, vh (N x dh, T), NV head-output tiles (N x C, T),
// scores and row sums. Backward: qs, qc, kc, NV vc and NV dO (N x dh, T),
// P and dS (N x N f32), an f32 (N x dh) accumulator, row sums.
struct Layout {
  size_t head[7], ob[2], p, ds, acc, rs, total;
};

__host__ __device__ inline Layout smem_layout(int n, int c, int dh,
                                              int tsize, int nv, bool bwd) {
  const size_t head_t = static_cast<size_t>(tsize) * n * ld_t(dh, tsize);
  const size_t tile_t = static_cast<size_t>(tsize) * n * ld_t(c, tsize);
  Layout l = {};
  size_t o = 0;
  const int nhead = bwd ? 3 + 2 * nv : 3;
  for (int i = 0; i < nhead; ++i) {
    l.head[i] = o;
    o = align16(o + head_t);
  }
  if (!bwd) {
    for (int s = 0; s < nv; ++s) {
      l.ob[s] = o;
      o = align16(o + tile_t);
    }
  }
  l.p = o;  o = align16(o + sizeof(float) * n * n);
  l.ds = o;
  if (bwd) o = align16(o + sizeof(float) * n * n);
  l.acc = o;
  if (bwd) o = align16(o + sizeof(float) * n * ld_f32(dh));
  l.rs = o; o = align16(o + sizeof(float) * n);
  l.total = o;
  return l;
}

// dst (N x dh, T) = round((x W[:, h dh:(h+1) dh] + b) * mul), x the
// window's (N, C) rows in device memory; `unscaled`, when not null, gets
// round(x W + b) too. No barrier.
template <typename T>
__device__ __forceinline__ void project_head(const T* x, int N, int C,
                                             const T* w, const float* b,
                                             int h, int dh, float mul, T* dst,
                                             T* unscaled, int ldh) {
  block_gemm(x, C, N, C, w, C, dh, [=](int n) { return h * dh + n; },
             [&](int m, int n, float acc) {
               const float v = acc + b[h * dh + n];
               dst[m * ldh + n] = from_f<T>(v * mul);
               if (unscaled != nullptr) unscaled[m * ldh + n] = from_f<T>(v);
             });
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(
    const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(a.C), N = static_cast<int>(a.N);
  const int heads = static_cast<int>(a.heads), dh = C / heads;
  const int w = blockIdx.x, b = blockIdx.y;
  const float scale = static_cast<float>(a.scale);
  const Streams<NV> st(a);
  const Layout L = smem_layout(N, C, dh, sizeof(T), NV, false);
  T* qh = reinterpret_cast<T*>(smem + L.head[0]);
  T* kh = reinterpret_cast<T*>(smem + L.head[1]);
  T* vh = reinterpret_cast<T*>(smem + L.head[2]);
  float* sc = reinterpret_cast<float*>(smem + L.p);
  float* rs = reinterpret_cast<float*>(smem + L.rs);
  const int LDH = ld_t(dh, sizeof(T)), LDT = ld_t(C, sizeof(T));
  const long long base = (static_cast<long long>(b) * a.nW + w) * N * C;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const float* mask_w =
      a.mask != nullptr ? a.mask + static_cast<long long>(w) * N * N
                        : nullptr;

  for (int h = 0; h < heads; ++h) {
    if (NV == 1) {
      project_head(q, N, C, static_cast<const T*>(a.wq), a.bq, h, dh, scale,
                   qh, static_cast<T*>(nullptr), LDH);
      project_head(k, N, C, static_cast<const T*>(a.wk), a.bk, h, dh, 1.f,
                   kh, static_cast<T*>(nullptr), LDH);
    } else {
      for (int e = threadIdx.x; e < N * dh; e += blockDim.x) {
        const int t = e / dh, d = e % dh;
        const long long off = static_cast<long long>(t) * C + h * dh + d;
        qh[t * LDH + d] = from_f<T>(to_f(q[off]) * scale);
        kh[t * LDH + d] = k[off];
      }
    }
    for (int s = 0; s < NV; ++s) {
      project_head(static_cast<const T*>(st.v[s]) + base, N, C,
                   static_cast<const T*>(st.wv[s]), st.bv[s], h, dh, 1.f, vh,
                   static_cast<T*>(nullptr), LDH);
      __syncthreads();
      attend_head(qh, kh, vh, LDH, N, dh,
                  a.rel_bias + static_cast<long long>(h) * N * N, mask_w, sc,
                  rs, reinterpret_cast<T*>(smem + L.ob[s]), LDT, h * dh);
    }
  }
  for (int s = 0; s < NV; ++s) {
    T* out = static_cast<T*>(st.out[s]) + base;
    block_gemm(reinterpret_cast<const T*>(smem + L.ob[s]), LDT, N, C,
               static_cast<const T*>(a.wp), a.C, C, [](int n) { return n; },
               [&](int m, int n, float acc) {
                 out[static_cast<long long>(m) * C + n] =
                     from_f<T>(acc + a.bp[n]);
               });
  }
}

// Column sums of the f32 (N x dh) tile acc into columns h dh.. of one
// partial vector. Ends with a barrier.
__device__ __forceinline__ void column_sums(const float* acc, int lda, int N,
                                            int dh, float* part, int col0) {
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < N; ++t) s += acc[t * lda + d];
    part[col0 + d] = s;
  }
  __syncthreads();
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) attn_bwd_kernel(
    const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(a.C), N = static_cast<int>(a.N);
  const int heads = static_cast<int>(a.heads), dh = C / heads;
  const int w = blockIdx.x, b = blockIdx.y;
  const long long blk = static_cast<long long>(b) * a.nW + w;
  const float scale = static_cast<float>(a.scale);
  const Streams<NV> st(a);
  const Layout L = smem_layout(N, C, dh, sizeof(T), NV, true);
  T* qs = reinterpret_cast<T*>(smem + L.head[0]);
  T* qc = reinterpret_cast<T*>(smem + L.head[1]);
  T* kc = reinterpret_cast<T*>(smem + L.head[2]);
  T* vc[2] = {reinterpret_cast<T*>(smem + L.head[3]),
              reinterpret_cast<T*>(smem + L.head[3 + (NV - 1)])};
  T* dO[2] = {reinterpret_cast<T*>(smem + L.head[3 + NV]),
              reinterpret_cast<T*>(smem + L.head[3 + NV + (NV - 1)])};
  float* P = reinterpret_cast<float*>(smem + L.p);
  float* dS = reinterpret_cast<float*>(smem + L.ds);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* rs = reinterpret_cast<float*>(smem + L.rs);
  const int LDH = ld_t(dh, sizeof(T)), LDA = ld_f32(dh);
  const long long base = blk * N * C;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const float* mask_w =
      a.mask != nullptr ? a.mask + static_cast<long long>(w) * N * N
                        : nullptr;
  const int nvec = NV == 1 ? 4 : 3;
  float* pvec = a.part_vec + blk * nvec * C;
  const int slot_v = NV == 1 ? 2 : 0, slot_p = NV == 1 ? 3 : 2;
  float* pbias = a.part_bias + blk * heads * N * N;

  // dbp's partial: the column sums of sum_s g_s.
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < N; ++t) {
      float gv = 0.f;
      for (int v = 0; v < NV; ++v)
        gv += to_f(static_cast<const T*>(st.g[v])[base + t * C + c]);
      s += gv;
    }
    pvec[slot_p * C + c] = s;
  }

  for (int h = 0; h < heads; ++h) {
    // 1. The head's q * scale, q, k, v_s, and dO_s = round(g_s wp^T).
    if (NV == 1) {
      project_head(q, N, C, static_cast<const T*>(a.wq), a.bq, h, dh, scale,
                   qs, qc, LDH);
      project_head(k, N, C, static_cast<const T*>(a.wk), a.bk, h, dh, 1.f,
                   kc, static_cast<T*>(nullptr), LDH);
    } else {
      for (int e = threadIdx.x; e < N * dh; e += blockDim.x) {
        const int t = e / dh, d = e % dh;
        const long long off = static_cast<long long>(t) * C + h * dh + d;
        qs[t * LDH + d] = from_f<T>(to_f(q[off]) * scale);
        qc[t * LDH + d] = q[off];
        kc[t * LDH + d] = k[off];
      }
    }
    for (int s = 0; s < NV; ++s) {
      project_head(static_cast<const T*>(st.v[s]) + base, N, C,
                   static_cast<const T*>(st.wv[s]), st.bv[s], h, dh, 1.f,
                   vc[s], static_cast<T*>(nullptr), LDH);
      T* dos = dO[s];
      block_gemm(static_cast<const T*>(st.g[s]) + base, C, N, C,
                 static_cast<const T*>(a.wpt), a.C, dh,
                 [=](int n) { return h * dh + n; },
                 [&](int m, int n, float v) {
                   dos[m * LDH + n] = from_f<T>(v);
                 });
    }
    __syncthreads();
    // 2. P = softmax(q_s k^T + bias + mask), normalized, f32.
    const float* bias_h = a.rel_bias + static_cast<long long>(h) * N * N;
    for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
      const int i = e / N, j = e % N;
      float sv = 0.f;
      for (int d = 0; d < dh; ++d)
        sv += to_f(qs[i * LDH + d]) * to_f(kc[j * LDH + d]);
      const float comb = (mask_w != nullptr ? mask_w[e] : 0.f) + bias_h[e];
      P[e] = sv + comb;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float mx = P[i * N];
      for (int j = 1; j < N; ++j) mx = fmaxf(mx, P[i * N + j]);
      float sum = 0.f;
      for (int j = 0; j < N; ++j) {
        const float e = expf(P[i * N + j] - mx);
        P[i * N + j] = e;
        sum += e;
      }
      for (int j = 0; j < N; ++j) P[i * N + j] = P[i * N + j] / sum;
    }
    __syncthreads();
    // 3. round(o_s) = round(round(P) v_s) into the scratch for dWp; dP.
    for (int s = 0; s < NV; ++s) {
      T* o_t = static_cast<T*>(st.o_t[s]) + base;
      for (int e = threadIdx.x; e < N * dh; e += blockDim.x) {
        const int i = e / dh, d = e % dh;
        float o = 0.f;
        for (int j = 0; j < N; ++j)
          o += round_t<T>(P[i * N + j]) * to_f(vc[s][j * LDH + d]);
        o_t[static_cast<long long>(i) * C + h * dh + d] = from_f<T>(o);
      }
    }
    for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
      const int i = e / N, j = e % N;
      float dp = 0.f;
      for (int s = 0; s < NV; ++s) {
        float part = 0.f;
        for (int d = 0; d < dh; ++d)
          part += to_f(dO[s][i * LDH + d]) * to_f(vc[s][j * LDH + d]);
        dp += part;
      }
      dS[e] = dp;
    }
    __syncthreads();
    // 4. dS = P (dP - rowsum(dP P)); its partial for d bias.
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float r = 0.f;
      for (int j = 0; j < N; ++j) r += dS[i * N + j] * P[i * N + j];
      rs[i] = r;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
      const float v = P[e] * (dS[e] - rs[e / N]);
      dS[e] = v;
      pbias[static_cast<long long>(h) * N * N + e] = v;
    }
    __syncthreads();
    // 5. dq = scale round(dS) k, dk = scale round(dS)^T q, dv_s =
    //    round(P)^T dO_s; each to its scratch (NV 1) or output (NV 2, dq
    //    and dk), with its f32 column sums for the bias grads.
    for (int which = 0; which < 2 + NV; ++which) {
      for (int e = threadIdx.x; e < N * dh; e += blockDim.x) {
        const int i = e / dh, d = e % dh;
        float v = 0.f;
        if (which == 0) {
          for (int j = 0; j < N; ++j)
            v += round_t<T>(dS[i * N + j]) * to_f(kc[j * LDH + d]);
          v *= scale;
        } else if (which == 1) {
          for (int j = 0; j < N; ++j)
            v += round_t<T>(dS[j * N + i]) * to_f(qc[j * LDH + d]);
          v *= scale;
        } else {
          const T* dos = dO[which - 2];
          for (int j = 0; j < N; ++j)
            v += round_t<T>(P[j * N + i]) * to_f(dos[j * LDH + d]);
        }
        acc[i * LDA + d] = v;
        void* dst = which == 0   ? (NV == 1 ? a.dq_t : a.dq)
                    : which == 1 ? (NV == 1 ? a.dk_t : a.dk)
                                 : st.dv_t[which - 2];
        static_cast<T*>(dst)[base + static_cast<long long>(i) * C + h * dh +
                             d] = from_f<T>(v);
      }
      if (which >= 2) {
        column_sums(acc, LDA, N, dh, pvec + (slot_v + which - 2) * C, h * dh);
      } else if (NV == 1) {
        column_sums(acc, LDA, N, dh, pvec + which * C, h * dh);
      } else {
        __syncthreads();
      }
    }
  }
  __syncthreads();

  // 6. dX = round(d{q,k,v}) W^T, from the scratch this block wrote.
  const int nx = NV == 1 ? 3 : 2;
  for (int i = 0; i < nx; ++i) {
    const void* src;
    const void* wt;
    void* dst;
    if (NV == 1 && i == 0) {
      src = a.dq_t; wt = a.wqt; dst = a.dq;
    } else if (NV == 1 && i == 1) {
      src = a.dk_t; wt = a.wkt; dst = a.dk;
    } else {
      const int s = NV == 1 ? 0 : i;
      src = st.dv_t[s]; wt = st.wvt[s]; dst = st.dv[s];
    }
    T* out = static_cast<T*>(dst) + base;
    block_gemm(static_cast<const T*>(src) + base, C, N, C,
               static_cast<const T*>(wt), a.C, C, [](int n) { return n; },
               [&](int m, int n, float v) {
                 out[static_cast<long long>(m) * C + n] = from_f<T>(v);
               });
  }
}

// The tensor-core forward's kernel for NV value streams, in the form of NT
// threads: a block of 16 warps an SM, or two of 8; a ring of 2 tiles.
template <int NV, int NT>
__global__ void __launch_bounds__(NT, 512 / NT) attn_fwd_tc_kernel(
    const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn_fwd_tc<NV, NT, 2>(a, smem);
}

// What a forward tensor-core launch checks of the plan it is given: bf16,
// a form of ops/window_attention.py's ATTN_FWD_FORMS (two blocks of 8 warps
// an SM with 2 tiles of 32 rows; one of 16 warps with 2 tiles of 64 rows),
// 128-column head groups, N <= 64 tokens in 64 rows, head dim 32, C a
// multiple of the group, and shared memory equal to the body's layout and
// within a block's share of an SM. A mismatch is refused, never run.
inline bool attn_fwd_plan_ok(const AttnArgs& a) {
  const mmst::TcPlan& p = a.plan;
  const bool two = p.body == 2;
  return (p.body == 1 || two) && a.dtype == 1 && p.rows == kTcRows &&
         p.panel == kAtGroup && p.kp == (two ? 32 : 64) && p.stages == 2 &&
         a.N >= 1 && a.N <= kTcRows && a.heads * kAtDh == a.C &&
         a.C % kAtGroup == 0 &&
         p.smem_bytes ==
             static_cast<long long>(
                 attn_fwd_tc_layout(static_cast<int>(a.C),
                                    static_cast<int>(a.nv),
                                    static_cast<int>(p.kp),
                                    static_cast<int>(p.stages))
                     .total) &&
         p.smem_bytes <= (two ? 115712 : 232448);
}

using AttnKernel = void (*)(const AttnArgs);

// The forward's kernel of a form: `body` blocks an SM.
template <int NV>
AttnKernel fwd_tc_kernel(long long body) {
  return body == 2 ? attn_fwd_tc_kernel<NV, 256> : attn_fwd_tc_kernel<NV, 512>;
}

template <typename T, int NV>
int forward(const AttnArgs& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(a.nW), static_cast<unsigned>(a.B));
  if (a.plan.body != 0) {
    if (!std::is_same<T, __nv_bfloat16>::value || a.nv != NV ||
        !attn_fwd_plan_ok(a))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_kernel(fwd_tc_kernel<NV>(a.plan.body), grid,
                         static_cast<size_t>(a.plan.smem_bytes), s, a,
                         a.plan.body == 2 ? 256 : 512);
  }
  const Layout L = smem_layout(static_cast<int>(a.N), static_cast<int>(a.C),
                               static_cast<int>(a.C / a.heads), sizeof(T), NV,
                               false);
  return launch_kernel(attn_fwd_kernel<T, NV>, grid, L.total, s, a);
}

// The tensor-core backward's kernel for NV value streams: one block of 16
// warps an SM.
template <int NV>
__global__ void __launch_bounds__(kAtThreads, 1) attn_bwd_tc_kernel(
    const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn_bwd_tc<NV>(a, smem);
}

// What a tensor-core launch checks of the plan it is given: bf16, the form
// of ops/window_attention.py's ATTN_BWD_FORM (one block an SM, 128-column
// head groups, kp 64, a ring of 2), N <= 64 tokens in 64 rows, head dim
// 32, C a multiple of the group, and shared memory equal to the body's
// layout and within a block's share of an SM. A mismatch is refused,
// never run.
inline bool attn_plan_ok(const AttnArgs& a) {
  const mmst::TcPlan& p = a.plan;
  return p.body == 1 && p.panel == kAtGroup && p.kp == kAtKp &&
         a.dtype == 1 && p.rows == kTcRows && p.stages == 2 && a.N >= 1 &&
         a.N <= kTcRows && a.heads * kAtDh == a.C && a.C % kAtGroup == 0 &&
         p.smem_bytes ==
             static_cast<long long>(
                 attn_tc_layout(static_cast<int>(a.C), kAtGroup, kAtKp, 2,
                                static_cast<int>(a.nv))
                     .total) &&
         p.smem_bytes <= 232448;
}

template <int NV>
int launch_tc(const AttnArgs& a, cudaStream_t s) {
  if (a.nv != NV || !attn_plan_ok(a))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(a.nW), static_cast<unsigned>(a.B));
  return launch_kernel(attn_bwd_tc_kernel<NV>, grid,
                       static_cast<size_t>(a.plan.smem_bytes), s, a,
                       kAtThreads);
}

// The backward: the plan's body, then the weight gradients and the
// reductions of the per-window partials.
template <typename T, int NV>
int backward(const AttnArgs& a, cudaStream_t s) {
  const int C = static_cast<int>(a.C), N = static_cast<int>(a.N);
  int err;
  if (a.plan.body != 0) {
    if (!std::is_same<T, __nv_bfloat16>::value)
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_tc<NV>(a, s);
  } else {
    const Layout L = smem_layout(N, C, static_cast<int>(a.C / a.heads),
                                 sizeof(T), NV, true);
    const dim3 grid(static_cast<unsigned>(a.nW), static_cast<unsigned>(a.B));
    err = launch_kernel(attn_bwd_kernel<T, NV>, grid, L.total, s, a);
  }
  if (err != 0) return err;
  const long long rows = a.B * a.nW * a.N;
  const int splits = static_cast<int>(a.wsplit);
  auto job = [&](const void* x, const void* d, const void* x1,
                 const void* d1, float* out) {
    return WgradJob<T>{static_cast<const T*>(x), static_cast<const T*>(d),
                       static_cast<const T*>(x1), static_cast<const T*>(d1),
                       a.part_w, out, rows, C, C};
  };
  if (NV == 1) {
    if ((err = wgrad(job(a.q, a.dq_t, nullptr, nullptr, a.dwq), splits, s)))
      return err;
    if ((err = wgrad(job(a.k, a.dk_t, nullptr, nullptr, a.dwk), splits, s)))
      return err;
    if ((err = wgrad(job(a.v0, a.dv0_t, nullptr, nullptr, a.dwv0), splits,
                     s)))
      return err;
    if ((err = wgrad(job(a.o0_t, a.g0, nullptr, nullptr, a.dwp), splits, s)))
      return err;
  } else {
    if ((err = wgrad(job(a.v0, a.dv0_t, nullptr, nullptr, a.dwv0), splits,
                     s)))
      return err;
    if ((err = wgrad(job(a.v1, a.dv1_t, nullptr, nullptr, a.dwv1), splits,
                     s)))
      return err;
    if ((err = wgrad(job(a.o0_t, a.g0, a.o1_t, a.g1, a.dwp), splits, s)))
      return err;
  }
  const long long blocks = a.B * a.nW;
  const int nvec = NV == 1 ? 4 : 3;
  float* vec_out[4] = {NV == 1 ? a.dbq : a.dbv0, NV == 1 ? a.dbk : a.dbv1,
                       NV == 1 ? a.dbv0 : a.dbp, a.dbp};
  for (int i = 0; i < nvec; ++i)
    if ((err = reduce_parts(a.part_vec + i * C, blocks, nvec * C, C,
                            vec_out[i], s)))
      return err;
  const long long nb = a.heads * N * N;
  return reduce_parts(a.part_bias, blocks, nb, nb, a.dbias, s);
}

template <typename T, int NV>
int scalar_attributes(bool bwd, long long* smem, long long* dyn,
                      long long* regs, long long* local) {
  return bwd ? local_attributes(attn_bwd_kernel<T, NV>, smem, dyn, regs, local)
             : local_attributes(attn_fwd_kernel<T, NV>, smem, dyn, regs,
                                local);
}

}  // namespace

extern "C" {

// Static shared memory, dynamic shared memory opted in so far on the
// current device, registers and local memory (spills) per thread of the
// kernel of the forward (bwd 0) or backward (bwd 1) with nv value streams:
// body 0 the scalar kernel at dtype (0 f32, 1 bf16); else the direction's
// tensor-core kernel of the form of `body` blocks an SM (the forward's 1
// or 2, the backward's 1).
int mmst_window_attention_attributes(long long body, long long nv,
                                     long long dtype, long long bwd,
                                     long long* smem, long long* dyn,
                                     long long* regs, long long* local) {
  if (body != 0) {
    if (body != 1 && (bwd != 0 || body != 2))
      return static_cast<int>(cudaErrorInvalidValue);
    const AttnKernel k =
        bwd != 0 ? (nv == 1 ? attn_bwd_tc_kernel<1> : attn_bwd_tc_kernel<2>)
                 : (nv == 1 ? fwd_tc_kernel<1>(body) : fwd_tc_kernel<2>(body));
    return local_attributes(k, smem, dyn, regs, local);
  }
  if (dtype == 1)
    return nv == 1 ? scalar_attributes<__nv_bfloat16, 1>(bwd, smem, dyn,
                                                         regs, local)
                   : scalar_attributes<__nv_bfloat16, 2>(bwd, smem, dyn,
                                                         regs, local);
  return nv == 1 ? scalar_attributes<float, 1>(bwd, smem, dyn, regs, local)
                 : scalar_attributes<float, 2>(bwd, smem, dyn, regs, local);
}

// Shared memory in bytes of one block of the forward (bwd 0) or backward
// (bwd 1) kernel with nv value streams.
long long mmst_window_attention_smem_bytes(long long n, long long c,
                                           long long heads, long long tsize,
                                           long long nv, long long bwd) {
  return static_cast<long long>(
      smem_layout(static_cast<int>(n), static_cast<int>(c),
                  static_cast<int>(c / heads), static_cast<int>(tsize),
                  static_cast<int>(nv), bwd != 0)
          .total);
}

int mmst_window_attention(const mmst::AttnArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 1) return forward<__nv_bfloat16, 1>(*a, s);
  return forward<float, 1>(*a, s);
}

int mmst_window_attention_dual(const mmst::AttnArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 1) return forward<__nv_bfloat16, 2>(*a, s);
  return forward<float, 2>(*a, s);
}

int mmst_window_attention_bwd(const mmst::AttnArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 1) return backward<__nv_bfloat16, 1>(*a, s);
  return backward<float, 1>(*a, s);
}

int mmst_window_attention_dual_bwd(const mmst::AttnArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 1) return backward<__nv_bfloat16, 2>(*a, s);
  return backward<float, 2>(*a, s);
}

}  // extern "C"
