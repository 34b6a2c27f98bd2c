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
// Per window (`block_window` in window_common.cuh, the body K11 in
// block_pair.cu runs too at f32): LN1 (pad tokens' normed view zeroed by the
// validity mask) ->
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
// its memory. Both bodies keep every intermediate of a window in shared
// memory, so device memory sees each token once in and once out plus the
// weights through L2 -- the byte side is at its minimum.
//
// Two bodies. At bf16, both entries (K1 as the Swin runs it, K2 as the
// style transformer does: its Key block without norms, its self block with
// both) run the tensor-core body of window_tc.cuh where
// ops/window_block.py:block_plan says so (C % 32 == 0, head dim 16, 32 or
// 64, N <= 64, hidden % 128 == 0: the Swin stages of swin_T/S/B and the
// style transformer at C = 256): mma.sync products, weights streamed
// through a cp.async ring, the softmax in registers; K11 (block_pair.cu)
// runs the same body per ticket. Every other call -- f32 above all -- runs
// the scalar body described next, which K11 at f32 shares.
//
// Scalar body: one thread block of 256 threads per (image, window). Shared memory
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
#include "window_tc.cuh"

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
  TcPlan plan;            // the body and its tiling (window_tc.cuh)
};

}  // namespace mmst

namespace {

using mmst::Args;

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

// One thread block per (window, image): the token offsets, then the body.
// The launch bounds name one resident block per SM as the least: with the
// thread count alone ptxas holds the body to 64 registers (room for a fifth
// block that shared memory never allows), and at 101-111 it runs 1.2-1.5x
// faster at the Swin's shapes.
template <typename T, bool kRows>
__global__ void __launch_bounds__(kThreads, 1)
window_block_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = static_cast<int>(a.wh * a.ww);
  const int C = static_cast<int>(a.C), heads = static_cast<int>(a.heads);
  const int w = blockIdx.x, b = blockIdx.y;
  const BlockLayout L = block_smem_layout(N, C, C / heads, sizeof(T));
  long long* toff = reinterpret_cast<long long*>(smem + L.toff);
  for (int t = threadIdx.x; t < N; t += blockDim.x)
    toff[t] = token_offset<kRows>(a, b, w, t);
  __syncthreads();
  block_window<T, false>(
      a, C, heads, static_cast<int>(a.hidden), static_cast<float>(a.scale),
      static_cast<const T*>(a.x), static_cast<T*>(a.out), N,
      a.mask != nullptr ? a.mask + static_cast<long long>(w) * N * N
                        : nullptr,
      a.padmask != nullptr ? a.padmask + static_cast<long long>(w) * N
                           : nullptr,
      smem);
}

// Both entries at bf16 on the tensor-core body: one block of NT threads
// per (window, image); MINB blocks an SM, a ring of S tiles, the head
// outputs in the normed tile's place at two blocks an SM. The token offsets
// are the rows entry's arithmetic: the windows entry passes its (B, nW, N,
// C) tensor as an (nW, N) image of 1 x N windows, unshifted, whose token t
// of window w lies at ((b nW + w) N + t) C.
template <int DH, int S, int MINB, int NT>
__global__ void __launch_bounds__(NT, MINB)
window_block_tc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = static_cast<int>(a.wh * a.ww), C = static_cast<int>(a.C);
  const int kp = static_cast<int>(a.plan.kp);
  const int w = blockIdx.x, b = blockIdx.y;
  const TcBlockLayout L = tc_block_layout(N, C, kp, S, MINB == 2);
  long long* toff = reinterpret_cast<long long*>(smem + L.toff);
  for (int t = threadIdx.x; t < N; t += blockDim.x)
    toff[t] = token_offset<true>(a, b, w, t);
  __syncthreads();
  block_window_tc<DH, S, NT>(
      a, C, static_cast<int>(a.hidden), static_cast<float>(a.scale),
      static_cast<const __nv_bfloat16*>(a.x),
      static_cast<__nv_bfloat16*>(a.out), N,
      a.mask != nullptr ? a.mask + static_cast<long long>(w) * N * N
                        : nullptr,
      a.padmask != nullptr ? a.padmask + static_cast<long long>(w) * N
                           : nullptr,
      kp, MINB == 2, smem);
}

// The two forms of the tensor-core kernel at head dim DH: one block of 16
// warps an SM with 3 stages, and two of 8 warps with 2.
template <int DH>
int launch_tc_dh(const Args& a, dim3 grid, size_t bytes,
                 cudaStream_t stream) {
  if (a.plan.body == 2)
    return launch_kernel(window_block_tc_kernel<DH, 2, 2, 256>, grid, bytes,
                         stream, a, 256);
  return launch_kernel(window_block_tc_kernel<DH, 3, 1, 512>, grid, bytes,
                       stream, a, 512);
}

// The tensor-core body's launch, either entry: the plan must be one
// block_plan gives for this call (checked here), its shared memory what the
// layout needs; the windows entry's geometry the (nW, N) image of 1 x N
// windows.
int launch_tc(const Args& a, cudaStream_t stream) {
  const mmst::TcPlan& p = a.plan;
  const long long n = a.wh * a.ww, c = a.C, dh = a.heads ? c / a.heads : 0;
  const bool ok =
      tc_plan_ok(p, a.dtype, n, c, a.heads, a.hidden,
                 tc_block_layout(static_cast<int>(n), static_cast<int>(c),
                                 static_cast<int>(p.kp),
                                 static_cast<int>(p.stages), p.body == 2)
                     .total) &&
      a.Hp == (a.Hp / a.wh) * a.wh && a.Wp == (a.Wp / a.ww) * a.ww &&
      a.nW == (a.Hp / a.wh) * (a.Wp / a.ww);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(a.nW), static_cast<unsigned>(a.B));
  const size_t bytes = static_cast<size_t>(p.smem_bytes);
  if (dh == 16) return launch_tc_dh<16>(a, grid, bytes, stream);
  if (dh == 32) return launch_tc_dh<32>(a, grid, bytes, stream);
  return launch_tc_dh<64>(a, grid, bytes, stream);
}

template <typename T, bool kRows>
int launch(const Args& a, cudaStream_t stream) {
  const int n = static_cast<int>(a.wh * a.ww);
  const int c = static_cast<int>(a.C);
  const BlockLayout L =
      block_smem_layout(n, c, c / static_cast<int>(a.heads), sizeof(T));
  const dim3 grid(static_cast<unsigned>(a.nW), static_cast<unsigned>(a.B));
  return launch_kernel(window_block_kernel<T, kRows>, grid, L.total, stream,
                       a);
}

template <bool kRows>
int dispatch(const Args* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->plan.body == 1 || a->plan.body == 2) return launch_tc(*a, s);
  if (a->plan.body != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a->dtype == 1) return launch<__nv_bfloat16, kRows>(*a, s);
  return launch<float, kRows>(*a, s);
}

template <int DH>
int tc_attributes(long long body, long long* smem, long long* dyn,
                  long long* regs) {
  return body == 2 ? attributes_of(window_block_tc_kernel<DH, 2, 2, 256>,
                                   smem, dyn, regs)
                   : attributes_of(window_block_tc_kernel<DH, 3, 1, 512>,
                                   smem, dyn, regs);
}

}  // namespace

extern "C" {

// Shared memory in bytes that one block of the kernel takes.
long long mmst_window_block_smem_bytes(long long n, long long c,
                                       long long heads, long long tsize) {
  return static_cast<long long>(
      block_smem_layout(static_cast<int>(n), static_cast<int>(c),
                        static_cast<int>(c / heads), static_cast<int>(tsize))
          .total);
}

// Static shared memory, dynamic shared memory opted in so far on the
// current device and registers per thread of a kernel: body 0 the scalar
// kernel of the entry (rows 1: the rows entry, 0: the windows entry) at
// dtype (0 f32, 1 bf16), body 1 or 2 the tensor-core kernel (both entries)
// of head dim dh at that many blocks an SM.
int mmst_window_block_attributes(long long body, long long dtype,
                                 long long dh, long long rows,
                                 long long* smem, long long* dyn,
                                 long long* regs) {
  if (body == 1 || body == 2) {
    if (dh == 16) return tc_attributes<16>(body, smem, dyn, regs);
    if (dh == 32) return tc_attributes<32>(body, smem, dyn, regs);
    if (dh == 64) return tc_attributes<64>(body, smem, dyn, regs);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return rows ? attributes_of(window_block_kernel<__nv_bfloat16, true>,
                                smem, dyn, regs)
                : attributes_of(window_block_kernel<__nv_bfloat16, false>,
                                smem, dyn, regs);
  return rows ? attributes_of(window_block_kernel<float, true>, smem, dyn,
                              regs)
              : attributes_of(window_block_kernel<float, false>, smem, dyn,
                              regs);
}

int mmst_window_block_rows(const mmst::Args* a, void* stream) {
  return dispatch<true>(a, stream);
}

int mmst_window_block_windows(const mmst::Args* a, void* stream) {
  return dispatch<false>(a, stream);
}

}  // extern "C"
