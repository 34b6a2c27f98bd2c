// A Swin stage's two blocks, W-MSA then SW-MSA, in one launch, hand-written
// for Hopper.
//
// Replaces the TPU kernel K11 `fused_window_block_pair_rows` (body
// `_kernel_block_pair_rows`) of
// mastermetastyletransfer_tpu/ops/pallas_attention.py:
//
//   mmst_window_block_pair_rows  x is the window-padded NHWC image
//                                (B, Hp, Wp, C); the result is
//                                block1(block0(x)), block 0 unshifted and
//                                block 1 shifted by (sh, sw), in the plain
//                                (un-rolled) frame, as K1's row entry gives.
//
// Each window of each block runs one of K1's two per-window bodies with
// that block's weights and validity mask (and block 1's shift mask); block
// 0's output rounds to T, as the JAX kernel's scratch holds it. So the
// function is K1's row entry applied twice. At bf16, where
// ops/block_pair.py:pair_plan (K1's block_plan for the rows entry) says so
// -- the Swin stages of swin_T/S/B --, the tensor-core body
// block_window_tc (window_tc.cuh) in the form K1 takes at that width: two
// blocks of 8 warps an SM at C <= 128 (113,936 B at C = 128), one of 16
// warps above (224,016 B at C = 256); the C entry checks the plan against
// the layout. At f32, and for any other shape, the scalar body block_window
// (window_common.cuh).
//
// What bounds it on an H100: the per-window work of K1 twice, some 400k
// operations per token and block against the tokens read and written once,
// so the tensor-core rate.
//
// Design. On the TPU, block 0's output lives in VMEM with a one-window-row
// lag, because the grid runs in order on one core. Here blocks of the grid
// run in parallel and in no order, so the lag becomes an explicit dependence
// in one launch:
//
// * A thread block takes a ticket from an atomic counter when it starts and
//   does the work the ticket names, in window-row order: for row r, block 0's
//   windows of row r of every image, then block 1's windows of row r - 1.
//   A ticket names one window of one block.
// * Block 0's window writes its tile to a device scratch y0 (B, Hp, Wp, C) in
//   T, then publishes a ready flag per (image, window): every thread fences,
//   a barrier, then one release (atomic exchange after a fence).
// * Block 1's window reads its tokens of y0 at (r + sh, c + sw) mod the
//   padded grid, which lie in at most four block-0 windows (rows r and
//   r + 1, columns c and c + 1, wrapping: the last row reads row 0). One
//   thread spins on their flags with atomic reads and fences; the body then
//   reads y0 through L2 only (__ldcg; the tensor-core body's kLoadL2). Two
//   things keep a stale L1 line out: the waiting thread's fence, which on
//   sm_90a drops every line of the SM's L1 (CCTL.IVALL), and the L2-only
//   load, which would hold without it. The probe below shows on the card
//   that without a fence a plain or read-only load reads a line another SM
//   has overwritten since, and an L2-only load does not.
// * No deadlock: every ticket that a waiting thread block depends on was
//   handed out before its own, to a thread block that has started (tickets
//   go out in the order blocks start), and a block that holds a block-0
//   ticket never waits. That holds for any number of resident blocks an SM:
//   with the tensor-core body's two blocks of 8 warps an SM at C <= 128, a
//   block spinning on a flag shares its SM with one that may hold a block-0
//   ticket, whose warps the SM keeps issuing (the spin is one thread's
//   loop of atomic reads, the rest of its block waits at a barrier).
// * The live part of y0 is about two window rows of every image (stage 1 at
//   512^2: 7 x 133 x 128 x 2 bytes per row and image, some 7.6 MB for 16
//   images), which stays in the 50 MB L2 -- the counterpart of the TPU's
//   one-row VMEM lag.
// * The counter and the flags are zeroed by the wrapper on the same stream
//   before the launch. Each output is computed by one thread block, so the
//   result does not depend on the order the blocks ran in.
// * Shared memory per thread block is K1's layout in either body; the
//   ticket passes through the first slot of the token offsets before they
//   are filled, then a barrier, then the offsets, a barrier, then the body
//   (whose first act is to start its weight ring).
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC. Plain C interface; the entry returns the CUDA
// error code of its launch (0 on success).

#include "window_common.cuh"
#include "window_tc.cuh"

// The entry point's argument block. It stays outside the anonymous
// namespace: a type with internal linkage would hide the extern "C" entry.
namespace mmst {

// One block's weights and masks; mirrors PairBlock in ops/block_pair.py.
struct PairBlock {
  const void* wqkv;       // T (C, 3C): [wq | wk | wv]
  const float* bqkv;      // (3C)
  const void* wp;         // T (C, C)
  const float* bp;        // (C)
  const float* rel_bias;  // (heads, N, N)
  const float* mask;      // (nW, N, N) or null (block 0: always null)
  const float* padmask;   // (nW, N) or null
  const float* n1s;       // (C) or null: no LN1
  const float* n1b;
  const float* n2s;       // (C) or null: no LN2
  const float* n2b;
  const void* w1;         // T (C, hidden)
  const float* b1;        // (hidden)
  const void* w2;         // T (hidden, C)
  const float* b2;        // (C)
};

// Mirrors PairArgs in ops/block_pair.py field for field: every field is 8
// bytes, so the two layouts agree without padding rules.
struct PairArgs {
  const void* x;          // T (B, Hp, Wp, C)
  void* out;              // T, same shape
  void* y0;               // T scratch, same shape: block 0's output
  int* sync;              // [0] the ticket counter, [1 + b nW + w] flags
  PairBlock blk[2];
  double scale;           // head_dim ** -0.5
  long long dtype;        // 0 float32, 1 bfloat16
  long long B, Hp, Wp, C, heads, hidden;
  long long wh, ww, sh, sw;
  TcPlan plan;            // the body and its tiling (window_tc.cuh)
};

}  // namespace mmst

namespace {

using mmst::PairArgs;
using mmst::PairBlock;

// What a ticket names: (block, image, window row, window column). Tickets
// run row by row: P = B * nww tickets of block 0's row 0, then for each
// r = 1 .. nwh - 1 block 0's row r and block 1's row r - 1 (2 P), then block
// 1's last row (P).
struct Work {
  int blk;
  long long b, row, col;
};

__device__ __forceinline__ Work work_of(long long ticket, long long B,
                                       long long nwh, long long nww) {
  const long long P = B * nww;
  Work w;
  long long idx;
  if (ticket < P) {
    w.blk = 0;
    w.row = 0;
    idx = ticket;
  } else {
    const long long u = ticket - P;
    const long long r = 1 + u / (2 * P), v = u % (2 * P);
    if (r >= nwh) {
      w.blk = 1;
      w.row = nwh - 1;
      idx = v;
    } else if (v < P) {
      w.blk = 0;
      w.row = r;
      idx = v;
    } else {
      w.blk = 1;
      w.row = r - 1;
      idx = v - P;
    }
  }
  w.b = idx / nww;
  w.col = idx % nww;
  return w;
}

__device__ __forceinline__ void wait_ready(int* flag) {
  while (atomicAdd(flag, 0) == 0) {
  }
}

// The steps both kernels share. 1. A ticket, in the order the thread
// blocks start, through toff[0]; 2. the window's token offsets into toff:
// block 0 in the plain frame, block 1 in the frame rolled by (-sh, -sw).
// Ends with a barrier, so that the body may read toff.
__device__ __forceinline__ Work take_ticket(const PairArgs& a,
                                           long long* toff) {
  const int tid = threadIdx.x;
  const int wh = static_cast<int>(a.wh), ww = static_cast<int>(a.ww);
  if (tid == 0) toff[0] = atomicAdd(a.sync, 1);
  __syncthreads();
  const Work wk = work_of(toff[0], a.B, a.Hp / wh, a.Wp / ww);
  __syncthreads();
  const long long sh = wk.blk ? a.sh : 0, sw = wk.blk ? a.sw : 0;
  for (int t = tid; t < wh * ww; t += blockDim.x) {
    long long r = wk.row * wh + t / ww + sh;
    if (r >= a.Hp) r -= a.Hp;
    long long c = wk.col * ww + t % ww + sw;
    if (c >= a.Wp) c -= a.Wp;
    toff[t] = ((wk.b * a.Hp + r) * a.Wp + c) * a.C;
  }
  __syncthreads();
  return wk;
}

// 3. Block 0 publishes: its window of y0 is written.
__device__ __forceinline__ void publish(const PairArgs& a, const Work& wk) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const long long nW = (a.Hp / a.wh) * (a.Wp / a.ww);
    atomicExch(a.sync + 1 + wk.b * nW + wk.row * (a.Wp / a.ww) + wk.col, 1);
  }
}

// 4. Block 1 waits for the block-0 windows its shifted tokens lie in.
__device__ __forceinline__ void wait_inputs(const PairArgs& a,
                                            const Work& wk) {
  if (threadIdx.x == 0) {
    const long long nwh = a.Hp / a.wh, nww = a.Wp / a.ww;
    const long long r1 = a.sh ? (wk.row + 1) % nwh : wk.row;
    const long long c1 = a.sw ? (wk.col + 1) % nww : wk.col;
    int* flags = a.sync + 1 + wk.b * nwh * nww;
    wait_ready(flags + wk.row * nww + wk.col);
    wait_ready(flags + wk.row * nww + c1);
    wait_ready(flags + r1 * nww + wk.col);
    wait_ready(flags + r1 * nww + c1);
    __threadfence();
  }
  __syncthreads();
}

// This window's mask (block 1's) and validity mask, or null.
__device__ __forceinline__ const float* window_mask(const float* m,
                                                   const Work& wk,
                                                   const PairArgs& a,
                                                   long long per_window) {
  const long long w = wk.row * (a.Wp / a.ww) + wk.col;
  return m != nullptr ? m + w * per_window : nullptr;
}

// Launch bounds as K1's (window_block.cu): one resident block per SM as the
// least, so that ptxas does not hold the body to 64 registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) pair_kernel(const PairArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = static_cast<int>(a.wh * a.ww);
  const int C = static_cast<int>(a.C), heads = static_cast<int>(a.heads);
  const BlockLayout L = block_smem_layout(N, C, C / heads, sizeof(T));
  const Work wk = take_ticket(a, reinterpret_cast<long long*>(smem + L.toff));
  const int hidden = static_cast<int>(a.hidden);
  const float scale = static_cast<float>(a.scale);
  if (wk.blk == 0) {
    block_window<T, false>(a.blk[0], C, heads, hidden, scale,
                           static_cast<const T*>(a.x), static_cast<T*>(a.y0),
                           N, nullptr, window_mask(a.blk[0].padmask, wk, a, N),
                           smem);
    publish(a, wk);
    return;
  }
  wait_inputs(a, wk);
  block_window<T, true>(a.blk[1], C, heads, hidden, scale,
                        static_cast<const T*>(a.y0), static_cast<T*>(a.out),
                        N, window_mask(a.blk[1].mask, wk, a, N * N),
                        window_mask(a.blk[1].padmask, wk, a, N), smem);
}

template <typename T>
int launch(const PairArgs& a, cudaStream_t stream) {
  const int n = static_cast<int>(a.wh * a.ww);
  const int c = static_cast<int>(a.C);
  const BlockLayout L =
      block_smem_layout(n, c, c / static_cast<int>(a.heads), sizeof(T));
  const long long tickets = 2 * a.B * (a.Hp / a.wh) * (a.Wp / a.ww);
  return launch_kernel(pair_kernel<T>, dim3(static_cast<unsigned>(tickets)),
                       L.total, stream, a);
}

// At bf16 on the tensor-core body: one ticket per block of NT threads, MINB
// blocks an SM, a ring of S tiles (the head outputs in the normed tile's
// place at two blocks an SM), as K1's window_block_tc_kernel; block 1 reads
// y0 through L2 only.
template <int DH, int S, int MINB, int NT>
__global__ void __launch_bounds__(NT, MINB) pair_tc_kernel(const PairArgs a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = static_cast<int>(a.wh * a.ww), C = static_cast<int>(a.C);
  const int kp = static_cast<int>(a.plan.kp);
  const TcBlockLayout L = tc_block_layout(N, C, kp, S, MINB == 2);
  const Work wk = take_ticket(a, reinterpret_cast<long long*>(smem + L.toff));
  const int hidden = static_cast<int>(a.hidden);
  const float scale = static_cast<float>(a.scale);
  if (wk.blk == 0) {
    block_window_tc<DH, S, NT>(a.blk[0], C, hidden, scale,
                               static_cast<const bf16*>(a.x),
                               static_cast<bf16*>(a.y0), N, nullptr,
                               window_mask(a.blk[0].padmask, wk, a, N), kp,
                               MINB == 2, smem);
    publish(a, wk);
    return;
  }
  wait_inputs(a, wk);
  block_window_tc<DH, S, NT, kLoadL2>(
      a.blk[1], C, hidden, scale, static_cast<const bf16*>(a.y0),
      static_cast<bf16*>(a.out), N, window_mask(a.blk[1].mask, wk, a, N * N),
      window_mask(a.blk[1].padmask, wk, a, N), kp, MINB == 2, smem);
}

template <int DH>
int launch_tc_dh(const PairArgs& a, dim3 grid, size_t bytes,
                 cudaStream_t stream) {
  if (a.plan.body == 2)
    return launch_kernel(pair_tc_kernel<DH, 2, 2, 256>, grid, bytes, stream,
                         a, 256);
  return launch_kernel(pair_tc_kernel<DH, 3, 1, 512>, grid, bytes, stream,
                       a, 512);
}

// The tensor-core launch: the plan must be one pair_plan gives for this
// call (checked here, as K1's launch checks its own), its shared memory
// what the layout needs.
int launch_tc(const PairArgs& a, cudaStream_t stream) {
  const mmst::TcPlan& p = a.plan;
  const long long n = a.wh * a.ww, c = a.C, dh = a.heads ? c / a.heads : 0;
  if (!tc_plan_ok(p, a.dtype, n, c, a.heads, a.hidden,
                  tc_block_layout(static_cast<int>(n), static_cast<int>(c),
                                  static_cast<int>(p.kp),
                                  static_cast<int>(p.stages), p.body == 2)
                      .total))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tickets = 2 * a.B * (a.Hp / a.wh) * (a.Wp / a.ww);
  const dim3 grid(static_cast<unsigned>(tickets));
  const size_t bytes = static_cast<size_t>(p.smem_bytes);
  if (dh == 16) return launch_tc_dh<16>(a, grid, bytes, stream);
  if (dh == 32) return launch_tc_dh<32>(a, grid, bytes, stream);
  return launch_tc_dh<64>(a, grid, bytes, stream);
}

template <int DH>
int tc_attributes(long long body, long long* smem, long long* dyn,
                  long long* regs) {
  return body == 2 ? attributes_of(pair_tc_kernel<DH, 2, 2, 256>, smem, dyn,
                                   regs)
                   : attributes_of(pair_tc_kernel<DH, 3, 1, 512>, smem, dyn,
                                   regs);
}

// The load policy's probe: thread block 0 takes block 1's part in K11 and
// thread block 1 block 0's, on n 16-byte pieces of y. Block 0 reads them
// through load16<P> (first), publishes, waits on block 1's flag as K11's
// block 1 waits (one thread's atomic reads, a fence, a barrier), then reads
// them again through the same load (second). Block 1 waits for the first
// reading, overwrites the pieces with fresh ones, and publishes as K11's
// block 0 does (every thread fences, a barrier, a fence, the atomic
// exchange). Each block asks for more than half an SM's shared memory, so
// the two run on two SMs, and a line block 0's SM kept from its first
// reading can answer its second. On sm_90a every __threadfence() compiles
// to MEMBAR.SC.GPU and CCTL.IVALL, which drops every line of the SM's L1:
// so with fence off block 0 fences neither before publishing nor after
// waiting, and only then can its first reading's lines stay in L1.
template <int P>
__global__ void __launch_bounds__(kThreads)
load_probe_kernel(const __nv_bfloat16* y, uint4* y_w, const uint4* fresh,
                  uint4* first, uint4* second, int* flags, int n,
                  int fence) {
  const int tid = threadIdx.x;
  if (blockIdx.x == 0) {
    for (int i = tid; i < n; i += blockDim.x)
      first[i] = load16<P>(y + 8 * static_cast<long long>(i));
    __syncthreads();
    if (tid == 0) {
      if (fence) __threadfence();
      atomicExch(flags, 1);
      wait_ready(flags + 1);
      if (fence) __threadfence();
    }
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x)
      second[i] = load16<P>(y + 8 * static_cast<long long>(i));
    return;
  }
  if (tid == 0) wait_ready(flags);
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) y_w[i] = fresh[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    atomicExch(flags + 1, 1);
  }
}

template <int P>
int launch_probe(const void* y, const void* fresh, void* first, void* second,
                 int* flags, int n, int fence, cudaStream_t stream) {
  const size_t bytes = 160 * 1024;  // one block an SM
  const int err = opt_in_smem(load_probe_kernel<P>, bytes);
  if (err != 0) return err;
  load_probe_kernel<P><<<2, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(y),
      static_cast<uint4*>(const_cast<void*>(y)),
      static_cast<const uint4*>(fresh), static_cast<uint4*>(first),
      static_cast<uint4*>(second), flags, n, fence);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory in bytes that one thread block of the scalar kernel takes
// (K1's scalar layout).
long long mmst_window_block_pair_smem_bytes(long long n, long long c,
                                            long long heads,
                                            long long tsize) {
  return static_cast<long long>(
      block_smem_layout(static_cast<int>(n), static_cast<int>(c),
                        static_cast<int>(c / heads), static_cast<int>(tsize))
          .total);
}

// Static shared memory, dynamic shared memory opted in so far on the
// current device and registers per thread of a kernel: body 0 the scalar
// kernel at dtype (0 f32, 1 bf16), body 1 or 2 the tensor-core kernel of
// head dim dh at that many blocks an SM.
int mmst_window_block_pair_attributes(long long body, long long dtype,
                                      long long dh, long long* smem,
                                      long long* dyn, long long* regs) {
  if (body == 1 || body == 2) {
    if (dh == 16) return tc_attributes<16>(body, smem, dyn, regs);
    if (dh == 32) return tc_attributes<32>(body, smem, dyn, regs);
    if (dh == 64) return tc_attributes<64>(body, smem, dyn, regs);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return attributes_of(pair_kernel<__nv_bfloat16>, smem, dyn, regs);
  return attributes_of(pair_kernel<float>, smem, dyn, regs);
}

int mmst_window_block_pair_rows(const mmst::PairArgs* a, void* stream) {
  if (a->Hp % a->wh || a->Wp % a->ww || a->sh < 0 || a->sh >= a->wh ||
      a->sw < 0 || a->sw >= a->ww || a->blk[0].mask != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->plan.body == 1 || a->plan.body == 2) return launch_tc(*a, s);
  if (a->plan.body != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a->dtype == 1) return launch<__nv_bfloat16>(*a, s);
  return launch<float>(*a, s);
}

// The load policy's probe (load_probe_kernel) with policy 0 (a plain
// load), 1 (L2 only, K11's block 1) or 2 (the read-only path) on n 16-byte
// pieces at y (overwritten with fresh), the waiting thread's fence on or
// off; flags: two zeroed ints.
int mmst_pair_load_probe(long long policy, long long fence, const void* y,
                         const void* fresh, void* first, void* second,
                         int* flags, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(n), f = fence != 0;
  if (policy == kLoadPlain)
    return launch_probe<kLoadPlain>(y, fresh, first, second, flags, m, f, s);
  if (policy == kLoadL2)
    return launch_probe<kLoadL2>(y, fresh, first, second, flags, m, f, s);
  if (policy == kLoadReadOnly)
    return launch_probe<kLoadReadOnly>(y, fresh, first, second, flags, m, f,
                                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
