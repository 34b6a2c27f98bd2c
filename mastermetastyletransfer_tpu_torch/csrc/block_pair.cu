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
// Each window of each block runs `block_window` (window_common.cuh), the
// scalar per-window body of K1 and K2, with that block's weights and validity mask (and
// block 1's shift mask); block 0's output rounds to T, as the JAX kernel's
// scratch holds it. So the function is K1's row entry applied twice.
//
// What bounds it on an H100: the per-window work of K1 twice, some 400k
// operations per token and block against the tokens read and written once,
// so the tensor-core rate; this version, like K1, does the products with
// scalar FMAs, far below that bound.
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
//   reads y0 through L2 only (__ldcg), never a stale L1 line.
// * No deadlock: every ticket that a waiting thread block depends on was
//   handed out before its own, to a block that has started, and a block that
//   holds a block-0 ticket never waits.
// * The live part of y0 is about two window rows of every image (stage 1 at
//   512^2: 7 x 133 x 128 x 2 bytes per row and image, some 7.6 MB for 16
//   images), which stays in the 50 MB L2 -- the counterpart of the TPU's
//   one-row VMEM lag.
// * The counter and the flags are zeroed by the wrapper on the same stream
//   before the launch. Each output is computed by one thread block, so the
//   result does not depend on the order the blocks ran in.
// * Shared memory per thread block is K1's (the ticket passes through the
//   slot of the token offsets before they are filled).
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC. Plain C interface; the entry returns the CUDA
// error code of its launch (0 on success).

#include "window_common.cuh"

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

// Launch bounds as K1's (window_block.cu): one resident block per SM as the
// least, so that ptxas does not hold the body to 64 registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) pair_kernel(const PairArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int wh = static_cast<int>(a.wh), ww = static_cast<int>(a.ww);
  const int N = wh * ww;
  const long long nwh = a.Hp / wh, nww = a.Wp / ww, nW = nwh * nww;
  const BlockLayout L = block_smem_layout(
      N, static_cast<int>(a.C), static_cast<int>(a.C / a.heads), sizeof(T));
  long long* toff = reinterpret_cast<long long*>(smem + L.toff);
  int* flags = a.sync + 1;

  // 1. A ticket, in the order the thread blocks start.
  if (tid == 0) toff[0] = atomicAdd(a.sync, 1);
  __syncthreads();
  const Work wk = work_of(toff[0], a.B, nwh, nww);
  __syncthreads();
  const long long w = wk.row * nww + wk.col;
  const long long sh = wk.blk ? a.sh : 0, sw = wk.blk ? a.sw : 0;

  // 2. The window's token offsets: block 0 in the plain frame, block 1 in
  //    the frame rolled by (-sh, -sw).
  for (int t = tid; t < N; t += blockDim.x) {
    long long r = wk.row * wh + t / ww + sh;
    if (r >= a.Hp) r -= a.Hp;
    long long c = wk.col * ww + t % ww + sw;
    if (c >= a.Wp) c -= a.Wp;
    toff[t] = ((wk.b * a.Hp + r) * a.Wp + c) * a.C;
  }

  const int C = static_cast<int>(a.C), heads = static_cast<int>(a.heads);
  const int hidden = static_cast<int>(a.hidden);
  const float scale = static_cast<float>(a.scale);
  if (wk.blk == 0) {
    const float* pm_w =
        a.blk[0].padmask != nullptr ? a.blk[0].padmask + w * N : nullptr;
    __syncthreads();
    block_window<T, false>(a.blk[0], C, heads, hidden, scale,
                           static_cast<const T*>(a.x), static_cast<T*>(a.y0),
                           N, nullptr, pm_w, smem);
    // 3. Publish: this window of y0 is written.
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      atomicExch(flags + wk.b * nW + w, 1);
    }
    return;
  }
  // 4. Block 1: wait for the block-0 windows its shifted tokens lie in.
  if (tid == 0) {
    const long long r1 = sh ? (wk.row + 1) % nwh : wk.row;
    const long long c1 = sw ? (wk.col + 1) % nww : wk.col;
    const long long base = wk.b * nW;
    wait_ready(flags + base + wk.row * nww + wk.col);
    wait_ready(flags + base + wk.row * nww + c1);
    wait_ready(flags + base + r1 * nww + wk.col);
    wait_ready(flags + base + r1 * nww + c1);
    __threadfence();
  }
  __syncthreads();
  block_window<T, true>(
      a.blk[1], C, heads, hidden, scale, static_cast<const T*>(a.y0),
      static_cast<T*>(a.out), N,
      a.blk[1].mask != nullptr ? a.blk[1].mask + w * N * N : nullptr,
      a.blk[1].padmask != nullptr ? a.blk[1].padmask + w * N : nullptr,
      smem);
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

}  // namespace

extern "C" {

// Shared memory in bytes that one thread block of the kernel takes (K1's).
long long mmst_window_block_pair_smem_bytes(long long n, long long c,
                                            long long heads,
                                            long long tsize) {
  return static_cast<long long>(
      block_smem_layout(static_cast<int>(n), static_cast<int>(c),
                        static_cast<int>(c / heads), static_cast<int>(tsize))
          .total);
}

int mmst_window_block_pair_rows(const mmst::PairArgs* a, void* stream) {
  if (a->Hp % a->wh || a->Wp % a->ww || a->sh < 0 || a->sh >= a->wh ||
      a->sw < 0 || a->sw >= a->ww || a->blk[0].mask != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 1) return launch<__nv_bfloat16>(*a, s);
  return launch<float>(*a, s);
}

}  // extern "C"
