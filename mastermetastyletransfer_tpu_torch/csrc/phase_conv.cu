// The CNN decoder's phase-space kernels, hand-written for Hopper.
//
// Replace the TPU kernels of mastermetastyletransfer_tpu/ops/pallas_conv.py
//
//   K5 `stencil_phase_conv` (body `_stencil_kernel`)
//      -> mmst_stencil_phase_conv
//   K6 `stencil_phase2_conv` (body `_stencil2_kernel`)
//      -> mmst_stencil_phase2_conv
//   K6 `stencil_phase2_conv_padcols` (body `_stencil2_padcols_kernel`)
//      -> mmst_stencil_phase2_conv_padcols
//   K7 `phase_align` (body `_kernel`)
//      -> mmst_phase_align
//   K12 `stencil_phase2_rgb` (body `_rgb_kernel`)
//      -> mmst_stencil_phase2_rgb
//   K12 `stencil_phase2_rgb128` (body `_rgb128_kernel`)
//      -> mmst_stencil_phase2_rgb128
//
// K5 and K6 are one "stencil GEMM": a 2x2-tap convolution of a padded
// phase tensor pp (B, H+2, W+2, Cin) into G output groups of C' channels
// (G = 4 for K5, 16 for K6), with the phase align folded into per-group read
// offsets (oy_g, ox_g):
//
//   out[b, i, j, g C' + n] = ReLU(bias[g C' + n] + sum over the taps (dy, dx)
//       of pp[b, i + oy_g + dy, j + ox_g + dx, :] . w[dy, dx, :, g C' + n])
//
// The composed phase kernels are block-sparse: split Cin into `nchunks`
// equal chunks (the input phases); a (tap, chunk) block of w is zero for a
// group unless bit tap * nchunks + chunk of blocks[g] is set (tap = 2 dy +
// dx). The bitmask comes from the phase algebra (ops/conv.py), not from the
// weights, and the kernel skips the zero blocks. Products accumulate in f32
// (plain FMAs, no TF32), the f32 bias is added, ReLU applied, and the value
// rounds once to the type T of pp, as `_stencil_kernel` and
// `_stencil2_accum` do.
//
// The padcols entry writes (B, H, W+2, 16 C'): the interior at columns
// 1..W, and columns 0 and W+1 hold the next L2 conv's phase-pad columns.
// Pad slot s of a column border copies, for every row phase and channel, the
// output at column src[s] and column phase ph[s] (ops/conv.py:
// _phase2_pad_maps). The thread that writes a 16-byte piece of an output
// whose (column, column phase) is a source of a slot writes the same
// rounded piece to that slot too, so the border is an exact copy and needs
// nothing from other blocks.
//
// K12 is the decoder's RGB conv (conv8, 32 -> 3) on the L2 phase tensor:
// the same stencil with the same 16 read offsets (the generalized align),
// but with output groups of Cg <= 8 channels. The sums (f32) get the bias
// and optional ReLU and round once to T, then go out in one of two layouts:
//
//   mmst_stencil_phase2_rgb     the interleaved fine grid (B, 4H, 4W, Cg):
//                               group g = 4a + b of pixel (i, j) at
//                               (4i + a, 4j + b) -- `_rgb_kernel` rounds
//                               its sums to T before its exact selection
//                               and interleave;
//   mmst_stencil_phase2_rgb128  the aligned L2 tensor (B, H, W, 16 Cg) with
//                               Cg = 8: group g's lanes [8g, 8g + 8), the
//                               zero lanes of its composed kernel included
//                               -- `_rgb128_kernel` keeps its sums in f32
//                               through its masked align, whose one nonzero
//                               term per lane is the same value, and rounds
//                               once.
//
// A table with every block set (nchunks = 1, blocks 0b1111) computes the
// JAX kernels' dense tap products; the decoder passes the L2 table, whose
// zero blocks are structurally zero, so the function is the same up to the
// order of the sums.
//
// K7 is a pure permutation: out[b, i, j, g C' + c] = big[b, i + a, j + bb,
// g C' + c] for g = 2 a + bb, copied in 16-byte vectors.
//
// Two bodies compute the stencil. K5 at bf16, both K6 entries and both K12
// entries run the tensor-core body of stencil_tc.cuh (one block per pixel
// tile across all groups, cp.async staging, mma.sync at bf16, FMAs at f32
// for K6 and K12; K6 padcols writes its pad columns from the output tile).
// K5 at f32 runs stencil_kernel below: a block owns 256 output pixels x 32
// channels of one group, the pixel tile (16 channels deep, f32) and the
// weight tile sit in 18 KB of shared memory, each thread keeps an 8 x 4
// register tile of scalar f32 FMAs, and the zero weight blocks are never
// read. At f32 the tensor cores would mean TF32, which the port's rounding
// points forbid.
//
// What bounds them on an H100: at the decoder's shapes (512^2, batch 8)
// K5 does 17-39 GFLOP of nonzero products per call against 43-103 MB, K6
// 17 GFLOP against 172 MB, so the bf16 bound is the tensor cores for
// conv1-4 and the memory for conv6, conv7 and K7. K12 reads a 138 MB (bf16)
// L2 tensor for 1.6 GFLOP of nonzero products, so the memory bounds it. K7
// moves each byte once, in 16-byte accesses.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC. Plain C interface; each entry returns the CUDA
// error code of its launch (0 on success).

#include "stencil_tc.cuh"

// The entry points' argument blocks. They stay outside the anonymous
// namespace: a type with internal linkage would hide the extern "C" entries.
namespace mmst {

// Mirrors StencilArgs in ops/phase_conv.py field for field.
struct StencilArgs {
  const void* pp;     // T (B, H+2, W+2, Cin)
  const void* w;      // T (2, 2, Cin, groups * Cout)
  const float* bias;  // (groups * Cout)
  void* out;          // T (B, H, W + 2 padcols, groups * Cout)
  long long dtype;    // 0 float32, 1 bfloat16
  long long B, H, W, Cin, Cout, groups, nchunks, relu, padcols;
  long long off_y[16], off_x[16];       // per group read offsets, 0 or 1
  unsigned long long blocks[16];        // per group nonzero (tap, chunk)
  long long left_src[4], left_ph[4];    // padcols: column border slots
  long long right_src[4], right_ph[4];
  TilePlan plan;                        // the tensor-core body (K6, bf16 K5)
};

// Mirrors RgbArgs in ops/phase_conv.py field for field.
struct RgbArgs {
  const void* pp;     // T (B, H+2, W+2, Cin)
  const void* w;      // T (2, 2, Cin, 16 Cg)
  const float* bias;  // (16 Cg)
  void* out;          // T (B, 4H, 4W, Cg) or (B, H, W, 16 Cg)
  long long dtype;    // 0 float32, 1 bfloat16
  long long B, H, W, Cin, Cg, nchunks, relu;
  long long off_y[16], off_x[16];       // per group read offsets, 0 or 1
  unsigned long long blocks[16];        // per group nonzero (tap, chunk)
  TilePlan plan;                        // the tensor-core body
};

// Mirrors AlignArgs in ops/phase_conv.py.
struct AlignArgs {
  const void* big;  // T (B, H+1, W+1, 4 Cout)
  void* out;        // T (B, H, W, 4 Cout)
  long long tsize;  // bytes per element
  long long B, H, W, Cout;
};

}  // namespace mmst

namespace {

using mmst::AlignArgs;
using mmst::RgbArgs;
using mmst::StencilArgs;

constexpr int BM = 256;  // output pixels per block
constexpr int BN = 32;   // output channels per block, inside one group
constexpr int BK = 16;   // input channels per step
constexpr int TM = 8;    // pixels per thread
constexpr int TN = 4;    // channels per thread

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Sixteen consecutive values (16-byte aligned) as f32.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = q[i];
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 x = q[i];
    const uint32_t u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[8 * i + 2 * k] = bf16_lo(u[k]);
      v[8 * i + 2 * k + 1] = bf16_hi(u[k]);
    }
  }
}

// Four consecutive values (aligned to 4 elements) as f32.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = bf16_lo(x.x);
  v[1] = bf16_hi(x.x);
  v[2] = bf16_lo(x.y);
  v[3] = bf16_hi(x.y);
}

// One block: output pixels [m0, m0 + BM) of the flattened (B, H, W) grid and
// channels [n0, n0 + BN) of one group. Thread (tm, tn) = (tid / 8, tid % 8)
// sums pixels m0 + tm * TM + [0, TM) and channels n0 + tn * TN + [0, TN).
// Each step loads one pixel's BK input channels per thread, transposed into
// As[k][pixel], and BK x BN weights into Bs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stencil_kernel(const StencilArgs a) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const long long H = a.H, W = a.W, Cin = a.Cin;
  const long long N = a.groups * a.Cout;
  const long long M = a.B * H * W;
  const long long n0 = static_cast<long long>(blockIdx.y) * BN;
  const int g = static_cast<int>(n0 / a.Cout);
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const unsigned long long blocks = a.blocks[g];
  const long long chunk = Cin / a.nchunks;

  // The pixel this thread loads, and its window's top-left in pp.
  const long long ml = m0 + tid;
  const bool lvalid = ml < M;
  const long long lb = lvalid ? ml / (H * W) : 0;
  const long long li = lvalid ? (ml / W) % H : 0;
  const long long lj = lvalid ? ml % W : 0;
  const T* pp = static_cast<const T*>(a.pp);
  const T* wt = static_cast<const T*>(a.w);
  const T* win = pp + ((lb * (H + 2) + li + a.off_y[g]) * (W + 2) + lj +
                       a.off_x[g]) * Cin;

  const int tm = tid / (BN / TN), tn = tid % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 4; ++tap) {
    const int dy = tap >> 1, dx = tap & 1;
    const T* src = win + (dy * (W + 2) + dx) * Cin;
    const T* wsrc = wt + tap * Cin * N + n0;
    for (long long c = 0; c < a.nchunks; ++c) {
      if (!((blocks >> (tap * a.nchunks + c)) & 1ull)) continue;
      for (long long k0 = c * chunk; k0 < (c + 1) * chunk; k0 += BK) {
        float v[BK];
        if (lvalid) {
          load16(src + k0, v);
        } else {
#pragma unroll
          for (int k = 0; k < BK; ++k) v[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < BK; ++k) As[k][tid] = v[k];
        if (tid < BK * BN / 4) {
          const int r = tid / (BN / 4), col = (tid % (BN / 4)) * 4;
          load4(wsrc + (k0 + r) * N + col, &Bs[r][col]);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          const float4 a0 = *reinterpret_cast<const float4*>(&As[k][tm * TM]);
          const float4 a1 =
              *reinterpret_cast<const float4*>(&As[k][tm * TM + 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tn * TN]);
          const float av[TM] = {a0.x, a0.y, a0.z, a0.w,
                                a1.x, a1.y, a1.z, a1.w};
          const float bv[TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  // Epilogue: bias, ReLU, one rounding.
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + tm * TM + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long n = n0 + tn * TN + j;
      float val = acc[i][j] + a.bias[n];
      if (a.relu) val = fmaxf(val, 0.f);
      out[m * N + n] = from_f<T>(val);
    }
  }
}

// One thread per 16-byte vector of the output.
__global__ void __launch_bounds__(kThreads) align_kernel(const AlignArgs a) {
  const long long vec = 16 / a.tsize;             // elements per vector
  const long long c4 = 4 * a.Cout;
  const long long per_pixel = c4 / vec;
  const long long total = a.B * a.H * a.W * per_pixel;
  const uint4* big = static_cast<const uint4*>(a.big);
  uint4* out = static_cast<uint4*>(a.out);
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long v = e % per_pixel, m = e / per_pixel;
    const long long b = m / (a.H * a.W), i = (m / a.W) % a.H, j = m % a.W;
    const long long g = v * vec / a.Cout;
    const long long src = ((b * (a.H + 1) + i + g / 2) * (a.W + 1) + j +
                           g % 2) * per_pixel + v;
    out[e] = big[src];
  }
}

template <typename T>
int launch_stencil(const StencilArgs& a, cudaStream_t stream) {
  const long long M = a.B * a.H * a.W;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>(a.groups * a.Cout / BN));
  stencil_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K5 at f32; the shapes the kernel needs (C' % BN, chunks of whole BK
// steps) are checked here too.
int stencil(const StencilArgs* a, void* stream) {
  if (a->groups != 4 || a->padcols || a->Cout % BN || a->nchunks < 1 ||
      a->Cin % (a->nchunks * BK))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_stencil<float>(*a, static_cast<cudaStream_t>(stream));
}

// The tensor-core body's launch: the plan must be the one this
// instantiation was compiled for (ops/phase_conv.py:stencil_plan builds it)
// and its shared memory what the instantiation needs.
template <typename T, int G, int BN, int WARPS_M, int WARPS_N, int STAGES,
          int MINB, bool kFine, int PAT = kPatGeneral>
struct TcKernel {
  static int launch(const TcArgs& a, cudaStream_t stream) {
    const mmst::TilePlan& p = a.plan;
    const long long sk = p.stage_k;
    const long long tiles = static_cast<long long>(a.B) *
                            ((a.H + kTileH - 1) / kTileH) *
                            ((a.W + kTileW - 1) / kTileW);
    bool ok = p.tile_h == kTileH && p.tile_w == kTileW && p.bn == BN &&
              p.stages == STAGES && (sk == 16 || sk == 32) &&
              a.chunk % sk == 0 && a.cg >= 1 &&
              (a.cg % BN == 0 || (G == 16 && a.cg < BN)) &&
              p.blocks == tiles * ((a.cg + BN - 1) / BN) &&
              p.max_pairs >= 0 && p.max_pairs <= 4 * G && p.nused >= 0 &&
              p.nused <= 16 && a.Cin / a.chunk <= 16 &&
              // offsets within one image and within the weights are ints
              (a.H + 2LL) * (a.W + 2) * a.Cin < (1LL << 31) &&
              4LL * a.Cin * a.N < (1LL << 31) &&
              p.smem_bytes == tc_smem_bytes<T, G, BN, STAGES, kFine>(
                                  sk, p.max_pairs, a.cg) &&
              p.smem_bytes <= kMaxDynSmem;
    ok = ok && p.pattern == PAT;
    for (int i = 0; ok && i < p.nused; ++i) {
      const int c = p.used[i];
      ok = c < a.Cin / a.chunk && p.npairs[c] <= p.max_pairs;
      unsigned long long bits = 0;
      for (int slot = 0; ok && slot < p.npairs[c]; ++slot) {
        const int g = p.pairs[c][slot] & 15, tap = p.pairs[c][slot] >> 4;
        ok = g < G && tap < 4 && (1ull << (4 * g + tap)) > bits;
        bits |= 1ull << (4 * g + tap);
      }
      // a compiled table's pairs and offsets are the ones compiled in
      if (PAT == kPatDense) ok = ok && bits == dense_bits<G>();
      if (PAT == kPatPhase)
        ok = ok && G == 4 && a.Cin / a.chunk == 4 && bits == kPhaseBits[c];
      if (PAT == kPatRgb)
        ok = ok && G == 16 && a.Cin / a.chunk == 16 && bits == kRgbBits[c];
      if (PAT == kPatL2Up)
        ok = ok && G == 16 && a.Cin / a.chunk == 4 && bits == kL2UpBits[c];
    }
    for (int g = 0; ok && PAT != kPatGeneral && g < G; ++g)
      ok = a.off_y[g] == known_oy<G>(g) && a.off_x[g] == known_ox<G>(g);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const int err = opt_in_smem(
        tc_stencil_kernel<T, G, BN, WARPS_M, WARPS_N, STAGES, MINB, kFine, PAT>,
        static_cast<size_t>(p.smem_bytes));
    if (err != 0) return err;
    if (p.blocks > 0)
      tc_stencil_kernel<T, G, BN, WARPS_M, WARPS_N, STAGES, MINB, kFine, PAT>
          <<<static_cast<unsigned>(p.blocks), WARPS_M * WARPS_N * 32,
             static_cast<size_t>(p.smem_bytes), stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }

  // Static and dynamic shared memory (the largest a launch has used so
  // far) and registers per thread.
  static int attributes(long long* smem, long long* dyn, long long* regs) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(
        &attr,
        tc_stencil_kernel<T, G, BN, WARPS_M, WARPS_N, STAGES, MINB, kFine, PAT>);
    if (err != cudaSuccess) return static_cast<int>(err);
    *smem = static_cast<long long>(attr.sharedSizeBytes);
    *dyn = opted_in_smem(
        tc_stencil_kernel<T, G, BN, WARPS_M, WARPS_N, STAGES, MINB, kFine, PAT>);
    *regs = static_cast<long long>(attr.numRegs);
    return 0;
  }
};

// K5 at bf16: 4 groups, a slice of 64 (C' % 64 == 0) or 32 channels of
// each; 8 warps as 4 (rows) x 2 (channels).
template <int BN, int PAT>
using K5Tc = TcKernel<__nv_bfloat16, 4, BN, 4, 2, 3, 1, false, PAT>;
// K6 at bf16: 16 groups, a slice of 16 of their 32 channels; 8 warps, one
// tile row each (128 accumulators, as K5's 64-channel form).
template <int PAT>
using K6Tc = TcKernel<__nv_bfloat16, 16, 16, 8, 1, 3, 1, false, PAT>;
// K12: 16 groups of one 8-lane slot; 8 warps, one tile row each for a
// compiled table, two groups each for any other; at bf16 two blocks per SM.
template <typename T, bool kFine, int PAT = kPatGeneral>
using K12Tc =
    TcKernel<T, 16, 8, 8, 1, 4, sizeof(T) == 2 ? 2 : 1, kFine, PAT>;
// K6 at f32 on the body's FMA form: K12 rgb128's f32 instantiation (16
// groups, two a warp), slices of 8 of C' channels.
using K6F32 = K12Tc<float, false>;

template <typename Args>
TcArgs tc_args(const Args& a, long long cg, long long n) {
  TcArgs t;
  t.pp = a.pp;
  t.w = a.w;
  t.bias = a.bias;
  t.out = a.out;
  t.B = static_cast<int>(a.B);
  t.H = static_cast<int>(a.H);
  t.W = static_cast<int>(a.W);
  t.Cin = static_cast<int>(a.Cin);
  t.cg = static_cast<int>(cg);
  t.N = static_cast<int>(n);
  t.chunk = static_cast<int>(a.Cin / a.nchunks);
  t.relu = static_cast<int>(a.relu);
  for (int g = 0; g < 16; ++g) {
    t.off_y[g] = static_cast<int>(a.off_y[g]);
    t.off_x[g] = static_cast<int>(a.off_x[g]);
  }
  t.padcols = 0;
  t.plan = a.plan;
  return t;
}

// K5's entry: the tensor-core body at bf16, stencil_kernel at f32.
int stencil_phase(const StencilArgs* a, void* stream) {
  if (a->dtype != 1) return stencil(a, stream);
  if (a->groups != 4 || a->padcols || a->Cout % 32 || a->nchunks < 1 ||
      a->nchunks > 16 || a->Cin % (a->nchunks * 16) || a->H < 1 || a->W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const TcArgs t = tc_args(*a, a->Cout, 4 * a->Cout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = a->Cout % 64 == 0;
  switch (a->plan.pattern) {
    case kPatDense:
      return wide ? K5Tc<64, kPatDense>::launch(t, s)
                  : K5Tc<32, kPatDense>::launch(t, s);
    case kPatPhase:
      return wide ? K5Tc<64, kPatPhase>::launch(t, s)
                  : K5Tc<32, kPatPhase>::launch(t, s);
    default:
      return wide ? K5Tc<64, kPatGeneral>::launch(t, s)
                  : K5Tc<32, kPatGeneral>::launch(t, s);
  }
}

// K6's two entries on the tensor-core body (with the pad columns for
// padcols): mma.sync at bf16, its FMA form at f32 (0.84 against
// stencil_kernel's 1.20 ms at conv7 on an H100, PERF.md).
int stencil_phase2(const StencilArgs* a, void* stream, long long padcols) {
  if (a->groups != 16 || a->padcols != padcols || a->Cout % 16 ||
      a->nchunks < 1 || a->nchunks > 16 || a->Cin % (a->nchunks * 16) ||
      a->H < 1 || a->W < 1 || (padcols && a->W < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  TcArgs t = tc_args(*a, a->Cout, 16 * a->Cout);
  t.padcols = static_cast<int>(padcols);
  for (int s = 0; s < 4; ++s) {
    if (padcols && (a->left_src[s] < 0 || a->left_src[s] >= a->W ||
                    a->right_src[s] < 0 || a->right_src[s] >= a->W ||
                    a->left_ph[s] < 0 || a->left_ph[s] > 3 ||
                    a->right_ph[s] < 0 || a->right_ph[s] > 3))
      return static_cast<int>(cudaErrorInvalidValue);
    t.left_src[s] = static_cast<int>(a->left_src[s]);
    t.left_ph[s] = static_cast<int>(a->left_ph[s]);
    t.right_src[s] = static_cast<int>(a->right_src[s]);
    t.right_ph[s] = static_cast<int>(a->right_ph[s]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype != 1) return K6F32::launch(t, s);
  return a->plan.pattern == kPatL2Up ? K6Tc<kPatL2Up>::launch(t, s)
                                     : K6Tc<kPatGeneral>::launch(t, s);
}

// The shapes the RGB kernel takes: groups of at most 8 channels (8 for the
// slot entry), chunks of whole 16-channel steps, read offsets 0 or 1.
int rgb(const RgbArgs* a, void* stream, bool fine) {
  bool ok = a->Cg >= 1 && a->Cg <= 8 && (fine || a->Cg == 8) &&
            a->nchunks >= 1 && a->nchunks <= 16 &&
            a->Cin % (a->nchunks * 16) == 0 && a->H >= 1 && a->W >= 1;
  for (int g = 0; g < 16; ++g)
    ok = ok && a->off_y[g] >= 0 && a->off_y[g] <= 1 && a->off_x[g] >= 0 &&
         a->off_x[g] <= 1;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const TcArgs t = tc_args(*a, a->Cg, 16 * a->Cg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype != 1)
    return fine ? K12Tc<float, true>::launch(t, s)
                : K12Tc<float, false>::launch(t, s);
  using B16 = __nv_bfloat16;
  switch (a->plan.pattern) {
    case kPatDense:
      return fine ? K12Tc<B16, true, kPatDense>::launch(t, s)
                  : K12Tc<B16, false, kPatDense>::launch(t, s);
    case kPatRgb:
      return fine ? K12Tc<B16, true, kPatRgb>::launch(t, s)
                  : K12Tc<B16, false, kPatRgb>::launch(t, s);
    default:
      return fine ? K12Tc<B16, true>::launch(t, s)
                  : K12Tc<B16, false>::launch(t, s);
  }
}

// Static shared memory, dynamic shared memory (the largest a launch has
// used so far; 0 for the kernels that use none) and registers per thread of
// one block of a kernel: which 0 stencil_kernel (K5 at f32), 1 the
// align copy, 2 K12's fine-grid form, 3 its slot form, 4 and 5 K5's
// tensor-core body with 64- and 32-channel slices (bf16 only), 6 and 7
// K6's (16-channel slices at bf16, 8 at f32);
// pattern the compiled table of the tensor-core body (0 for any table;
// bf16 only); dtype 0 float32, 1 bfloat16.
template <int PAT>
int k5_attributes(long long which, long long* smem, long long* dyn,
                  long long* regs) {
  return which == 4 ? K5Tc<64, PAT>::attributes(smem, dyn, regs)
                    : K5Tc<32, PAT>::attributes(smem, dyn, regs);
}
template <bool kFine>
int k12_attributes(long long dtype, long long pattern, long long* smem,
                   long long* dyn, long long* regs) {
  if (dtype != 1)
    return pattern == kPatGeneral
               ? K12Tc<float, kFine>::attributes(smem, dyn, regs)
               : static_cast<int>(cudaErrorInvalidValue);
  switch (pattern) {
    case kPatGeneral:
      return K12Tc<__nv_bfloat16, kFine>::attributes(smem, dyn, regs);
    case kPatDense:
      return K12Tc<__nv_bfloat16, kFine, kPatDense>::attributes(smem, dyn,
                                                                regs);
    case kPatRgb:
      return K12Tc<__nv_bfloat16, kFine, kPatRgb>::attributes(smem, dyn,
                                                              regs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int mmst_phase_conv_attributes(long long which, long long dtype,
                               long long pattern, long long* smem,
                               long long* dyn, long long* regs) {
  if (which == 2) return k12_attributes<true>(dtype, pattern, smem, dyn, regs);
  if (which == 3)
    return k12_attributes<false>(dtype, pattern, smem, dyn, regs);
  if (which == 6 || which == 7) {
    if (dtype != 1)
      return pattern == kPatGeneral ? K6F32::attributes(smem, dyn, regs)
                                    : static_cast<int>(cudaErrorInvalidValue);
    switch (pattern) {
      case kPatGeneral: return K6Tc<kPatGeneral>::attributes(smem, dyn, regs);
      case kPatL2Up: return K6Tc<kPatL2Up>::attributes(smem, dyn, regs);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (which == 4 || which == 5) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (pattern) {
      case kPatGeneral: return k5_attributes<kPatGeneral>(which, smem, dyn, regs);
      case kPatDense: return k5_attributes<kPatDense>(which, smem, dyn, regs);
      case kPatPhase: return k5_attributes<kPatPhase>(which, smem, dyn, regs);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaFuncAttributes attr;
  cudaError_t err;
  if (which == 1)
    err = cudaFuncGetAttributes(&attr, align_kernel);
  else if (dtype == 1)
    err = cudaFuncGetAttributes(&attr, stencil_kernel<__nv_bfloat16>);
  else
    err = cudaFuncGetAttributes(&attr, stencil_kernel<float>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<long long>(attr.sharedSizeBytes);
  *dyn = 0;
  *regs = static_cast<long long>(attr.numRegs);
  return 0;
}

int mmst_stencil_phase_conv(const mmst::StencilArgs* a, void* stream) {
  return stencil_phase(a, stream);
}

int mmst_stencil_phase2_conv(const mmst::StencilArgs* a, void* stream) {
  return stencil_phase2(a, stream, 0);
}

int mmst_stencil_phase2_conv_padcols(const mmst::StencilArgs* a,
                                     void* stream) {
  return stencil_phase2(a, stream, 1);
}

int mmst_stencil_phase2_rgb(const mmst::RgbArgs* a, void* stream) {
  return rgb(a, stream, true);
}

int mmst_stencil_phase2_rgb128(const mmst::RgbArgs* a, void* stream) {
  return rgb(a, stream, false);
}

int mmst_phase_align(const mmst::AlignArgs* a, void* stream) {
  if ((a->tsize != 2 && a->tsize != 4) || a->Cout % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = a->B * a->H * a->W * 4 * a->Cout * a->tsize / 16;
  // A grid-stride loop over at most 16 blocks per SM of an H100.
  const long long blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(
      blocks < 1 ? 1 : (blocks < 132 * 16 ? blocks : 132 * 16));
  align_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
