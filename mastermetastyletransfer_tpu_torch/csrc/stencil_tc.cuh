// The stencil body of the decoder's phase-space kernels on Hopper: K5's
// bf16 entry (mmst_stencil_phase_conv), and both K6 entries
// (mmst_stencil_phase2_conv, mmst_stencil_phase2_conv_padcols) and both K12
// entries (mmst_stencil_phase2_rgb, mmst_stencil_phase2_rgb128) at either
// type. phase_conv.cu has the function they compute; this file has how.
//
// A thread block owns a tile of 8 x 16 coarse output pixels of one image
// and, for every one of the G output groups, the same slice of BN output
// channels (K5: G = 4, BN = 64 or 32 of C' = 128, 64 or 32; K6: G = 16, BN
// = 16 of C' = 32 at bf16, 8 at f32; K12: G = 16, one 8-lane slot, C' <=
// 8). For each input chunk c with a nonzero block, one stage_k-deep slice
// of the chunk at a time (32 or 16 channels), it
// copies the tile's (8 + 2) x (16 + 2) halo window of that slice into
// shared memory once, with the weight rows of every (group, tap) pair
// whose bit tap * nchunks + c is set, and applies all those pairs to the
// one staged slice. The A operand of pair (g, tap) is the staged window
// shifted by (oy_g + dy, ox_g + dx): ldmatrix takes one row address per
// lane, so the shift is only an address. Zero blocks are never read nor
// multiplied. The host (ops/phase_conv.py:stencil_plan) lists each chunk's
// pairs by group and then tap; the kernel keeps a chunk's pairs as the
// bits 4 g + tap of one word, so pair (g, tap) is at slot popc(bits below
// its own).
//
// bf16: the products on the tensor cores, mma.sync m16n8k16 (bf16 x bf16
// -> f32; bf16 products are exact in f32, so only the order of the sums
// differs from the plain version). The accumulators' group index is known
// at compile time everywhere: a group chosen at run time, or a run-time
// test around a compile-time (group, tap) pair, is if-converted by the
// compiler into one predicated HMMA per group, most of them idle. The
// decoder's tables are compiled in (kPat* below): their pairs, shifts and
// slots are constants and each 16-channel step is straight-line code, K5
// sharing a shift's A fragments among the pairs at it; warp (wm, wn) owns
// WM tile rows (an m16 tile is one row of 16 pixels) and WN n8 tiles of
// every group (K5: two rows, 32 or 16 channels; K6: one row, 16 channels,
// 128 accumulators as K5's; K12: one row, its 8-lane slot). Any other table
// loops over each group's taps at run time (K5 and K6 as above; K12 with
// warp w owning groups 2 w and 2 w + 1 over all eight rows, so that a
// pair's B fragment serves eight independent HMMAs), the form whose loop
// control costs K5 as much as its math. f32 (K6 and K12, in 8-lane slots;
// f32 K5 keeps phase_conv.cu's stencil_kernel): the same staging and the
// run-time form, products as f32 FMAs from shared memory, never TF32, a
// thread's four pixels sharing each weight row.
//
// Copies: cp.async (16 bytes, .cg) into a ring of STAGES slices, so the
// math on slice s overlaps the copies of the next STAGES - 1; each thread
// computes its halo pieces' addresses once; the halo past the input's edge
// is zero-filled and feeds no written output. K12 rgb's weight rows (C' = 3
// lanes a group, not 16-byte aligned per group) are staged whole, the raw
// rows of the chunk's taps, and its B fragments read with 16-bit loads;
// the lanes past C' compute values that are never written.
//
// Epilogue: the f32 bias, optional ReLU, one rounding to T, into an output
// tile in shared memory; the aligned form (K5, K6; K12 rgb128, C' = 8) then
// goes out in 16-byte pieces of (B, H, W, G C'), the fine form (K12 rgb) in
// the fine grid's contiguous rows. K6 is bound by these stores (its
// 512-channel output is nearly all of its bytes): a pixel's BN = 16
// channels of a group are one 32-byte sector, two neighbouring threads'
// pieces. K6's padcols form writes (B, H, W + 2, 16 C'): each 16-byte piece
// of a source column of a pad slot goes to that slot too, from the same
// register, so the writer of a source column writes its pad slots and the
// border is an exact copy that needs nothing of other blocks.

#pragma once

#include <type_traits>

#include "mma_common.cuh"
#include "window_common.cuh"

namespace mmst {

// Mirrors TilePlan in ops/phase_conv.py field for field.
struct TilePlan {
  long long tile_h, tile_w;  // coarse output pixels per block
  long long bn;              // output channels of each group per block
  long long stage_k;         // input channels per pipeline stage
  long long stages;          // slices in the ring
  long long blocks;          // grid size
  long long smem_bytes;      // dynamic shared memory per block
  long long max_pairs;       // B slots per stage
  long long nused;           // chunks with a nonzero block
  long long pattern;         // kPatGeneral or a compiled table
  unsigned char used[16];    // those chunks, in order
  unsigned char npairs[16];  // per chunk: its (group, tap) pairs
  unsigned char pairs[16][64];  // per chunk, per slot: g | tap << 4
};

}  // namespace mmst

namespace {

// The decoder's tables, whose pairs the body knows at compile time (bits
// 4 g + tap of a chunk's word; ops/phase_conv.py holds the same constants
// and tests/test_torch_stencil_plan.py checks them against ops/conv.py):
//   kPatDense  every (group, tap) pair in each used chunk (K5's upsample
//              kernel; K12's JAX tables, nchunks 1);
//   kPatPhase  K5's L1 phase-space kernel, nine pairs in each of 4 chunks
//              (ops/conv.py:_phase_space_table);
//   kPatRgb    K12's L2 RGB kernel, nine pairs in each of 16 chunks
//              (ops/conv.py:_phase2_table(False));
//   kPatL2Up   K6's L2 up-conv kernel, one tap of every group in each of 4
//              chunks (ops/conv.py:_phase2_table(True)).
// In all of them group g reads at (g / 2, g % 2) for G = 4 and at the align
// bases (0, 1, 1, 1): (min(g / 4, 1), min(g % 4, 1)) for G = 16.
constexpr int kPatGeneral = 0, kPatDense = 1, kPatPhase = 2, kPatRgb = 3,
              kPatL2Up = 4;
constexpr unsigned long long kL2UpBits[4] = {
    0x8448211221128448, 0x4444111111114444, 0x2112211221122112,
    0x1111111111111111};
constexpr unsigned long long kPhaseBits[4] = {0xfac8, 0x5f4c, 0x32fa, 0x135f};
constexpr unsigned long long kRgbBits[16] = {
    0x8048000020128048, 0x0448000001120448, 0x4440000011104440,
    0x4404000011014404, 0x0000201220128048, 0x0000011201120448,
    0x0000111011104440, 0x0000110111014404, 0x2012201220120000,
    0x0112011201120000, 0x1110111011100000, 0x1101110111010000,
    0x2012201200002012, 0x0112011200000112, 0x1110111000001110,
    0x1101110100001101};

template <int G>
__host__ __device__ constexpr unsigned long long dense_bits() {
  return G == 16 ? ~0ull : (1ull << (4 * G)) - 1;
}
template <int G>
__host__ __device__ constexpr int known_oy(int g) {
  return G == 4 ? g / 2 : (g / 4 > 0 ? 1 : 0);
}
template <int G>
__host__ __device__ constexpr int known_ox(int g) {
  return G == 4 ? g % 2 : (g % 4 > 0 ? 1 : 0);
}
// The halo shift 3 sy + sx of pair (g, tap) in a compiled table.
template <int G>
__host__ __device__ constexpr int known_shift(int g, int tap) {
  return (known_oy<G>(g) + tap / 2) * 3 + known_ox<G>(g) + tap % 2;
}
template <int G>
__host__ __device__ constexpr bool any_at(unsigned long long bits, int sh) {
  for (int g = 0; g < G; ++g)
    for (int tap = 0; tap < 4; ++tap)
      if (((bits >> (4 * g + tap)) & 1) && known_shift<G>(g, tap) == sh)
        return true;
  return false;
}
template <int G>
__host__ __device__ constexpr unsigned taps_of(unsigned long long bits) {
  unsigned t = 0;
  for (int g = 0; g < G; ++g) t |= (bits >> (4 * g)) & 15u;
  return t;
}

constexpr int kTileH = 8, kTileW = 16;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloPix = (kTileH + 2) * kHaloW;
constexpr long long kMaxDynSmem = 200 * 1024;

// What the new body needs of one call.
struct TcArgs {
  const void* pp;     // T (B, H+2, W+2, Cin)
  const void* w;      // T (2, 2, Cin, N)
  const float* bias;  // (N)
  void* out;          // T (B, H, W, N) or the fine grid (B, 4H, 4W, cg)
  int B, H, W, Cin, cg, N, chunk, relu;
  int off_y[16], off_x[16];
  // K6 padcols: out is (B, H, W + 2, N); slot s of the left (right) border
  // copies column left_src[s] (right_src[s]) at column phase left_ph[s]
  // (right_ph[s]).
  int padcols;
  int left_src[4], left_ph[4], right_src[4], right_ph[4];
  mmst::TilePlan plan;
};

// Elements of a staged row: the A row (one halo pixel) and the B row (one
// input channel of one pair) are padded by 16 bytes where ldmatrix reads
// eight of them at once, so that the eight rows hit distinct banks; so is
// the output tile's row (one pixel of every group's slice).
template <typename T>
__host__ __device__ constexpr int a_stride(int sk) {
  return sk + 16 / static_cast<int>(sizeof(T));
}
template <typename T, int BN>
__host__ __device__ constexpr int b_stride() {
  return BN + ((sizeof(T) == 2 && BN >= 16) ? 8 : 0);
}
template <typename T, int G, int BN>
__host__ __device__ constexpr int o_stride() {
  return G * BN + 16 / static_cast<int>(sizeof(T));
}
__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}

// Dynamic shared memory of one block: the ring, or the output tile where
// that is larger (it reuses the ring after the last stage). A stage's
// weights are max_pairs slots of BN lanes, or, for K12 rgb (cg < BN), the
// rows of up to four taps, all N lanes.
// ops/phase_conv.py:stencil_plan computes the same.
template <typename T, int G, int BN, int STAGES, bool kFine>
long long tc_smem_bytes(long long sk, long long max_pairs, long long cg) {
  const long long es = static_cast<long long>(sizeof(T));
  const long long b_elems = cg >= BN ? max_pairs * sk * b_stride<T, BN>()
                                     : 4LL * sk * G * cg;
  const long long ring =
      STAGES * (kHaloPix * a_stride<T>(static_cast<int>(sk)) + b_elems) * es;
  const long long tile =
      kFine ? 16LL * kTileH * kTileW * cg * es
            : 1LL * kTileH * kTileW * o_stride<T, G, BN>() * es;
  return ring > tile ? ring : tile;
}

__host__ __device__ constexpr int popc64(unsigned long long v) {
  return v ? static_cast<int>(v & 1) + popc64(v >> 1) : 0;
}

__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(lo)) |
         static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(hi))
             << 16;
}

// The tap of rank ti among the set bits of taps.
__device__ __forceinline__ int tap_at(unsigned taps, int ti) {
  for (; ti > 0; --ti) taps &= taps - 1;
  return __ffs(taps) - 1;
}

template <typename T, int G, int BN, int WARPS_M, int WARPS_N, int STAGES,
          int MINB, bool kFine, int PAT>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, MINB)
    tc_stencil_kernel(const __grid_constant__ TcArgs a) {
  constexpr int NT = WARPS_M * WARPS_N * 32;  // threads
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per 16 bytes
  constexpr int LVEC = ilog2(VEC);
  constexpr int WM = kTileH / WARPS_M;      // m16 tiles (rows) per warp
  constexpr int WN = BN / WARPS_N / 8;      // n8 tiles per group per warp
  constexpr int BST = b_stride<T, BN>();
  constexpr int OST = o_stride<T, G, BN>();
  constexpr int LVPR = ilog2(BN / VEC);     // 16-byte pieces per B row
  // A pieces a thread copies per stage (stage_k <= 32).
  constexpr int kAMax = (kHaloPix * 32 / VEC + NT - 1) / NT;
  static_assert(kMma || (G == 16 && BN == 8), "f32: 16 groups, 8 lanes");
  static_assert(!kMma || WN == 1 || WN % 2 == 0, "n8 tiles in pairs");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_pairs_w[16 * 64 / 4];  // per chunk, slot: g | tap << 4
  // Per chunk, bit 4 g + tap for each (group, tap) pair; the slots run in
  // that order, so pair (g, tap) is at slot popc(bits below its bit).
  __shared__ unsigned long long s_bits[16];
  __shared__ unsigned char s_used[16], s_npairs[16];
  const unsigned char* s_pairs =
      reinterpret_cast<const unsigned char*>(s_pairs_w);

  const int tid = threadIdx.x;
  for (int i = tid; i < 16 * 64 / 4; i += NT)
    s_pairs_w[i] = reinterpret_cast<const unsigned*>(&a.plan.pairs[0][0])[i];
  if (tid < 16) {
    s_used[tid] = a.plan.used[tid];
    s_npairs[tid] = a.plan.npairs[tid];
  }
  __syncthreads();
  if (tid < 16) {
    unsigned long long bits = 0;
    for (int slot = 0; slot < s_npairs[tid]; ++slot) {
      const int pr = s_pairs[tid * 64 + slot];
      bits |= 1ull << (4 * (pr & 15) + (pr >> 4));
    }
    s_bits[tid] = bits;
  }
  __syncthreads();

  const int H = a.H, W = a.W, Cin = a.Cin, N = a.N, cg = a.cg;
  const int chunk = a.chunk, relu = a.relu;
  const float* bias = a.bias;
  const int sk = static_cast<int>(a.plan.stage_k);  // 16 or 32
  const int lsk = sk == 32 ? 5 : 4;
  // K12 rgb: weight rows of cg < 8 lanes a group are not 16-byte aligned
  // per group; the stage holds the whole rows of its taps instead of
  // slots.
  const bool raw_b = G == 16 && cg < BN;
  const int AST = a_stride<T>(sk);
  const int a_stage = kHaloPix * AST;
  const int b_stage = raw_b ? 4 * sk * N
                            : static_cast<int>(a.plan.max_pairs) * sk * BST;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + STAGES * a_stage;
  const T* wt = static_cast<const T*>(a.w);

  // This block: channel slice n0 of every group (fastest, so that the
  // slices of one tile run side by side and share its halo in L2), then
  // the tile, row-major over the image, then the image.
  const int nsplit = (cg + BN - 1) / BN;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  int bid = blockIdx.x;
  const int n0 = (bid % nsplit) * BN;
  bid /= nsplit;
  const int j0 = (bid % tiles_x) * kTileW;
  bid /= tiles_x;
  const int i0 = (bid % tiles_y) * kTileH;
  const int b = bid / tiles_y;
  const T* ppb = static_cast<const T*>(a.pp) +
                 static_cast<long long>(b) * (H + 2) * (W + 2) * Cin;

  // The halo pieces this thread copies every stage: source offset in the
  // image (-1 past its edge: zero-filled) and destination in the slice.
  const int lvpp = lsk - LVEC;
  int a_src[kAMax], a_dst[kAMax];
#pragma unroll
  for (int j = 0; j < kAMax; ++j) {
    const int i = tid + j * NT;
    a_dst[j] = -1;
    a_src[j] = -1;
    if (i < (kHaloPix << lvpp)) {
      const int pix = i >> lvpp, v = i & ((1 << lvpp) - 1);
      const int hy = pix / kHaloW, hx = pix - hy * kHaloW;
      const int gy = i0 + hy, gx = j0 + hx;
      a_dst[j] = pix * AST + v * VEC;
      if (gy < H + 2 && gx < W + 2)
        a_src[j] = (gy * (W + 2) + gx) * Cin + v * VEC;
    }
  }

  const int per_chunk = chunk >> lsk;
  const int nst = static_cast<int>(a.plan.nused) * per_chunk;
  auto stage_chunk = [&](int s) { return s_used[s / per_chunk]; };
  auto stage_k0 = [&](int s) {
    return stage_chunk(s) * chunk + (s % per_chunk) * sk;
  };
  // The taps any group uses in chunk c.
  auto chunk_taps = [&](int c) {
    unsigned taps = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) taps |= (s_bits[c] >> (4 * g)) & 15u;
    return taps;
  };

  // Stage s's halo slice and weight rows into ring slot buf, as one
  // cp.async group.
  auto issue = [&](int s, int buf) {
    const int c = stage_chunk(s), k0 = stage_k0(s);
    T* A = As + buf * a_stage;
#pragma unroll
    for (int j = 0; j < kAMax; ++j)
      if (a_dst[j] >= 0)
        cp_async16(A + a_dst[j], ppb + (a_src[j] >= 0 ? a_src[j] + k0 : 0),
                   a_src[j] >= 0);
    T* Bt = Bs + buf * b_stage;
    if (!raw_b) {
      // Slot p, row k: the BN channels n0.. of its group at its tap.
      const int total = s_npairs[c] << (lsk + LVPR);
      for (int i = tid; i < total; i += NT) {
        const int v = i & ((1 << LVPR) - 1), row = i >> LVPR;
        const int pr = s_pairs[c * 64 + (row >> lsk)];
        const T* src = wt + ((pr >> 4) * Cin + k0 + (row & (sk - 1))) * N +
                       (pr & 15) * cg + n0 + v * VEC;
        cp_async16(Bt + row * BST + v * VEC, src, true);
      }
    } else {
      // Tap index ti (the rank of the tap among those any group uses), row
      // k: all N lanes.
      const unsigned taps = chunk_taps(c);
      const int ppr = N / VEC;
      const int total = __popc(taps) * sk * ppr;
      for (int i = tid; i < total; i += NT) {
        const int row = i / ppr, v = i - row * ppr;
        const T* src = wt + (tap_at(taps, row >> lsk) * Cin + k0 +
                             (row & (sk - 1))) * N + v * VEC;
        cp_async16(Bt + row * N + v * VEC, src, true);
      }
    }
    cp_async_commit();
  };
  const int warp = tid / 32, lane = tid % 32;
  // K5 (G = 4): warp (wm, wn) owns tile rows wm * WM + [0, WM) and
  // channels wn * WN * 8 + [0, WN * 8) of the slice, in every group. K12
  // (G = 16): warp w owns groups 2 w and 2 w + 1, every pixel of the tile
  // (bf16: the eight rows' m16 tiles; f32: a thread's four pixels lane +
  // 32 j).
  constexpr bool kGroupWarps = G == 16 && PAT == kPatGeneral && BN == 8;
  static_assert(!kGroupWarps || NT == 8 * 32, "two groups a warp");
  constexpr int ACC = kGroupWarps ? 64 : WM * G * WN * 4;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  // The read offset 2 oy + ox of each group this thread computes.
  int goff[kGroupWarps ? 2 : G];
#pragma unroll
  for (int i = 0; i < (kGroupWarps ? 2 : G); ++i) {
    const int g = kGroupWarps ? 2 * warp + i : i;
    goff[i] = 2 * a.off_y[g] + a.off_x[g];
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst)
      issue(s, s);
    else
      cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int sn = s + STAGES - 1;
    if (sn < nst)
      issue(sn, sn % STAGES);
    else
      cp_async_commit();
    const int c = stage_chunk(s);
    const T* A = As + (s % STAGES) * a_stage;
    const T* Bt = Bs + (s % STAGES) * b_stage;
    const unsigned long long bits = s_bits[c];
    const unsigned ctaps = chunk_taps(c);  // K12 rgb's weight taps
    auto slot_of = [&](int g, int tap) {
      return __popcll(bits & ((1ull << (4 * g + tap)) - 1ull));
    };
    // K12 rgb: the rank of a tap among the chunk's taps.
    auto tap_rank = [&](int tap) {
      return __popc(ctaps & ((1u << tap) - 1u));
    };
    // One pair's B fragments: BN channels of its slot (ldmatrix.trans), or
    // for K12 rgb the rows of its tap rank ti, with 16-bit loads (lane's n
    // = lane / 4, those past cg repeating lane cg - 1, whose products are
    // never written; k = 2 (lane % 4)).
    auto load_b = [&](uint32_t (&bf)[WN][2], int g, int slot, int ti, int kb,
                      bool raw) {
      if constexpr (WN == 1) {
        if (raw) {
          const T* br = Bt + (ti * sk + kb + 2 * (lane & 3)) * N + g * cg +
                        min(lane >> 2, cg - 1);
          if constexpr (kMma) {
            bf[0][0] = pack_bf16(br, br + N);
            bf[0][1] = pack_bf16(br + 8 * N, br + 9 * N);
          }
        } else {
          ldsm_x2_trans(bf[0][0], bf[0][1],
                        Bt + (slot * sk + kb + (lane & 15)) * BST +
                            wn * WN * 8);
        }
      } else {
        const T* brow =
            Bt + (slot * sk + kb + (lane & 15)) * BST + wn * WN * 8;
#pragma unroll
        for (int nj = 0; nj < WN / 2; ++nj)
          ldsm_x4_trans(bf[2 * nj][0], bf[2 * nj][1], bf[2 * nj + 1][0],
                        bf[2 * nj + 1][1], brow + nj * 16 + (lane >> 4) * 8);
      }
    };
    auto load_a = [&](uint32_t (&af)[WM][4], int sy, int sx, int kb) {
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
        ldsm_x4(af[mi], A + ((wm * WM + mi + sy) * kHaloW + (lane & 15) +
                             sx) * AST + kb + (lane >> 4) * 8);
    };
    auto products = [&](int g, const uint32_t (&af)[WM][4],
                        const uint32_t (&bf)[WN][2]) {
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
#pragma unroll
        for (int ni = 0; ni < WN; ++ni)
          mma_bf16(&acc[((mi * G + g) * WN + ni) * 4], af[mi], bf[ni][0],
                   bf[ni][1]);
    };
    if constexpr (kMma && PAT != kPatGeneral) {
      // A compiled table: every pair, its shift and its slot are
      // constants, each 16-channel step straight-line code, and the A
      // fragments of one shift serve every pair at that shift.
      auto known_as = [&](auto table_bits, auto raw_rows) {
        constexpr unsigned long long PB = decltype(table_bits)::value;
        constexpr unsigned CT = taps_of<G>(PB);
        constexpr bool kRaw = decltype(raw_rows)::value;
#pragma unroll 1
        for (int kb = 0; kb < sk; kb += 16) {
          auto pair = [&](int g, int tap, const uint32_t (&af)[WM][4]) {
            uint32_t bf[WN][2];
            load_b(bf, g, popc64(PB & ((1ull << (4 * g + tap)) - 1)),
                   popc64(CT & ((1u << tap) - 1u)), kb, kRaw);
            products(g, af, bf);
          };
          if constexpr (G == 4 || PAT == kPatL2Up) {
            // K5, K6: the A fragments of a shift serve every pair at it.
#pragma unroll
            for (int sh = 0; sh < 9; ++sh) {
              if (!any_at<G>(PB, sh)) continue;
              uint32_t af[WM][4];
              load_a(af, sh / 3, sh % 3, kb);
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int tap = 0; tap < 4; ++tap)
                  if (((PB >> (4 * g + tap)) & 1) &&
                      known_shift<G>(g, tap) == sh)
                    pair(g, tap, af);
            }
          } else {
            // K12 (light math, 64 (group, tap) pairs to compile): pair by
            // pair.
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int tap = 0; tap < 4; ++tap)
                if ((PB >> (4 * g + tap)) & 1) {
                  uint32_t af[WM][4];
                  load_a(af, known_oy<G>(g) + tap / 2,
                         known_ox<G>(g) + tap % 2, kb);
                  pair(g, tap, af);
                }
          }
        }
      };
      // K12 rgb's raw weight rows or the slots: decided once, so that each
      // form is straight-line code.
      auto known = [&](auto table_bits) {
        if (raw_b)
          known_as(table_bits, std::true_type());
        else
          known_as(table_bits, std::false_type());
      };
      if constexpr (PAT == kPatDense) {
        known(std::integral_constant<unsigned long long, dense_bits<G>()>());
      } else if constexpr (PAT == kPatPhase) {
        switch (c) {
          case 0:
            known(std::integral_constant<unsigned long long, kPhaseBits[0]>());
            break;
          case 1:
            known(std::integral_constant<unsigned long long, kPhaseBits[1]>());
            break;
          case 2:
            known(std::integral_constant<unsigned long long, kPhaseBits[2]>());
            break;
          default:
            known(std::integral_constant<unsigned long long, kPhaseBits[3]>());
        }
      } else if constexpr (PAT == kPatL2Up) {
        switch (c) {
          case 0:
            known(std::integral_constant<unsigned long long, kL2UpBits[0]>());
            break;
          case 1:
            known(std::integral_constant<unsigned long long, kL2UpBits[1]>());
            break;
          case 2:
            known(std::integral_constant<unsigned long long, kL2UpBits[2]>());
            break;
          default:
            known(std::integral_constant<unsigned long long, kL2UpBits[3]>());
        }
      } else {
        static_assert(PAT == kPatRgb, "a compiled table");
        switch (c) {
#define MMST_RGB_CHUNK(i)                                                   \
  case i:                                                                   \
    known(std::integral_constant<unsigned long long, kRgbBits[i]>());       \
    break;
          MMST_RGB_CHUNK(0) MMST_RGB_CHUNK(1) MMST_RGB_CHUNK(2)
          MMST_RGB_CHUNK(3) MMST_RGB_CHUNK(4) MMST_RGB_CHUNK(5)
          MMST_RGB_CHUNK(6) MMST_RGB_CHUNK(7) MMST_RGB_CHUNK(8)
          MMST_RGB_CHUNK(9) MMST_RGB_CHUNK(10) MMST_RGB_CHUNK(11)
          MMST_RGB_CHUNK(12) MMST_RGB_CHUNK(13) MMST_RGB_CHUNK(14)
          default:
            known(std::integral_constant<unsigned long long, kRgbBits[15]>());
#undef MMST_RGB_CHUNK
        }
      }
    } else if constexpr (kMma && !kGroupWarps) {
      // K5 and K6, any other table: group by group (the accumulators' index
      // fixed at compile time), each group's taps in a loop, so that every
      // HMMA a warp issues is one of the table's nonzero blocks.
#pragma unroll 1
      for (int kb = 0; kb < sk; kb += 16)
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll 1
          for (unsigned m = (bits >> (4 * g)) & 15u; m; m &= m - 1) {
            const int tap = __ffs(m) - 1;
            uint32_t af[WM][4], bf[WN][2];
            load_a(af, goff[g] / 2 + (tap >> 1), goff[g] % 2 + (tap & 1), kb);
            load_b(bf, g, slot_of(g, tap), 0, kb, false);
            products(g, af, bf);
          }
    } else if constexpr (kMma) {
      // K12 at bf16: this warp's two groups over all eight tile rows; a
      // pair's B fragment serves eight independent products.
#pragma unroll 1
      for (int kb = 0; kb < sk; kb += 16) {
#pragma unroll
        for (int gi = 0; gi < 2; ++gi) {
          const int g = 2 * warp + gi;
#pragma unroll 1
          for (unsigned m = (bits >> (4 * g)) & 15u; m; m &= m - 1) {
            const int tap = __ffs(m) - 1;
            const int sy = goff[gi] / 2 + (tap >> 1);
            const int sx = goff[gi] % 2 + (tap & 1);
            uint32_t bf[WN][2];  // WN = 1
            load_b(bf, g, slot_of(g, tap), tap_rank(tap), kb, raw_b);
#pragma unroll
            for (int r = 0; r < kTileH; ++r) {
              uint32_t af[4];
              ldsm_x4(af, A + ((r + sy) * kHaloW + (lane & 15) + sx) * AST +
                              kb + (lane >> 4) * 8);
              mma_bf16(&acc[(gi * kTileH + r) * 4], af, bf[0][0], bf[0][1]);
            }
          }
        }
      }
    } else {
      // K12 at f32: this warp's two groups; a thread's four pixels
      // lane + 32 j share each weight row, of which the first NL lanes
      // are summed (4 where cg <= 4: rgb's three).
      const float* Af = reinterpret_cast<const float*>(A);
      const float* Bf = reinterpret_cast<const float*>(Bt);
      auto run = [&](auto lanes) {
        constexpr int NL = decltype(lanes)::value;
#pragma unroll
        for (int gi = 0; gi < 2; ++gi) {
          const int g = 2 * warp + gi;
#pragma unroll 1
          for (unsigned m = (bits >> (4 * g)) & 15u; m; m &= m - 1) {
            const int tap = __ffs(m) - 1;
            const float* a0 =
                Af + ((lane / kTileW + goff[gi] / 2 + (tap >> 1)) * kHaloW +
                      lane % kTileW + goff[gi] % 2 + (tap & 1)) * AST;
            const float* brow;
            int bstep;
            if (raw_b) {
              brow = Bf + tap_rank(tap) * sk * N + g * cg;
              bstep = N;
            } else {
              brow = Bf + slot_of(g, tap) * sk * BST;
              bstep = BST;
            }
#pragma unroll 1
            for (int k = 0; k < sk; k += 4) {
              float xa[4][4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                // pixel lane + 32 j: two tile rows further per j
                const float4 x = *reinterpret_cast<const float4*>(
                    a0 + 2 * j * kHaloW * AST + k);
                xa[j][0] = x.x, xa[j][1] = x.y, xa[j][2] = x.z;
                xa[j][3] = x.w;
              }
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const float* br = brow + (k + kk) * bstep;
                float bv[NL];
                if (raw_b) {
#pragma unroll
                  for (int n = 0; n < NL; ++n) bv[n] = n < cg ? br[n] : 0.f;
                } else {
#pragma unroll
                  for (int q = 0; q < NL / 4; ++q) {
                    const float4 p = *reinterpret_cast<const float4*>(
                        br + 4 * q);
                    bv[4 * q] = p.x, bv[4 * q + 1] = p.y;
                    bv[4 * q + 2] = p.z, bv[4 * q + 3] = p.w;
                  }
                }
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                  for (int n = 0; n < NL; ++n)
                    acc[(gi * 4 + j) * 8 + n] =
                        fmaf(xa[j][kk], bv[n], acc[(gi * 4 + j) * 8 + n]);
              }
            }
          }
        }
      };
      if (cg <= 4)
        run(std::integral_constant<int, 4>());
      else
        run(std::integral_constant<int, 8>());
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: bias, ReLU, one rounding, into the output tile in shared
  // memory (the ring's space); then the tile goes out in 16-byte pieces
  // (aligned form) or in contiguous fine rows (fine form).
  T* tile = As;
  auto put = [&](int y, int x, int g, int n, float v) {
    v += bias[g * cg + n];
    if (relu) v = fmaxf(v, 0.f);
    if (kFine)
      tile[((4 * y + g / 4) * 4 * kTileW + 4 * x + g % 4) * cg + n] =
          from_f<T>(v);
    else
      tile[(y * kTileW + x) * OST + g * BN + n - n0] = from_f<T>(v);
  };
  if constexpr (kMma && !kGroupWarps) {
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int ni = 0; ni < WN; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int y = wm * WM + mi, x = lane / 4 + 8 * h;
            const int n = n0 + (wn * WN + ni) * 8 + (lane % 4) * 2;
            const float* d = &acc[((mi * G + g) * WN + ni) * 4 + 2 * h];
            if (!kFine || n < cg) put(y, x, g, n, d[0]);
            if (!kFine || n + 1 < cg) put(y, x, g, n + 1, d[1]);
          }
  } else if constexpr (kMma) {
#pragma unroll
    for (int gi = 0; gi < 2; ++gi)
#pragma unroll
      for (int r = 0; r < kTileH; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = lane / 4 + 8 * h, n = (lane % 4) * 2;
          const float* d = &acc[(gi * kTileH + r) * 4 + 2 * h];
          if (!kFine || n < cg) put(r, x, 2 * warp + gi, n, d[0]);
          if (!kFine || n + 1 < cg) put(r, x, 2 * warp + gi, n + 1, d[1]);
        }
  } else {
#pragma unroll
    for (int gi = 0; gi < 2; ++gi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (!kFine || n < cg)
            put(lane / kTileW + 2 * j, lane % kTileW, 2 * warp + gi, n0 + n,
                acc[(gi * 4 + j) * 8 + n]);
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  const int th = min(kTileH, H - i0), tw = min(kTileW, W - j0);
  if (kFine) {
    // The tile's fine rows, each 4 tw cg contiguous elements of out, in
    // 16-byte pieces where the rows allow.
    const int row_len = 4 * tw * cg;
    const long long row0 = (static_cast<long long>(b) * 4 * H + 4 * i0) * 4 * W;
    if ((4 * W * cg) % VEC == 0 && row_len % VEC == 0) {
      const int vrow = row_len / VEC;
      for (int i = tid; i < 4 * th * vrow; i += NT) {
        const int fy = i / vrow, e = (i - fy * vrow) * VEC;
        *reinterpret_cast<uint4*>(out + (row0 + fy * 4 * W + 4 * j0) * cg +
                                  e) =
            *reinterpret_cast<const uint4*>(tile + fy * 4 * kTileW * cg + e);
      }
    } else {
      for (int i = tid; i < 4 * th * row_len; i += NT) {
        const int fy = i / row_len, e = i - fy * row_len;
        out[(row0 + fy * 4 * W + 4 * j0) * cg + e] =
            tile[fy * 4 * kTileW * cg + e];
      }
    }
  } else {
    // Per pixel, every group's BN channels: G * BN / VEC pieces; with pad
    // columns, a source column's pieces to its pad slots too.
    constexpr int LPG = LVPR;  // pieces per group, log2
    constexpr int LPP = ilog2(G) + LPG;
    const int pad = a.padcols, Wo = W + 2 * pad;
    for (int i = tid; i < (kTileH * kTileW) << LPP; i += NT) {
      const int pix = i >> LPP, q = i & ((1 << LPP) - 1);
      const int y = pix / kTileW, x = pix % kTileW;
      if (y >= th || x >= tw) continue;
      const int g = q >> LPG, v = q & ((1 << LPG) - 1);
      const uint4 val = *reinterpret_cast<const uint4*>(tile + pix * OST +
                                                        g * BN + v * VEC);
      const long long row = (static_cast<long long>(b) * H + i0 + y) * Wo;
      const int xg = j0 + x, ch = n0 + v * VEC;
      *reinterpret_cast<uint4*>(out + (row + xg + pad) * N + g * cg + ch) =
          val;
      if (pad) {
        const int slot0 = 4 * (g >> 2) * cg + ch, ph = g & 3;
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {
          if (a.left_src[sl] == xg && a.left_ph[sl] == ph)
            *reinterpret_cast<uint4*>(out + row * N + slot0 + sl * cg) = val;
          if (a.right_src[sl] == xg && a.right_ph[sl] == ph)
            *reinterpret_cast<uint4*>(out + (row + Wo - 1) * N + slot0 +
                                      sl * cg) = val;
        }
      }
    }
  }
}

}  // namespace
