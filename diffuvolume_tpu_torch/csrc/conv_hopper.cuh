// The bf16 convs on channels-last volumes, built for the H100:
//   conv_s1    the stride-1 3×3×3 conv (csrc/conv3d_fold.cu, rows 5, 6, 14,
//              15) and the dilated 3×3 2-D conv (csrc/conv2d_flat.cu, row
//              18), one kernel: the 2-D conv is its one-plane member;
//   conv_bf16  the stride-2 3×3×3 conv and the stride-2 transposed conv (k3
//              s2 p1 op1, k4 s2 p1 op0): csrc/conv3d_fold.cu (stride 2) and
//              csrc/conv3d_up.cu.
// The float32 forms stay the plain FMA kernels of conv_igemm.cuh
// (direct_f32) and conv2d_flat.cu (conv2d_f32).
//
// GEMM view.  A block owns M_TILE GEMM rows and BN output channels, with
// float32 accumulators in registers.  Two tensor-core forms:
//   mma.sync  8 warps stand WM along M by WN along N; each holds MT 16-row
//             tiles × BN/WN channels (bf16 m16n8k16, A and B from shared
//             memory by ldmatrix).  Every C_out tile width (16 … 128).
//   wgmma     BN 64 (stride 1 also 128, as two 64-channel halves of B, two
//             products a k-step): the 8 warps are 2 warpgroups, each warp holds MT
//             16-row tiles × all 64 channels; a warpgroup multiplies 64 rows
//             at a time (m64n64k16), A from registers (ldmatrix from the
//             strip, as above), B straight from shared memory, where the
//             copy writes the weights in the 128-byte swizzled layout
//             (8 channels' 16-byte chunk c of input channel k stored at
//             chunk c ^ (k mod 8)) that the descriptor names.  One
//             wgmma group a stage, waited for before the slot is refilled.
// The host picks the form (plan(), tc); the tile plan, grid and ring are the
// same for both, so the two can be timed against each other.
//
// Pipelined K loop.  K runs over stages of (kd tap, row tap, chunk of CK
// input channels); stride 1 stages a plane's rows at once (below).  A stage copies (cp.async, 16 bytes a thread) the input
// strip that the block's rows read for that plane and row, and the weights
// of the stage's taps; a ring of kStages stages stays in flight
// (commit_group / wait_group), so each block overlaps its own copies with
// its products.  A stage is small (the plane and the row are fixed), so
// shared memory stays well under half an SM and two or more blocks share
// one.  Planes in the padding are skipped; rows and columns in the padding
// are zero-filled by the copy.
//
// Stride 2 (conv3d_fold_s2).  The tile is bh output rows × bmw output
// columns (bh·bmw ≤ M_TILE, the rest of the GEMM rows idle), chosen on the
// host for the shape, so a narrow W (39, 78) fills the tile with whole rows.
// Output column o reads inputs 2o−1, 2o, 2o+1: the strip is stored parity
// major, the bmw even inputs 2o then the bmw+1 odd inputs 2o−1, so the three
// kw taps read dense windows (odd[o], even[o], odd[o+1]) and the 8 rows an
// ldmatrix phase reads are consecutive strip rows, an odd multiple of 16
// bytes apart: no bank conflict.  Where the output is too small to fill the
// card (PCW's 128→128 to (6, 12, 39)) the stages are split over blockIdx.y:
// each split writes float32 partial sums, and a second kernel adds them in
// split order, runs the epilogue and rounds once.
//
// Transposed conv (conv3d_fold_up).  Output 2i + q along an axis takes the
// taps (k, δ) = k3: q 0 (1, 0); q 1 (0, +1), (2, 0); k4: q 0 (1, 0),
// (3, −1); q 1 (0, +1), (2, 0), reading input i + δ.  A block owns one output
// H parity ph, a tile of bh × bmw half-resolution positions and both W
// parities of each: every GEMM row is one (position, pw), and a warp holds
// both W parities of its positions, so k3's 1 and 2 kw taps are balanced
// over the warps.  A stage is one (kd, kh) tap of the block's parities: the
// strip is the bh rows i + δh over bmw + 1 (k4: + 2) columns, staged once
// for both W parities, with the weights of that (kd, kh) for every kw.  The
// epilogue writes the tile's bh output rows whole (both W parities side by
// side), so the residual is read and the output written as full lines.  A
// block with all four (h, w) parities would stage each input strip once
// instead of twice, but it reads every weight tap for a quarter of the
// outputs: at 64 positions a block (the accumulators' limit) that weight
// traffic made it slower than one parity a block (measured on an H100).
//
// Stride 1: see conv_s1 below.
//
// Epilogue in float32 (+ bias, + residual, activation, × post_mul), one
// rounding to bfloat16, 8 channels (16 bytes) a thread; C_out must be a
// multiple of 8 (stride 1 also stores a C_out below that one by one).
#pragma once

#include "conv_igemm.cuh"

namespace dv {
namespace hopper {

using igemm::Params;
using igemm::activate;
using igemm::cp_async16;
using igemm::ldsm_x4;
using igemm::ldsm_x2_trans;
using igemm::ldsm_x4_trans;
using igemm::mma_bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- wgmma (sm_90a) ---------------------------------------------------------

// Descriptor of a 64-channel × 16-input-channel B tile at shared address
// `addr` (1024-byte aligned): channels contiguous (MN-major), 128-byte
// swizzle, the second 8 input channels 1024 bytes on (stride byte offset).
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// The same for a 32-channel B tile (64-byte rows: 64-byte swizzle, chunk c of
// input channel k stored at chunk c ^ ((k >> 1) mod 4); the second 8 input
// channels 512 bytes on), at a 512-byte aligned address.
__device__ __forceinline__ uint64_t sw64_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (static_cast<uint64_t>(2) << 62);
}

// Keep the compiler from moving accumulator accesses across the async products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+f"(d[j][k])::"memory");
}

// d[J … J + 7] (this warp's 16 rows of a 64 × 64 float32 tile) += a (16 × 16
// bf16, mma.sync's A fragment) · B (16 × 64 bf16 at descriptor `b`,
// transposed: channels contiguous).  d[J + j][k] is mma.sync's accumulator
// layout for channels 8j … 8j + 7 of the tile.
template <int J, int N>
__device__ __forceinline__ void wgmma_n64(float (&d)[N][4], const unsigned (&a)[4], uint64_t b) {
  static_assert(J + 8 <= N, "a 64-channel product writes 8 accumulator groups");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[J][0]), "+f"(d[J][1]), "+f"(d[J][2]), "+f"(d[J][3]), "+f"(d[J + 1][0]),
        "+f"(d[J + 1][1]), "+f"(d[J + 1][2]), "+f"(d[J + 1][3]), "+f"(d[J + 2][0]),
        "+f"(d[J + 2][1]), "+f"(d[J + 2][2]), "+f"(d[J + 2][3]), "+f"(d[J + 3][0]),
        "+f"(d[J + 3][1]), "+f"(d[J + 3][2]), "+f"(d[J + 3][3]), "+f"(d[J + 4][0]),
        "+f"(d[J + 4][1]), "+f"(d[J + 4][2]), "+f"(d[J + 4][3]), "+f"(d[J + 5][0]),
        "+f"(d[J + 5][1]), "+f"(d[J + 5][2]), "+f"(d[J + 5][3]), "+f"(d[J + 6][0]),
        "+f"(d[J + 6][1]), "+f"(d[J + 6][2]), "+f"(d[J + 6][3]), "+f"(d[J + 7][0]),
        "+f"(d[J + 7][1]), "+f"(d[J + 7][2]), "+f"(d[J + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[J … J + 3] += a · B (16 × 32 bf16 at descriptor `b`), as wgmma_n64.
template <int J, int N>
__device__ __forceinline__ void wgmma_n32(float (&d)[N][4], const unsigned (&a)[4], uint64_t b) {
  static_assert(J + 4 <= N, "a 32-channel product writes 4 accumulator groups");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[J][0]), "+f"(d[J][1]), "+f"(d[J][2]), "+f"(d[J][3]), "+f"(d[J + 1][0]),
        "+f"(d[J + 1][1]), "+f"(d[J + 1][2]), "+f"(d[J + 1][3]), "+f"(d[J + 2][0]),
        "+f"(d[J + 2][1]), "+f"(d[J + 2][2]), "+f"(d[J + 2][3]), "+f"(d[J + 3][0]),
        "+f"(d[J + 3][1]), "+f"(d[J + 3][2]), "+f"(d[J + 3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Every committed wgmma group of this warpgroup but the newest N done.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async's writes (generic proxy) made visible to wgmma's reads (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The tile plan of one launch, chosen on the host (plan()).  Ints only, in
// ops/kernels/_build.py PLAN_KEYS order: it crosses to Python and back as
// int[kPlanInts].
struct Plan {
  int bh, bmw;        // output rows × columns (stride 2) or half-res positions (transposed)
  int nth, ntw, ntn;  // tiles along H, W and C_out
  int splits;         // the K stages split over blockIdx.y (stride 2 only)
  int bn, ck, mt;     // the instantiation: channels a tile, input channels a stage, tiles a warp
  int blocks;         // grid size
  int smem;           // dynamic shared memory a block, bytes
  int per_sm;         // blocks an SM at that shared memory and the kernel's registers
  int pos;            // positions a block's GEMM rows hold (bh·bmw of them real)
  int wg;             // 1: the wgmma form, 0: mma.sync
  int kh;             // row taps a stage: 3 (stride 1, the plane's whole strip) or 1
};
constexpr int kPlanInts = sizeof(Plan) / sizeof(int);

// The tensor-core form a plan may take (tc): the host's choice, or forced.
enum TensorCores { kTcAuto = -1, kTcMma = 0, kTcWgmma = 1 };

// The transposed conv's taps along one axis for output parity q: (k, δ).
__host__ __device__ __forceinline__ int up_ntaps(int ks, int q) { return ks == 4 ? 2 : 1 + q; }
__host__ __device__ __forceinline__ void up_tap(int q, int t, int& k, int& delta) {
  if (q == 0) {
    k = t == 0 ? 1 : 3;
    delta = t == 0 ? 0 : -1;
  } else {
    k = t == 0 ? 0 : 2;
    delta = t == 0 ? 1 : 0;
  }
}

// Geometry of one instantiation.  A stage holds the weights (first: the
// wgmma form wants them 1024-byte aligned), then the input strip.
template <bool UP, int KS, int BN, int CK, int MT, bool WG>
struct Geo {
  static constexpr int WN = !WG && BN >= 64 ? 2 : 1;  // warps along N
  static constexpr int WM = kWarps / WN;              // warps along M
  static constexpr int NW = BN / WN;                  // channels a warp
  static constexpr int N8 = NW / 8;
  static constexpr int M_TILE = WM * MT * 16;   // GEMM rows a block
  static constexpr int POS = UP ? M_TILE / 2 : M_TILE;  // positions a block
  static constexpr int lda = CK + 8;  // strip rows an odd multiple of 16 bytes apart
  static constexpr int ldb = WG ? BN : BN + 8;  // wgmma: unpadded 128-byte swizzled rows
  static constexpr int ldc = BN + 4;
  static constexpr int BTAPS = UP ? KS : 3;  // weight taps a stage holds (the kw taps)
  static constexpr int DW_MIN = KS == 4 ? -1 : 0;
  static constexpr int b_elems = BTAPS * CK * ldb;
  static_assert(!UP || MT % 2 == 0, "a transposed-conv warp holds both W parities of 16 positions");
  static_assert(N8 % 2 == 0, "ldmatrix.x4.trans reads 16 channels");
  static_assert(!WG || BN == 64, "a wgmma B tile is one 128-byte swizzle atom wide");
  __host__ __device__ static int cols(int bmw) { return UP ? bmw + (KS == 4 ? 2 : 1) : 2 * bmw + 1; }
  __host__ __device__ static int a_elems(int bh, int bmw) { return bh * cols(bmw) * lda; }
  __host__ __device__ static int stage_bytes(int bh, int bmw) {
    const int n = (b_elems + a_elems(bh, bmw)) * 2;
    return WG ? (n + 1023) / 1024 * 1024 : n;
  }
  __host__ static int smem(int bh, int bmw) {
    const int pipe = kStages * stage_bytes(bh, bmw);
    const int c = M_TILE * ldc * 4;
    return (pipe > c ? pipe : c) + (WG ? 1024 : 0);  // wgmma: room to align the base
  }
};

// The float32 epilogue of 8 channels at output offset o (post_mul at po),
// rounded once to bf16.
__device__ __forceinline__ void store8(const Params& p, float (&v)[8], size_t o, size_t po,
                                       int co) {
  using bf16 = __nv_bfloat16;
  const bf16* res = static_cast<const bf16*>(p.res);
  const bf16* pm = static_cast<const bf16*>(p.post_mul);
  if (p.bias) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] += p.bias[co + k];
  }
  if (res) {
    const uint4 rv = *reinterpret_cast<const uint4*>(res + o);
    const bf16* rr = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] += __bfloat162float(rr[k]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = activate(v[k], p.act);
  if (pm) {
    const uint4 mv = *reinterpret_cast<const uint4*>(pm + po);
    const bf16* mm = reinterpret_cast<const bf16*>(&mv);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] *= __bfloat162float(mm[k]);
  }
  uint4 ov;
  bf16* oo = reinterpret_cast<bf16*>(&ov);
#pragma unroll
  for (int k = 0; k < 8; ++k) oo[k] = __float2bfloat16(v[k]);
  *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + o) = ov;
}

template <bool UP, int KS, int BN, int CK, int MT, bool WG>
__global__ void __launch_bounds__(kThreads, 2)
    conv_bf16(Params p, int bh, int bmw, int ntw, int ntn, float* ws) {
  using bf16 = __nv_bfloat16;
  using G = Geo<UP, KS, BN, CK, MT, WG>;
  constexpr int N8 = G::N8, lda = G::lda, ldb = G::ldb, ldc = G::ldc;
  constexpr int KQ = CK / 16;  // k16 steps a stage
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (WG) {
    const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
    smem += ((raw + 1023u) & ~1023u) - raw;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / G::WN, wn = warp % G::WN;

  // Block → (C_out tile, [H parity,] W tile, H tile) × split × (b, output plane).
  int bx = blockIdx.x;
  const int n0 = (bx % ntn) * BN;
  bx /= ntn;
  const int ph = UP ? bx & 1 : 0;
  if (UP) bx >>= 1;
  const int w0 = (bx % ntw) * bmw;
  const int h0 = (bx / ntw) * bh;
  const int split = blockIdx.y, splits = gridDim.y;
  const int b = blockIdx.z / p.d_out, dz = blockIdx.z % p.d_out;

  // The input planes this output plane reads: (kd, di), padding skipped.
  int dks[3], dis[3], nd = 0;
  if constexpr (UP) {
    for (int t = 0; t < up_ntaps(KS, dz & 1); ++t) {
      int k, dd;
      up_tap(dz & 1, t, k, dd);
      const int di = dz / 2 + dd;
      if (di >= 0 && di < p.d_in) { dks[nd] = k; dis[nd] = di; ++nd; }
    }
  } else {
    for (int k = 0; k < 3; ++k) {
      const int di = 2 * dz - 1 + k;
      if (di >= 0 && di < p.d_in) { dks[nd] = k; dis[nd] = di; ++nd; }
    }
  }
  const int nh = UP ? up_ntaps(KS, ph) : 3;  // row taps: kh (stride 2) or the parity's
  const int nc = p.cin / CK;
  const int nstage = nd * nh * nc;
  const int s_begin = split * nstage / splits, s_end = (split + 1) * nstage / splits;
  const int ncols = G::cols(bmw);
  const int stage_bytes = G::stage_bytes(bh, bmw);
  const unsigned smem_s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.w);

  auto load = [&](int s, int slot) {
    const int dt = s / (nh * nc), rem = s % (nh * nc);
    const int rt = rem / nc, c0 = (rem % nc) * CK;
    const int kd = dks[dt];
    const bf16* xplane = x + (static_cast<size_t>(b) * p.d_in + dis[dt]) * p.h_in *
                                 static_cast<size_t>(p.w_in) * p.cin + c0;
    bf16* bs = reinterpret_cast<bf16*>(smem + slot * stage_bytes);
    bf16* as = bs + G::b_elems;
    constexpr int vpr = CK / 8;
    int kh = rt, dh = 0;
    if (UP) up_tap(ph, rt, kh, dh);
    for (int i = tid; i < bh * ncols * vpr; i += kThreads) {
      const int v = i % vpr, j = (i / vpr) % ncols, r = i / (vpr * ncols);
      int hi, wi;
      if constexpr (UP) {
        hi = h0 + r + dh;
        wi = w0 + j + G::DW_MIN;
      } else {
        hi = 2 * (h0 + r) - 1 + rt;
        wi = j < bmw ? 2 * (w0 + j) : 2 * (w0 + j - bmw) - 1;
      }
      const bool ok = hi >= 0 && hi < p.h_in && wi >= 0 && wi < p.w_in;
      cp_async16(as + (r * ncols + j) * lda + v * 8,
                 ok ? xplane + (static_cast<size_t>(hi) * p.w_in + wi) * p.cin + v * 8 : x, ok);
    }
    constexpr int nv = BN / 8;
    for (int i = tid; i < G::BTAPS * CK * nv; i += kThreads) {
      const int c = i % nv, k = (i / nv) % CK, t = i / (nv * CK);
      const int tap = (kd * KS + kh) * KS + t;
      const bool ok = n0 + c * 8 < p.cout;
      // wgmma: chunk c of input channel k at chunk c ^ (k mod 8) of its 128-byte row
      const int col = (WG ? c ^ (k & 7) : c) * 8;
      cp_async16(bs + (t * CK + k) * ldb + col,
                 ok ? w + (static_cast<size_t>(tap) * p.cin + c0 + k) * p.cout + n0 + c * 8 : w,
                 ok);
    }
  };

  float acc[MT][N8][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[t][j][k] = 0.f;

  // This lane's ldmatrix row / column, and its A row's strip position for
  // each tile (GEMM rows past the tile's positions read position 0).
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = lane & 15, b_col = (lane >> 4) * 8;
  int arow[MT], am[MT];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    // Transposed conv: tiles 2g and 2g + 1 are W parities 0 and 1 of the
    // warp's g-th 16 positions.
    const int pos = (UP ? wm * (MT / 2) + t / 2 : wm * MT + t) * 16 + a_row;
    const bool real = pos < bh * bmw;
    arow[t] = real ? (pos / bmw) * ncols : 0;
    am[t] = real ? pos % bmw : 0;
  }
  // Shared address of tile t's A row for kw tap kw (stride 2) or W offset dw
  // (transposed).
  auto a_addr = [&](unsigned as_s, int t, int kw_or_dw) -> unsigned {
    const int col = UP ? am[t] + kw_or_dw - G::DW_MIN
                       : kw_or_dw == 1 ? am[t] : bmw + am[t] + (kw_or_dw == 2);
    return as_s + 2 * ((arow[t] + col) * lda + a_col);
  };

  auto compute = [&](int slot) {
    const unsigned bs_s = smem_s + slot * stage_bytes;
    const unsigned as_s = bs_s + G::b_elems * 2;
    if constexpr (WG) {
      // Every A fragment of the stage first, one fence, then the products
      // (B from shared memory), one group, waited for before the slot is
      // refilled.
      constexpr int NT = UP ? 2 : 3;  // kw taps a tile may take
      unsigned fa[MT][NT][KQ][4];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
#pragma unroll
        for (int tt = 0; tt < NT; ++tt) {
          if (UP && tt >= up_ntaps(KS, t & 1)) break;
          int kw = tt, dw = 0;
          if (UP) up_tap(t & 1, tt, kw, dw);
          const unsigned ab = a_addr(as_s, t, UP ? dw : kw);
#pragma unroll
          for (int q = 0; q < KQ; ++q) ldsm_x4(fa[t][tt][q], ab + 32 * q);
        }
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) fence_acc(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < MT; ++t) {
#pragma unroll
        for (int tt = 0; tt < NT; ++tt) {
          if (UP && tt >= up_ntaps(KS, t & 1)) break;
          int kw = tt, dw = 0;
          if (UP) up_tap(t & 1, tt, kw, dw);
#pragma unroll
          for (int q = 0; q < KQ; ++q) {
            wgmma_n64<0>(acc[t], fa[t][tt][q], sw128_desc(bs_s + (kw * CK + 16 * q) * ldb * 2));
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int t = 0; t < MT; ++t) fence_acc(acc[t]);
    } else if constexpr (UP) {
      const unsigned bn_off = wn * G::NW + b_col;
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const int pw = t & 1;
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          if (tt >= up_ntaps(KS, pw)) break;
          int kw, dw;
          up_tap(pw, tt, kw, dw);
          const unsigned ab = a_addr(as_s, t, dw);
          const unsigned bb = bs_s + 2 * ((kw * CK + b_row) * ldb + bn_off);
#pragma unroll
          for (int kk = 0; kk < CK; kk += 16) {
            unsigned fa[4];
            ldsm_x4(fa, ab + 2 * kk);
#pragma unroll
            for (int nb = 0; nb < N8 / 2; ++nb) {
              unsigned fb[4];
              ldsm_x4_trans(fb, bb + 2 * (kk * ldb + nb * 16));
              mma_bf16(acc[t][2 * nb], fa, fb[0], fb[1]);
              mma_bf16(acc[t][2 * nb + 1], fa, fb[2], fb[3]);
            }
          }
        }
      }
    } else {
      const unsigned bn_off = wn * G::NW + b_col;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const unsigned bb = bs_s + 2 * ((kw * CK + b_row) * ldb + bn_off);
        unsigned ab[MT];
#pragma unroll
        for (int t = 0; t < MT; ++t) ab[t] = a_addr(as_s, t, kw);
#pragma unroll
        for (int kk = 0; kk < CK; kk += 16) {
          unsigned fa[MT][4];
#pragma unroll
          for (int t = 0; t < MT; ++t) ldsm_x4(fa[t], ab[t] + 2 * kk);
#pragma unroll
          for (int nb = 0; nb < N8 / 2; ++nb) {
            unsigned fb[4];
            ldsm_x4_trans(fb, bb + 2 * (kk * ldb + nb * 16));
#pragma unroll
            for (int t = 0; t < MT; ++t) {
              mma_bf16(acc[t][2 * nb], fa[t], fb[0], fb[1]);
              mma_bf16(acc[t][2 * nb + 1], fa[t], fb[2], fb[3]);
            }
          }
        }
      }
    }
  };

  // The ring: kStages − 1 stages ahead of the one being multiplied.
  const int ns = s_end - s_begin;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ns) load(s_begin + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<kStages - 2>();
    if constexpr (WG) fence_proxy_async();
    __syncthreads();  // stage i has landed; stage i − 1's slot is free
    if (i + kStages - 1 < ns) load(s_begin + i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    compute(i % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, q = lane & 3;
  const int npos = bh * bmw;
  if (!UP && splits > 1) {  // (stride 2 only)
    // Partial sums straight to the float32 workspace (split, position, C_out).
    const size_t plane_pos = static_cast<size_t>(b * p.d_out + dz) * p.h_out;
    const size_t total = static_cast<size_t>(p.b) * p.d_out * p.h_out * p.w_out;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pos = (wm * MT + t) * 16 + g + 8 * half;
        const int ho = h0 + pos / bmw, wo = w0 + pos % bmw;
        if (pos >= npos || ho >= p.h_out || wo >= p.w_out) continue;
        float* dst = ws + ((split * total) + (plane_pos + ho) * p.w_out + wo) * p.cout;
#pragma unroll
        for (int j = 0; j < N8; ++j) {
          const int co = n0 + wn * G::NW + j * 8 + 2 * q;
          if (co < p.cout) {
            *reinterpret_cast<float2*>(dst + co) =
                make_float2(acc[t][j][2 * half], acc[t][j][2 * half + 1]);
          }
        }
      }
    }
    return;
  }

  // Accumulators → shared memory, by output row and column of the tile.
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = (UP ? wm * (MT / 2) + t / 2 : wm * MT + t) * 16 + g + 8 * half;
      if (pos >= npos) continue;
      // transposed: local output row r of parity ph, column 2m + pw
      const int row = UP ? (pos / bmw) * (2 * bmw) + 2 * (pos % bmw) + (t & 1) : pos;
      float* c = cs + row * ldc + wn * G::NW + 2 * q;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        *reinterpret_cast<float2*>(c + j * 8) = make_float2(acc[t][j][2 * half], acc[t][j][2 * half + 1]);
      }
    }
  }
  __syncthreads();

  // Epilogue, 8 channels a thread; consecutive threads take consecutive
  // channels, then columns: whole output lines.
  constexpr int nvec = BN / 8;
  const int ocols = UP ? 2 * bmw : bmw, ow0 = UP ? 2 * w0 : w0;
  for (int e = tid; e < bh * ocols * nvec; e += kThreads) {
    const int n = (e % nvec) * 8, col = (e / nvec) % ocols, r = e / (nvec * ocols);
    const int co = n0 + n, ho = UP ? 2 * (h0 + r) + ph : h0 + r, wo = ow0 + col;
    if (co >= p.cout || ho >= p.h_out || wo >= p.w_out) continue;
    const float* c = cs + (r * ocols + col) * ldc + n;
    float v[8];
    const float4 c0 = *reinterpret_cast<const float4*>(c);
    const float4 c1 = *reinterpret_cast<const float4*>(c + 4);
    v[0] = c0.x; v[1] = c0.y; v[2] = c0.z; v[3] = c0.w;
    v[4] = c1.x; v[5] = c1.y; v[6] = c1.z; v[7] = c1.w;
    const size_t o =
        (((static_cast<size_t>(b) * p.d_out + dz) * p.h_out + ho) * p.w_out + wo) * p.cout + co;
    const size_t po = ((static_cast<size_t>(b) * p.h_out + ho) * p.w_out + wo) * p.cout + co;
    store8(p, v, o, po, co);
  }
}

// Split-K's second pass: the partial sums added in split order, then the
// epilogue, one rounding; 8 channels a thread.  Static: each source that
// includes this header has its own copy.
static __global__ void splitk_finish(Params p, const float* ws, int splits) {
  const size_t total = static_cast<size_t>(p.b) * p.d_out * p.h_out * p.w_out;
  const int nvec = p.cout / 8;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total * nvec) return;
  const int co = static_cast<int>(e % nvec) * 8;
  const size_t pos = e / nvec;
  const int wo = static_cast<int>(pos % p.w_out);
  const int ho = static_cast<int>((pos / p.w_out) % p.h_out);
  const int b = static_cast<int>(pos / (static_cast<size_t>(p.w_out) * p.h_out * p.d_out));
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const float* src = ws + (s * total + pos) * p.cout + co;
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 c = *reinterpret_cast<const float4*>(src + 4);
    v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
    v[4] += c.x; v[5] += c.y; v[6] += c.z; v[7] += c.w;
  }
  const size_t po = ((static_cast<size_t>(b) * p.h_out + ho) * p.w_out + wo) * p.cout + co;
  store8(p, v, pos * p.cout + co, po, co);
}

// ---- stride 1: the 3×3×3 conv (rows 5, 6, 14, 15) and the dilated 3×3 2-D
// conv (row 18) ---------------------------------------------------------------
//
// Replaces diffuvolume_tpu/ops/pallas/conv3d.py:131 conv3d_packed, :508
// conv3d_fold_p, :1307 conv3d_fold_x2, :301 conv3d_fold (through
// csrc/conv3d_fold.cu) and ops/pallas/conv2d.py:54 conv2d_flat (through
// csrc/conv2d_flat.cu); both files state the bounds at the main path's
// shapes (bf16 tensor-core operations, but for the heads).
//
// One kernel for both: a 2-D conv with dilation d is the stride-1 conv on one
// plane with one kd tap (kdt 1) and its (kh, kw) taps d apart; the 3-D conv
// has kdt 3 and d 1.  Padding d on H and W (1 on D).  PLANE stages are one
// input plane (kd tap) and 16 input channels: the bh + 2d input rows × bmw +
// 2d columns that all nine (kh, kw) taps of the block's bh × bmw outputs
// read, copied once, with the nine taps' weights (each input row is copied
// once a plane, not once a kh tap).  Where no full tile's strip fits that
// ring (the 2-D conv from d 8 at the refinement's shapes) a stage is one kh
// tap and 32 input channels instead: bh rows of bmw + 2d columns, the three
// kw taps' weights.  Tap (kh, kw) of output (r, m) reads strip row r + kh·d
// (one kh a stage: r), column m + kw·d.  C_in past the last chunk (8, 24,
// 40 …) is zero-filled in shared memory.  C_out not a multiple of 8 (C_out
// 1 where conv_s1_head's tile does not fit, 2 … 7): the block copies all
// its weights once, zero-padded to the tile's width, into a region after
// the ring, and stores the real channels one by one.  wgmma at 64, 96 and
// 128 output channels a tile (128: two 64-channel halves of B, two
// m64n64k16 products a k-step; 96: an m64n64k16 and an m64n32k16) and at 32
// on the smaller tiles (m64n32k16); mma.sync at 8 and 16 and at the
// 512-position 32-channel tile (or forced).  Split K: the stages are split
// over blockIdx.y, each split writes float32 partial sums and splitk_finish
// adds them in order and runs the epilogue.
template <int BN, int MT, bool WG, bool PLANE>
struct GeoS1 {
  static constexpr int CK = PLANE ? 16 : 32;          // input channels a stage
  static constexpr int KQ = CK / 16;                  // k16 steps a tap
  static constexpr int WN = !WG && BN >= 64 ? 2 : 1;  // warps along N
  static constexpr int WM = kWarps / WN;
  static constexpr int NW = BN / WN;
  static constexpr int N8 = NW / 8;
  static constexpr int M_TILE = WM * MT * 16;  // positions a block
  // wgmma B: 64-channel atoms (128-byte swizzle); a 32-channel one (64-byte
  // swizzle) at 32 and for channels 64 … 95 of a 96-channel tile
  static constexpr int ldb = WG ? (BN == 32 ? 32 : 64) : BN == 8 ? 24 : BN + 8;
  static constexpr int ldc = BN + 4;
  static constexpr int TAPS = PLANE ? 9 : 3;   // (kh, kw) taps a stage
  static constexpr int b_elems = TAPS * CK * (WG ? BN : ldb);
  // The ring: stages copied PD ahead of the one multiplied.  wgmma with two
  // tiles a warp at 96 and 128 channels (one block an SM) keeps one tile's
  // products in flight across the next stage's barrier, so a slot is
  // refilled two stages after its own: 4.
  static constexpr int PD = 2;
  static constexpr int STAGES = WG && MT == 2 && BN >= 96 ? 4 : 3;
  static_assert(N8 % 2 == 0 || N8 == 1, "ldmatrix.x4.trans reads 16 channels, .x2 8");
  static_assert(!WG || BN == 32 || BN == 96 || BN % 64 == 0, "wgmma B: 32, 96 or 64-channel atoms");
  __host__ __device__ static int rows(int bh, int d) { return PLANE ? bh + 2 * d : bh; }
  __host__ __device__ static int cols(int bmw, int d) { return bmw + 2 * d; }
  // A stage: its weights (none where they are preloaded), then the strip,
  // CK·2 bytes a position.
  __host__ __device__ static int stage_bytes(int bh, int bmw, int d, bool narrow) {
    const int n = ((narrow ? 0 : b_elems) + rows(bh, d) * cols(bmw, d) * CK) * 2;
    return WG ? (n + 1023) / 1024 * 1024 : n;
  }
  // The preloaded weights of a narrow C_out: (chunk, tap, CK, ldb) bf16.
  __host__ __device__ static int narrow_bytes(int kdt, int cin) {
    return (cin + CK - 1) / CK * kdt * 9 * CK * ldb * 2;
  }
  __host__ static int smem(int bh, int bmw, int d, int narrow_w) {
    const int pipe = STAGES * stage_bytes(bh, bmw, d, narrow_w > 0) + narrow_w;
    const int c = M_TILE * ldc * 4;
    return (pipe > c ? pipe : c) + (WG ? 1024 : 0);
  }
};

// The strip's swizzled byte offset of position p, 16-byte chunk c: positions
// CK·2 bytes apart, unpadded, chunk c stored at c ^ ((p >> 2) & 1) (CK 16)
// or c ^ ((p >> 1) & 3) (CK 32), so the 8 consecutive positions an ldmatrix
// phase reads fall in 8 different 16-byte bank groups.
template <int CK>
__device__ __forceinline__ unsigned strip_off(int p, int c) {
  if constexpr (CK == 16) return static_cast<unsigned>(p) * 32u + ((c ^ ((p >> 2) & 1)) << 4);
  return static_cast<unsigned>(p) * 64u + ((c ^ ((p >> 1) & 3)) << 4);
}

// Where a thread's strip copy starts (position cp0: row cr0, column cj0;
// chunk cv) and how it steps (kThreads / (CK / 8) positions: dr rows and dj
// columns), worked out once a block.
struct StripWalk {
  int cv, cp0, cr0, cj0, dr, dj;
  template <int CK>
  __device__ __forceinline__ void init(int tid, int ncols) {
    constexpr int jstep = kThreads / (CK / 8);
    cv = tid % (CK / 8);
    cp0 = tid / (CK / 8);
    cr0 = cp0 / ncols;
    cj0 = cp0 % ncols;
    dr = jstep / ncols;
    dj = jstep % ncols;
  }
};

// One stage's strip: input rows r0 … r0 + nrows − 1, columns wl … wl +
// ncols − 1 of `xplane`, channels c0 … c0 + CK − 1, zero outside the input
// and past C_in, swizzled (strip_off), each thread along its StripWalk.
template <int CK>
__device__ __forceinline__ void copy_strip(unsigned char* as, const __nv_bfloat16* xplane,
                                           const __nv_bfloat16* x, const Params& p, int r0,
                                           int wl, int c0, int nrows, int ncols,
                                           const StripWalk& sw) {
  constexpr int jstep = kThreads / (CK / 8);
  const int ci = c0 + sw.cv * 8;
  const bool cok = ci < p.cin;
  for (int sp = sw.cp0, r = sw.cr0, j = sw.cj0; sp < nrows * ncols; sp += jstep) {
    const int hi = r0 + r, wi = wl + j;
    const bool ok = cok && hi >= 0 && hi < p.h_in && wi >= 0 && wi < p.w_in;
    cp_async16(as + strip_off<CK>(sp, sw.cv),
               ok ? xplane + (static_cast<size_t>(hi) * p.w_in + wi) * p.cin + ci : x, ok);
    r += sw.dr;
    j += sw.dj;
    if (j >= ncols) { j -= ncols; ++r; }
  }
}

// Two blocks an SM (at most 128 registers a thread) but where one fills
// more than half an SM's shared memory: a 128-channel plane stage, or the
// 4-slot ring of wgmma with two tiles a warp at 96 and 128 channels.
template <int BN, int MT, bool WG, bool PLANE, bool TWO_D>
__global__ void __launch_bounds__(kThreads,
                                  (BN == 128 && PLANE) || (WG && MT == 2 && BN >= 96) ? 1 : 2)
    conv_s1(Params p, int bh, int bmw, int ntw, int ntn, int dil, float* ws) {
  constexpr int kdt = TWO_D ? 1 : 3;  // kd taps
  using bf16 = __nv_bfloat16;
  using G = GeoS1<BN, MT, WG, PLANE>;
  constexpr int CK = G::CK, KQ = G::KQ, N8 = G::N8, ldb = G::ldb, ldc = G::ldc;
  constexpr int TAPS = G::TAPS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (WG) {
    const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
    smem += ((raw + 1023u) & ~1023u) - raw;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / G::WN, wn = warp % G::WN;

  // Block → (C_out tile, W tile, H tile) × split × (b, output plane).
  int bx = blockIdx.x;
  const int n0 = (bx % ntn) * BN;
  bx /= ntn;
  const int w0 = (bx % ntw) * bmw;
  const int h0 = (bx / ntw) * bh;
  const int split = blockIdx.y, splits = gridDim.y;
  const int b = blockIdx.z / p.d_out, dz = blockIdx.z % p.d_out;

  // The input planes this output plane reads (kd, di), padding skipped; one
  // kh tap a stage: the taps whose rows are not all padding.
  int dks[3], dis[3], nd = 0;
  for (int k = 0; k < kdt; ++k) {
    const int di = dz + k - (kdt - 1) / 2;
    if (di >= 0 && di < p.d_in) { dks[nd] = k; dis[nd] = di; ++nd; }
  }
  int khs[3] = {0, 1, 2}, nkh = 1;
  if constexpr (!PLANE) {
    const int rr = p.h_out - h0 < bh ? p.h_out - h0 : bh;
    nkh = 0;
    for (int k = 0; k < 3; ++k) {
      const int hi = h0 + (k - 1) * dil;
      if (hi + rr > 0 && hi < p.h_in) khs[nkh++] = k;
    }
  }
  const int nc = (p.cin + CK - 1) / CK;
  const int nstage = nd * nkh * nc;
  const int s_begin = split * nstage / splits, s_end = (split + 1) * nstage / splits;
  const int nrows = G::rows(bh, dil), ncols = G::cols(bmw, dil);
  const bool narrow = !WG && p.cout % 8 != 0;
  const int stage_bytes = G::stage_bytes(bh, bmw, dil, narrow);
  const int wb = narrow ? 0 : G::b_elems;  // a stage's weight elements
  const unsigned smem_s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.w);
  const int nreal = p.cout - n0 < BN ? p.cout - n0 : BN;
  bf16* wall = reinterpret_cast<bf16*>(smem + G::STAGES * stage_bytes);  // narrow: every weight
  if (narrow) {  // zeros (16 bytes a store), then the real columns
    const int ntap = kdt * 9;
    for (int i = tid; i < nc * ntap * CK * ldb / 8; i += kThreads) {
      reinterpret_cast<uint4*>(wall)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < nc * ntap * CK * nreal; i += kThreads) {
      const int n = i % nreal, k = (i / nreal) % CK, t = (i / (nreal * CK)) % ntap;
      const int c = i / (nreal * CK * ntap), ci = c * CK + k;
      if (ci < p.cin) {
        wall[((c * ntap + t) * CK + k) * ldb + n] =
            w[(static_cast<size_t>(t) * p.cin + ci) * p.cout + n0 + n];
      }
    }
  }

  StripWalk sw;  // this thread's part of each strip copy
  sw.init<CK>(tid, ncols);

  // Stage s → (plane, kh tap, chunk): its first weight tap and input channel.
  auto decode = [&](int s, int& dt, int& kh, int& c) {
    dt = s / (nkh * nc);
    const int rem = s % (nkh * nc);
    kh = khs[rem / nc];
    c = rem % nc;
  };

  auto load = [&](int s, int slot) {
    int dt, kh, c;
    decode(s, dt, kh, c);
    const int c0 = c * CK;
    const bf16* xplane = x + (static_cast<size_t>(b) * p.d_in + dis[dt]) * p.h_in *
                                 static_cast<size_t>(p.w_in) * p.cin;
    bf16* bs = reinterpret_cast<bf16*>(smem + slot * stage_bytes);
    unsigned char* as = reinterpret_cast<unsigned char*>(bs + wb);
    copy_strip<CK>(as, xplane, x, p, PLANE ? h0 - dil : h0 + (kh - 1) * dil, w0 - dil, c0,
                   nrows, ncols, sw);
    if (narrow) return;
    const int tap0 = dks[dt] * 9 + (PLANE ? 0 : kh * 3);
    constexpr int nv = BN / 8;
    for (int i = tid; i < TAPS * CK * nv; i += kThreads) {
      const int cc = i % nv, k = (i / nv) % CK, t = i / (nv * CK);
      const bool ok = n0 + cc * 8 < p.cout && c0 + k < p.cin;
      // wgmma: 64-channel half cc / 8, its chunk cc % 8 at chunk (cc % 8) ^ (k mod 8);
      // 32 channels: chunk cc at cc ^ ((k >> 1) mod 4)
      bf16* dst = !WG        ? bs + (t * CK + k) * ldb + cc * 8
                  : BN == 32 ? bs + (t * CK + k) * 32 + ((cc ^ ((k >> 1) & 3)) * 8)
                  : BN == 96 && cc >= 8
                      ? bs + TAPS * CK * 64 + (t * CK + k) * 32 + (((cc - 8) ^ ((k >> 1) & 3)) * 8)
                      : bs + (((cc / 8) * TAPS + t) * CK + k) * 64 + (((cc % 8) ^ (k & 7)) * 8);
      cp_async16(dst,
                 ok ? w + (static_cast<size_t>(tap0 + t) * p.cin + c0 + k) * p.cout + n0 + cc * 8
                    : w,
                 ok);
    }
  };

  float acc[MT][N8][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[t][j][k] = 0.f;

  // This lane's ldmatrix row / chunk, and its A row's strip position (tap
  // (0, 0)) for each tile; GEMM rows past the tile's positions read
  // position 0.  A tap moves the position by kh rows and kw columns of d.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_chunk = lane >> 4;
  const int b_row = lane & 15, b_col = (lane >> 4) * 8;
  int apos[MT];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const int pos = (wm * MT + t) * 16 + a_row;
    const bool real = pos < bh * bmw;
    apos[t] = (real ? pos / bmw : 0) * ncols + (real ? pos % bmw : 0);
  }

  // Stage s in `slot`: A from the slot's strip, B from its weights (narrow:
  // from the preloaded weights at the stage's chunk and taps).
  auto compute = [&](int s, int slot) {
    const unsigned bs_slot = smem_s + slot * stage_bytes;
    const unsigned as_s = bs_slot + wb * 2;
    unsigned bs_s = bs_slot;
    if (narrow) {
      int dt, kh, c;
      decode(s, dt, kh, c);
      bs_s = static_cast<unsigned>(__cvta_generic_to_shared(wall)) +
             ((c * kdt * 9 + dks[dt] * 9 + (PLANE ? 0 : kh * 3)) * CK) * ldb * 2;
    }
    // The positions anew each stage (an empty asm the compiler cannot see
    // through): hoisting every tap's address out of the ring would hold
    // TAPS·MT registers.
    int ap[MT];
    int row_step = ncols * dil, col_step = dil;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      ap[t] = apos[t];
      asm volatile("" : "+r"(ap[t]));
    }
    asm volatile("" : "+r"(row_step), "+r"(col_step));
    if constexpr (WG) {
      // One group a tile: its A fragments (wgmma reads them from registers
      // until the group completes), one fence, its products (B from shared
      // memory).  Before a tile's fragments are reloaded, every group but
      // the newest is waited for, so one tile's products stay in flight
      // across the next one's loads (two tiles, 4 slots: across the next
      // stage's barrier too); with 3 slots the stage's groups are waited for
      // before its slot is refilled.
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        unsigned fa[TAPS][KQ][4];
        if constexpr (MT >= 2) wgmma_wait<1>();
#pragma unroll
        for (int tp = 0; tp < TAPS; ++tp) {
          const int pa = ap[t] + (PLANE ? tp / 3 : 0) * row_step + (tp % 3) * col_step;
#pragma unroll
          for (int q = 0; q < KQ; ++q) ldsm_x4(fa[tp][q], as_s + strip_off<CK>(pa, a_chunk + 2 * q));
        }
        fence_acc(acc[t]);
        wgmma_fence();
#pragma unroll
        for (int tp = 0; tp < TAPS; ++tp) {
#pragma unroll
          for (int q = 0; q < KQ; ++q) {
            if constexpr (BN == 32) {
              wgmma_n32<0>(acc[t], fa[tp][q], sw64_desc(bs_s + (tp * CK + 16 * q) * 32 * 2));
            } else {
              wgmma_n64<0>(acc[t], fa[tp][q], sw128_desc(bs_s + (tp * CK + 16 * q) * 64 * 2));
            }
            if constexpr (BN == 128)
              wgmma_n64<8>(acc[t], fa[tp][q], sw128_desc(bs_s + ((TAPS + tp) * CK + 16 * q) * 64 * 2));
            if constexpr (BN == 96) {
              wgmma_n32<8>(acc[t], fa[tp][q],
                           sw64_desc(bs_s + TAPS * CK * 64 * 2 + (tp * CK + 16 * q) * 32 * 2));
            }
          }
        }
        wgmma_commit();
        fence_acc(acc[t]);
      }
      if constexpr (G::STAGES == 3) wgmma_wait_all();  // the slot is refilled next stage
    } else {
      const unsigned bn_off = wn * G::NW + b_col;
#pragma unroll
      for (int tp = 0; tp < TAPS; ++tp) {
        const unsigned bb = bs_s + 2 * ((tp * CK + b_row) * ldb + bn_off);
        const int toff = (PLANE ? tp / 3 : 0) * row_step + (tp % 3) * col_step;
#pragma unroll
        for (int q = 0; q < KQ; ++q) {
          unsigned fa[MT][4];
#pragma unroll
          for (int t = 0; t < MT; ++t)
            ldsm_x4(fa[t], as_s + strip_off<CK>(ap[t] + toff, a_chunk + 2 * q));
          if constexpr (N8 == 1) {  // 8 channels (C_out below 8)
            unsigned fb[2];
            ldsm_x2_trans(fb, bb + 2 * 16 * q * ldb);
#pragma unroll
            for (int t = 0; t < MT; ++t) mma_bf16(acc[t][0], fa[t], fb[0], fb[1]);
          }
#pragma unroll
          for (int nb = 0; nb < N8 / 2; ++nb) {
            unsigned fb[4];
            ldsm_x4_trans(fb, bb + 2 * (16 * q * ldb + nb * 16));
#pragma unroll
            for (int t = 0; t < MT; ++t) {
              mma_bf16(acc[t][2 * nb], fa[t], fb[0], fb[1]);
              mma_bf16(acc[t][2 * nb + 1], fa[t], fb[2], fb[3]);
            }
          }
        }
      }
    }
  };

  // The ring: PD stages ahead of the one being multiplied.
  constexpr int PD = G::PD, STAGES = G::STAGES;
  const int ns = s_end - s_begin;
#pragma unroll
  for (int i = 0; i < PD; ++i) {
    if (i < ns) load(s_begin + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<PD - 1>();
    if constexpr (WG) fence_proxy_async();
    __syncthreads();  // stage i has landed; slot (i + PD) % STAGES is free
    if (i + PD < ns) load(s_begin + i + PD, (i + PD) % STAGES);
    cp_async_commit();
    compute(s_begin + i, i % STAGES);
  }
  if constexpr (WG) wgmma_wait_all();
  cp_async_wait<0>();
  __syncthreads();
  const int g = lane >> 2, q = lane & 3;
  const int npos = bh * bmw;
  if (splits > 1) {
    // Partial sums straight to the float32 workspace (split, position, C_out).
    const size_t plane_pos = static_cast<size_t>(b * p.d_out + dz) * p.h_out;
    const size_t total = static_cast<size_t>(p.b) * p.d_out * p.h_out * p.w_out;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pos = (wm * MT + t) * 16 + g + 8 * half;
        const int ho = h0 + pos / bmw, wo = w0 + pos % bmw;
        if (pos >= npos || ho >= p.h_out || wo >= p.w_out) continue;
        float* dst = ws + ((split * total) + (plane_pos + ho) * p.w_out + wo) * p.cout;
#pragma unroll
        for (int j = 0; j < N8; ++j) {
          const int co = n0 + wn * G::NW + j * 8 + 2 * q;
          if (co < p.cout) {
            *reinterpret_cast<float2*>(dst + co) =
                make_float2(acc[t][j][2 * half], acc[t][j][2 * half + 1]);
          }
        }
      }
    }
    return;
  }

  // Accumulators → shared memory, by tile position.
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = (wm * MT + t) * 16 + g + 8 * half;
      if (pos >= npos) continue;
      float* c = cs + pos * ldc + wn * G::NW + 2 * q;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        *reinterpret_cast<float2*>(c + j * 8) = make_float2(acc[t][j][2 * half], acc[t][j][2 * half + 1]);
      }
    }
  }
  __syncthreads();

  // Epilogue, 8 channels a thread (one where C_out is not a multiple of 8);
  // consecutive threads take consecutive channels, then columns: whole
  // output lines.
  const int nvec = narrow ? nreal : BN / 8;
  for (int e = tid; e < npos * nvec; e += kThreads) {
    const int n = narrow ? e % nvec : (e % nvec) * 8, pos = e / nvec;
    const int co = n0 + n, ho = h0 + pos / bmw, wo = w0 + pos % bmw;
    if (co >= p.cout || ho >= p.h_out || wo >= p.w_out) continue;
    const float* c = cs + pos * ldc + n;
    const size_t o =
        (((static_cast<size_t>(b) * p.d_out + dz) * p.h_out + ho) * p.w_out + wo) * p.cout + co;
    const size_t po = ((static_cast<size_t>(b) * p.h_out + ho) * p.w_out + wo) * p.cout + co;
    if (!narrow) {
      float v[8];
      const float4 c0 = *reinterpret_cast<const float4*>(c);
      const float4 c1 = *reinterpret_cast<const float4*>(c + 4);
      v[0] = c0.x; v[1] = c0.y; v[2] = c0.z; v[3] = c0.w;
      v[4] = c1.x; v[5] = c1.y; v[6] = c1.z; v[7] = c1.w;
      store8(p, v, o, po, co);
    } else {
      float v = c[0] + (p.bias ? p.bias[co] : 0.f);
      if (p.res) v += __bfloat162float(static_cast<const bf16*>(p.res)[o]);
      v = activate(v, p.act);
      if (p.post_mul) v *= __bfloat162float(static_cast<const bf16*>(p.post_mul)[po]);
      static_cast<bf16*>(p.out)[o] = __float2bfloat16(v);
    }
  }
}

// C_out 1 (the 32→1 and 8→1 heads, the refinement's conv8): the nine
// (kh, kw) taps are the GEMM's columns.  A stage (one plane, 16 input
// channels, the strip as conv_s1 stages it) multiplies every strip position
// once by the stage's weights arranged (input channel, tap), 9 of 16
// columns real; the float32 sums per (strip position, tap) accumulate over
// the planes and chunks, and the epilogue adds output (r, m)'s nine taps
// from strip positions (r + kh·d, m + kw·d), then + bias, + residual, act,
// × post_mul, one rounding.  Against one 8-channel tile a tap (1 channel
// real), each strip position's A fragment is read once a stage instead of
// nine times, and the products are 16 columns instead of 9 × 8.  The
// weights are copied once a block, as (kd, chunk) blocks of 16 × 16.
constexpr int kHeadTiles = 5;  // 16-row strip tiles a warp: 640 strip positions a block
constexpr int kHeadOut = 512;  // outputs a block at most

template <bool TWO_D>
__global__ void __launch_bounds__(kThreads, 2)
    conv_s1_head(Params p, int bh, int bmw, int ntw, int dil) {
  using bf16 = __nv_bfloat16;
  constexpr int CK = 16, ldb = 24, ldc = 20, MT = kHeadTiles, STAGES = 3, PD = 2;
  constexpr int kdt = TWO_D ? 1 : 3;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int w0 = (blockIdx.x % ntw) * bmw, h0 = (blockIdx.x / ntw) * bh;
  const int b = blockIdx.z / p.d_out, dz = blockIdx.z % p.d_out;
  int dks[3], dis[3], nd = 0;
  for (int k = 0; k < kdt; ++k) {
    const int di = dz + k - (kdt - 1) / 2;
    if (di >= 0 && di < p.d_in) { dks[nd] = k; dis[nd] = di; ++nd; }
  }
  const int nc = (p.cin + CK - 1) / CK, nstage = nd * nc;
  const int nrows = bh + 2 * dil, ncols = bmw + 2 * dil, nstrip = nrows * ncols;
  const int stage_bytes = nstrip * CK * 2;
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.w);
  bf16* wall = reinterpret_cast<bf16*>(smem + STAGES * stage_bytes);  // (kd, chunk, k) × tap
  for (int i = tid; i < kdt * nc * CK * ldb / 8; i += kThreads) {
    reinterpret_cast<uint4*>(wall)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < kdt * 9 * nc * CK; i += kThreads) {
    const int ci = i % (nc * CK), t = (i / (nc * CK)) % 9, kd = i / (nc * CK * 9);
    if (ci < p.cin) {
      wall[((kd * nc + ci / CK) * CK + ci % CK) * ldb + t] =
          w[static_cast<size_t>(kd * 9 + t) * p.cin + ci];
    }
  }

  StripWalk sw;
  sw.init<CK>(tid, ncols);
  auto load = [&](int s, int slot) {
    const bf16* xplane = x + (static_cast<size_t>(b) * p.d_in + dis[s / nc]) * p.h_in *
                                 static_cast<size_t>(p.w_in) * p.cin;
    copy_strip<CK>(smem + slot * stage_bytes, xplane, x, p, h0 - dil, w0 - dil, (s % nc) * CK,
                   nrows, ncols, sw);
  };

  float acc[MT][2][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[t][j][k] = 0.f;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_chunk = lane >> 4;
  const int b_row = lane & 15, b_col = (lane >> 4) * 8;
  int spos[MT];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const int sp = (warp * MT + t) * 16 + a_row;
    spos[t] = sp < nstrip ? sp : 0;
  }
  const unsigned smem_s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned wall_s = static_cast<unsigned>(__cvta_generic_to_shared(wall));
  auto compute = [&](int s, int slot) {
    const unsigned as_s = smem_s + slot * stage_bytes;
    unsigned fb[4];
    ldsm_x4_trans(fb, wall_s + 2 * (((dks[s / nc] * nc + s % nc) * CK + b_row) * ldb + b_col));
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      unsigned fa[4];
      ldsm_x4(fa, as_s + strip_off<CK>(spos[t], a_chunk));
      mma_bf16(acc[t][0], fa, fb[0], fb[1]);
      mma_bf16(acc[t][1], fa, fb[2], fb[3]);
    }
  };

  for (int i = 0; i < PD; ++i) {
    if (i < nstage) load(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nstage; ++i) {
    cp_async_wait<PD - 1>();
    __syncthreads();  // stage i has landed; slot (i + PD) % STAGES is free
    if (i + PD < nstage) load(i + PD, (i + PD) % STAGES);
    cp_async_commit();
    compute(i, i % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();

  // Sums by (strip position, tap) → shared memory, then each output's nine.
  float* cs = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int sp = (warp * MT + t) * 16 + g + 8 * half;
      if (sp >= nstrip) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<float2*>(cs + sp * ldc + j * 8 + 2 * q) =
            make_float2(acc[t][j][2 * half], acc[t][j][2 * half + 1]);
      }
    }
  }
  __syncthreads();
  const bf16* res = static_cast<const bf16*>(p.res);
  const bf16* pm = static_cast<const bf16*>(p.post_mul);
  for (int e = tid; e < bh * bmw; e += kThreads) {
    const int r = e / bmw, m = e % bmw, ho = h0 + r, wo = w0 + m;
    if (ho >= p.h_out || wo >= p.w_out) continue;
    float v = p.bias ? p.bias[0] : 0.f;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        v += cs[((r + kh * dil) * ncols + m + kw * dil) * ldc + kh * 3 + kw];
      }
    const size_t o = ((static_cast<size_t>(b) * p.d_out + dz) * p.h_out + ho) * p.w_out + wo;
    if (res) v += __bfloat162float(res[o]);
    v = activate(v, p.act);
    if (pm) v *= __bfloat162float(pm[(static_cast<size_t>(b) * p.h_out + ho) * p.w_out + wo]);
    static_cast<bf16*>(p.out)[o] = __float2bfloat16(v);
  }
}

// ---- host side -------------------------------------------------------------
//
// A caller plans a shape once (plan(): the tile, the instantiation, the
// shared-memory attribute set, the occupancy looked up) and hands the plan
// to every launch of that shape (run()), which only launches.

inline int sm_count(int device) {
  static int cached[16] = {0};
  if (device < 0 || device >= 16) return 132;
  if (!cached[device]) cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device);
  return cached[device];
}

// A kernel's shared-memory attribute, set to the most a block may opt in to
// (once an instantiation: `done` is the caller's static), and its occupancy
// at `smem` bytes a block.
inline cudaError_t opt_in_smem(const void* kernel, int device, bool& done) {
  if (done) return cudaSuccess;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  done = e == cudaSuccess;
  return e;
}

inline int blocks_per_sm(const void* kernel, int smem) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  return n;
}

// The fewest tiles of at most `pos` positions over an (h, w) plane: bmw =
// ⌈w / ntw⌉ for each W split, bh as many rows as fit; ties go to wider tiles.
inline void tile_plane(int h, int w, int pos, int& bh, int& bmw) {
  int best = -1;
  for (int ntw = 1; ntw <= w; ++ntw) {
    const int cw = (w + ntw - 1) / ntw;
    if (cw > pos) continue;
    int rh = pos / cw;
    if (rh > h) rh = h;
    const int tiles = ntw * ((h + rh - 1) / rh);
    if (best < 0 || tiles < best) { best = tiles; bh = rh; bmw = cw; }
    if (cw == 1) break;
  }
}

template <bool UP, int KS, int BN, int CK, int MT, bool WG>
cudaError_t plan_for(const Params& p, int device, Plan& pl) {
  using G = Geo<UP, KS, BN, CK, MT, WG>;
  const void* kernel = reinterpret_cast<const void*>(conv_bf16<UP, KS, BN, CK, MT, WG>);
  static bool prepared = false;
  if (cudaError_t e = opt_in_smem(kernel, device, prepared)) return e;
  const int ph = UP ? p.h_in : p.h_out, pw = UP ? p.w_in : p.w_out;
  tile_plane(ph, pw, G::POS, pl.bh, pl.bmw);
  pl.nth = (ph + pl.bh - 1) / pl.bh;
  pl.ntw = (pw + pl.bmw - 1) / pl.bmw;
  pl.ntn = (p.cout + BN - 1) / BN;
  pl.bn = BN; pl.ck = CK; pl.mt = MT; pl.pos = G::POS; pl.wg = WG;
  pl.smem = G::smem(pl.bh, pl.bmw);
  pl.per_sm = blocks_per_sm(kernel, pl.smem);
  pl.blocks = pl.nth * pl.ntw * pl.ntn * (UP ? 2 : 1) * p.b * p.d_out;
  pl.splits = 1;
  pl.kh = 1;
  return cudaSuccess;
}

template <bool UP, int KS, int BN, int CK, int MT, bool WG>
cudaError_t launch_with(const Params& p, const Plan& pl, float* ws, cudaStream_t stream) {
  dim3 grid(pl.nth * pl.ntw * pl.ntn * (UP ? 2 : 1), pl.splits, p.b * p.d_out);
  conv_bf16<UP, KS, BN, CK, MT, WG><<<grid, kThreads, pl.smem, stream>>>(
      p, pl.bh, pl.bmw, pl.ntw, pl.ntn, ws);
  return cudaGetLastError();
}

// The instantiations: tiles a warp MT 2 or 1 (stride 2: a warp holds 32 or
// 16 positions), 4 or 2 (transposed: 32 or 16 positions, both W parities);
// the wgmma form at BN 64 holds the same positions a block as the larger
// mma.sync form (a warp its 16 positions, over all 64 channels).
enum Form { kFull = 0, kHalf = 1, kWgmma = 2 };

template <bool UP, int KS, int BN, int CK>
cudaError_t with(bool do_plan, const Params& p, int device, Plan& pl, float* ws,
                 cudaStream_t stream, Form form) {
  constexpr int MT = UP ? 4 : 2;
  if constexpr (BN == 64) {
    if (form == kWgmma) {
      return do_plan ? plan_for<UP, KS, BN, CK, MT / 2, true>(p, device, pl)
                     : launch_with<UP, KS, BN, CK, MT / 2, true>(p, pl, ws, stream);
    }
  }
  if (form == kHalf) {
    return do_plan ? plan_for<UP, KS, BN, CK, MT / 2, false>(p, device, pl)
                   : launch_with<UP, KS, BN, CK, MT / 2, false>(p, pl, ws, stream);
  }
  return do_plan ? plan_for<UP, KS, BN, CK, MT, false>(p, device, pl)
                 : launch_with<UP, KS, BN, CK, MT, false>(p, pl, ws, stream);
}

template <bool UP, int KS>
cudaError_t dispatch(bool do_plan, const Params& p, int device, Plan& pl, float* ws,
                     cudaStream_t stream, int bn, int ck, Form form) {
  if (ck == 16) {
    if (bn == 16) return with<UP, KS, 16, 16>(do_plan, p, device, pl, ws, stream, form);
    if (bn == 32) return with<UP, KS, 32, 16>(do_plan, p, device, pl, ws, stream, form);
    return with<UP, KS, 64, 16>(do_plan, p, device, pl, ws, stream, form);
  }
  if (bn == 16) return with<UP, KS, 16, 32>(do_plan, p, device, pl, ws, stream, form);
  if (bn == 32) return with<UP, KS, 32, 32>(do_plan, p, device, pl, ws, stream, form);
  return with<UP, KS, 64, 32>(do_plan, p, device, pl, ws, stream, form);
}

// The plan for a shape: C_out tiles of 16, 32 or 64 channels (128 runs as
// two), 32 input channels a stage where C_in allows, else 16.  At 64
// channels the products run on wgmma unless `tc` asks for mma.sync.  Where
// the blocks would not fill one wave of the card, a warp takes half the
// tiles (twice the blocks, mma.sync); where stride 2 still does not fill it
// and takes at least two input-channel chunks (18 stages or more), its K
// stages are split over as many blocks as fill it, at most 8 and at least 3
// stages a split.  A split costs the host a scratch allocation and a second
// launch, about 30 µs a call on an H100's host: more than it saves at 9
// stages.
template <bool UP, int KS>
cudaError_t plan(const Params& p, int device, int tc, Plan& pl) {
  if (p.cout % 8 != 0 || p.cin % 16 != 0) return cudaErrorInvalidValue;
  const int bn = p.cout <= 16 ? 16 : p.cout <= 32 ? 32 : 64;
  const int ck = p.cin % 32 ? 16 : 32;
  const Form full = bn == 64 && tc != kTcMma ? kWgmma : kFull;
  cudaError_t e = dispatch<UP, KS>(true, p, device, pl, nullptr, nullptr, bn, ck, full);
  if (e != cudaSuccess || pl.blocks >= pl.per_sm * sm_count(device)) return e;
  e = dispatch<UP, KS>(true, p, device, pl, nullptr, nullptr, bn, ck, kHalf);
  const int slots = pl.per_sm * sm_count(device);
  if (e != cudaSuccess || UP || pl.blocks >= slots || p.cin / ck < 2) return e;
  int s = (slots + pl.blocks - 1) / pl.blocks;
  const int most = 9 * (p.cin / ck) / 3;  // at least 3 stages a split (3 planes, 3 rows)
  s = s > most ? most : s;
  pl.splits = s > 8 ? 8 : s < 1 ? 1 : s;
  return cudaSuccess;
}

// Launch a shape on its plan (from plan(), on the same device); split K
// needs `ws`, float32 scratch of splits × outputs.
template <bool UP, int KS>
cudaError_t run(const Params& p, Plan pl, float* ws, cudaStream_t stream) {
  if (pl.splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
  const Form form = pl.wg ? kWgmma : pl.mt == (UP ? 4 : 2) ? kFull : kHalf;
  cudaError_t e = dispatch<UP, KS>(false, p, 0, pl, ws, stream, pl.bn, pl.ck, form);
  if (e != cudaSuccess || pl.splits == 1) return e;
  const size_t n = static_cast<size_t>(p.b) * p.d_out * p.h_out * p.w_out * (p.cout / 8);
  splitk_finish<<<ceil_div(static_cast<long long>(n), kThreads), kThreads, 0, stream>>>(p, ws,
                                                                                     pl.splits);
  return cudaGetLastError();
}


// ---- stride 1: host side ---------------------------------------------------

// The tile of at most `pos` positions over an (h, w) plane with the least
// work: tiles × (2·pos + the strip a stage copies, rows × columns with the
// halo of d), 2% more for a width off a multiple of 8 (but the plane's), so
// a narrow W fills the tile with whole rows and a wide dilation prefers
// wide, shallow tiles; strips past `max_area` positions (a
// ring that would not fit a block's shared memory) are not taken.  False
// where none fits.
inline bool tile_s1(int h, int w, int pos, int d, bool plane, long max_area, int& bh, int& bmw) {
  long best = -1;
  int prev = 0;
  for (int ntw = 1; ntw <= w; ++ntw) {
    const int cw = (w + ntw - 1) / ntw;
    if (cw > pos || cw == prev) continue;
    prev = cw;
    const int most = pos / cw < h ? pos / cw : h;
    // One kh tap a stage: fewer rows where the strip must shrink (a wide d);
    // whole planes keep full tiles (a plane that fits only small tiles is
    // staged by kh tap instead).
    for (int rh = most; rh >= (plane ? most : 1); --rh) {
      const long tiles = static_cast<long>(ntw) * ((h + rh - 1) / rh);
      const long area = static_cast<long>(plane ? rh + 2 * d : rh) * (cw + 2 * d);
      // a width off a multiple of 8 splits an ldmatrix phase over two rows
      const long cost = tiles * (2L * pos + area) * (cw % 8 && cw != w ? 102 : 100);
      if (area > max_area) continue;
      if (best < 0 || cost < best) { best = cost; bh = rh; bmw = cw; }
      break;
    }
    if (cw == 1) break;
  }
  return best >= 0;
}

template <int BN, int MT, bool WG, bool PLANE, bool TWO_D>
cudaError_t s1_plan_for(const Params& p, int dil, int device, Plan& pl) {
  using G = GeoS1<BN, MT, WG, PLANE>;
  constexpr int kdt = TWO_D ? 1 : 3;
  const void* kernel = reinterpret_cast<const void*>(conv_s1<BN, MT, WG, PLANE, TWO_D>);
  static bool prepared = false;
  if (cudaError_t e = opt_in_smem(kernel, device, prepared)) return e;
  const bool narrow = !WG && p.cout % 8 != 0;
  const int narrow_w = narrow ? G::narrow_bytes(kdt, p.cin) : 0;
  // The strip's room: a block's shared memory (227 KB on an H100) less the
  // preloaded weights, over the ring, less a stage's weights and the wgmma
  // alignment.
  const long room =
      ((232448 - 2048 - narrow_w) / G::STAGES - (narrow ? 0 : G::b_elems * 2) - 1024) / (G::CK * 2);
  if (!tile_s1(p.h_out, p.w_out, G::M_TILE, dil, PLANE, room, pl.bh, pl.bmw)) {
    return cudaErrorInvalidConfiguration;
  }
  pl.nth = (p.h_out + pl.bh - 1) / pl.bh;
  pl.ntw = (p.w_out + pl.bmw - 1) / pl.bmw;
  pl.ntn = (p.cout + BN - 1) / BN;
  pl.bn = BN; pl.ck = G::CK; pl.mt = MT; pl.pos = G::M_TILE; pl.wg = WG;
  pl.kh = PLANE ? 3 : 1;
  pl.smem = G::smem(pl.bh, pl.bmw, dil, narrow_w);
  pl.per_sm = blocks_per_sm(kernel, pl.smem);
  pl.blocks = pl.nth * pl.ntw * pl.ntn * p.b * p.d_out;
  pl.splits = 1;
  return pl.per_sm > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int BN, int MT, bool WG, bool PLANE, bool TWO_D>
cudaError_t s1_launch(const Params& p, const Plan& pl, int dil, float* ws, cudaStream_t stream) {
  dim3 grid(pl.nth * pl.ntw * pl.ntn, pl.splits, p.b * p.d_out);
  conv_s1<BN, MT, WG, PLANE, TWO_D><<<grid, kThreads, pl.smem, stream>>>(p, pl.bh, pl.bmw, pl.ntw,
                                                                          pl.ntn, dil, ws);
  return cudaGetLastError();
}

// C_out 1 on conv_s1_head: a tile of at most kHeadOut outputs whose strip
// fits its kHeadTiles · 128 GEMM rows (false where none does: the 8-channel
// tile of conv_s1 takes the shape).
template <bool TWO_D>
bool head_plan(const Params& p, int dil, int device, Plan& pl) {
  constexpr int kdt = TWO_D ? 1 : 3;
  const void* kernel = reinterpret_cast<const void*>(conv_s1_head<TWO_D>);
  static bool prepared = false;
  if (opt_in_smem(kernel, device, prepared) != cudaSuccess) return false;
  if (!tile_s1(p.h_out, p.w_out, kHeadOut, dil, true, kHeadTiles * 128, pl.bh, pl.bmw)) {
    return false;
  }
  const int nstrip = (pl.bh + 2 * dil) * (pl.bmw + 2 * dil);
  pl.nth = (p.h_out + pl.bh - 1) / pl.bh;
  pl.ntw = (p.w_out + pl.bmw - 1) / pl.bmw;
  pl.ntn = 1;
  pl.bn = 1; pl.ck = 16; pl.mt = kHeadTiles; pl.pos = kHeadOut; pl.wg = 0; pl.kh = 3;
  const int ring = 3 * nstrip * 32 + kdt * ((p.cin + 15) / 16) * 16 * 24 * 2;
  pl.smem = ring > nstrip * 20 * 4 ? ring : nstrip * 20 * 4;
  pl.per_sm = blocks_per_sm(kernel, pl.smem);
  pl.blocks = pl.nth * pl.ntw * p.b * p.d_out;
  pl.splits = 1;
  return pl.per_sm > 0;
}

// The forms a tile width takes, largest tile first: (wgmma, tiles a warp).
// mma.sync: a warp holds 4 16-row tiles at 8, 16 and 32 channels a block
// (512 positions), 2 at 64 and 128 (128 positions, two warps along N), and
// the 3-D conv also half and a quarter of that for grids under a wave;
// wgmma: 4, 2 or 1 tiles a warp at 32 channels (below), 2 at 128 (256
// positions) and at 64 and 96 in the 2-D conv, 1 at 64 in the 3-D conv
// (128 positions, two blocks an SM), and the 3-D conv 1 at 128 for small
// grids.
struct S1Form {
  bool wg;
  int mt;
};

template <int BN, bool TWO_D>
int s1_forms(bool wg, S1Form (&f)[3]) {
  if (wg) {
    if (BN == 64) { f[0] = {true, TWO_D ? 2 : 1}; return 1; }
    f[0] = {true, 2};
    f[1] = {true, 1};
    return TWO_D ? 1 : 2;
  }
  constexpr int full = BN <= 32 ? 4 : 2;
  f[0] = {false, full};
  f[1] = {false, full / 2};
  f[2] = {false, full / 4};
  return TWO_D ? 1 : full == 4 ? 3 : 2;
}

// 32 channels: 4, 2 or 1 tiles a warp (512, 256, 128 positions), wgmma
// (m64n32k16) where `wg`, but at 4 tiles only where `tc` asks for it:
// there mma.sync measured 1–4% faster on an H100 (PERF.md, PR 7).
template <>
inline int s1_forms<32, false>(bool wg, S1Form (&f)[3]) {
  f[0] = {false, 4};
  f[1] = {wg, 2};
  f[2] = {wg, 1};
  return 3;
}
template <>
inline int s1_forms<32, true>(bool, S1Form (&f)[3]) {
  f[0] = {false, 4};
  return 1;
}

template <int BN, bool TWO_D, bool PLANE>
cudaError_t s1_with(bool do_plan, const Params& p, int dil, int device, Plan& pl, float* ws,
                    cudaStream_t stream, S1Form f) {
#define DV_S1_FORM(MT_, WG_)                                                       \
  return do_plan ? s1_plan_for<BN, MT_, WG_, PLANE, TWO_D>(p, dil, device, pl)     \
                 : s1_launch<BN, MT_, WG_, PLANE, TWO_D>(p, pl, dil, ws, stream)
  constexpr int full = BN <= 32 ? 4 : 2;
  if constexpr (BN == 32) {
    if (f.wg) {
      if (f.mt == 4) DV_S1_FORM(4, true);
      if constexpr (!TWO_D) {
        if (f.mt == 2) DV_S1_FORM(2, true);
        DV_S1_FORM(1, true);
      }
    }
  }
  if constexpr (BN == 128 || ((BN == 64 || BN == 96) && TWO_D)) {
    if (f.wg && f.mt == 2) DV_S1_FORM(2, true);
  }
  if constexpr (BN >= 64 && !TWO_D) {
    if (f.wg) DV_S1_FORM(1, true);
  }
  if constexpr (!TWO_D) {
    if (f.mt == full / 2) DV_S1_FORM(full / 2, false);
    if constexpr (full == 4) {
      if (f.mt == 1) DV_S1_FORM(1, false);
    }
  }
  DV_S1_FORM(full, false);
#undef DV_S1_FORM
}

template <bool TWO_D, bool PLANE>
cudaError_t s1_bn(bool do_plan, const Params& p, int dil, int device, Plan& pl, float* ws,
                  cudaStream_t stream, int bn, S1Form f) {
  if (bn == 8) return s1_with<8, TWO_D, PLANE>(do_plan, p, dil, device, pl, ws, stream, f);
  if (bn == 16) return s1_with<16, TWO_D, PLANE>(do_plan, p, dil, device, pl, ws, stream, f);
  if (bn == 32) return s1_with<32, TWO_D, PLANE>(do_plan, p, dil, device, pl, ws, stream, f);
  if (bn == 64) return s1_with<64, TWO_D, PLANE>(do_plan, p, dil, device, pl, ws, stream, f);
  if constexpr (TWO_D) {
    if (bn == 96) return s1_with<96, TWO_D, PLANE>(do_plan, p, dil, device, pl, ws, stream, f);
  }
  return s1_with<128, TWO_D, PLANE>(do_plan, p, dil, device, pl, ws, stream, f);
}

template <bool TWO_D>
cudaError_t s1_dispatch(bool do_plan, const Params& p, int dil, int device, Plan& pl, float* ws,
                        cudaStream_t stream, int bn, bool plane, S1Form f) {
  if constexpr (TWO_D) {
    if (!plane) return s1_bn<true, false>(do_plan, p, dil, device, pl, ws, stream, bn, f);
  }
  return s1_bn<TWO_D, true>(do_plan, p, dil, device, pl, ws, stream, bn, f);
}

// The stride-1 plan for a shape (TWO_D: one plane, kdt 1, dilation `dil`;
// else the 3-D conv, kdt 3, d 1).  C_out 1 on conv_s1_head where its tile
// fits; else C_out tiles of 8 (C_out below 8), 16, 32, 64 or 128 channels
// (the 2-D conv's C_out 96 as one 96-channel wgmma tile, or on mma.sync as
// three 32-channel tiles); wgmma at 64 and more channels and at 32 below
// the largest tile (s1_forms), unless `tc` forces one form.  Stages hold whole planes where a full tile's strip fits the
// ring (always at d 1; the 2-D conv to d 4 at 128 channels), else one kh
// tap.  The largest tile form first;
// a smaller one (3-D only) where the larger fills under one wave of the
// card (blocks an SM × SMs); for each, K split over s = 1 … 8 blocks (3-D
// only, at least 3 stages a split, C_out a multiple of 8).  The candidates
// are costed by a model of the card: waves of blocks × (stages a split + 1
// for the prologue and epilogue) × a stage's tensor-core time at half the
// peak rate, plus, for a split, the second launch (3 µs) and the partial
// sums' traffic (written and read once, at 3.35 TB/s); the least wins.
template <bool TWO_D>
cudaError_t s1_plan(const Params& p, int dil, int device, int tc, Plan& pl) {
  if (p.cin % 8 != 0 || dil < 1) return cudaErrorInvalidValue;
  if (p.cout == 1 && head_plan<TWO_D>(p, dil, device, pl)) return cudaSuccess;
  const bool narrow = p.cout % 8 != 0;
  int bn = p.cout < 8 ? 8 : p.cout <= 16 ? 16 : p.cout <= 32 ? 32 : p.cout <= 64 ? 64 : 128;
  const bool wg = bn >= 32 && tc != kTcMma && !narrow;
  if (TWO_D && bn == 128 && p.cout <= 96 && p.cout % 32 == 0) bn = wg ? 96 : 32;
  const int kdt = TWO_D ? 1 : 3;
  S1Form forms[3];
  const int nforms = bn == 8    ? s1_forms<8, TWO_D>(wg, forms)
                     : bn == 16 ? s1_forms<16, TWO_D>(wg, forms)
                     : bn == 32 ? s1_forms<32, TWO_D>(wg, forms)
                     : bn == 64 ? s1_forms<64, TWO_D>(wg, forms)
                                : s1_forms<128, TWO_D>(wg, forms);  // 96 as 128
  if (tc == kTcWgmma && wg) forms[0].wg = true;  // forced: wgmma at the largest tile too
  bool plane = true;
  Plan c;
  cudaError_t e = s1_dispatch<TWO_D>(true, p, dil, device, c, nullptr, nullptr, bn, plane,
                                     forms[0]);
  if (TWO_D && e == cudaErrorInvalidConfiguration) {
    plane = false;
    e = s1_dispatch<TWO_D>(true, p, dil, device, c, nullptr, nullptr, bn, plane, forms[0]);
  }
  if (e != cudaSuccess) return e;
  const int ck = plane ? 16 : 32;
  const int nstage = kdt * (plane ? 1 : 3) * ((p.cin + ck - 1) / ck);
  const double stage_flop = (plane ? 9.0 : 3.0) * ck * 2 * bn;  // a position's
  const double sm_flop_per_ns = 989e3 / 132 / 2;                // one SM at half the bf16 peak
  const double out_bytes = 4.0 * p.b * p.d_out * p.h_out * p.w_out * p.cout;
  const long sms = sm_count(device);
  double best = -1.0;
  for (int f = 0; f < nforms; ++f) {
    if (f > 0 && s1_dispatch<TWO_D>(true, p, dil, device, c, nullptr, nullptr, bn, plane,
                                    forms[f]) != cudaSuccess) {
      break;
    }
    const long slots = c.per_sm * sms;
    const double stage_ns = c.pos * stage_flop / sm_flop_per_ns;
    int most = nstage / 3 > 8 ? 8 : nstage / 3;
    if (TWO_D || narrow || most < 1) most = 1;
    for (int s = 1; s <= most; ++s) {
      const long waves = (static_cast<long>(c.blocks) * s + slots - 1) / slots;
      double ns = waves * c.per_sm * ((nstage + s - 1) / s + 1) * stage_ns;
      if (s > 1) ns += 3000.0 + 2.0 * s * out_bytes / 3350.0;
      if (best < 0 || ns < best) {
        best = ns;
        pl = c;
        pl.splits = s;
      }
    }
    if (c.blocks >= slots) break;  // a full wave: no smaller tile
  }
  return cudaSuccess;
}

// Launch a stride-1 shape on its plan (from s1_plan, on the same device);
// split K needs `ws`, float32 scratch of splits × outputs.
template <bool TWO_D>
cudaError_t s1_run(const Params& p, Plan pl, int dil, float* ws, cudaStream_t stream) {
  if (pl.splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
  if (pl.bn == 1) {
    conv_s1_head<TWO_D><<<dim3(pl.nth * pl.ntw, 1, p.b * p.d_out), kThreads, pl.smem, stream>>>(
        p, pl.bh, pl.bmw, pl.ntw, dil);
    return cudaGetLastError();
  }
  cudaError_t e = s1_dispatch<TWO_D>(false, p, dil, 0, pl, ws, stream, pl.bn, pl.kh == 3,
                                     S1Form{pl.wg != 0, pl.mt});
  if (e != cudaSuccess || pl.splits == 1) return e;
  const size_t n = static_cast<size_t>(p.b) * p.d_out * p.h_out * p.w_out * (p.cout / 8);
  splitk_finish<<<ceil_div(static_cast<long long>(n), kThreads), kThreads, 0, stream>>>(p, ws,
                                                                                     pl.splits);
  return cudaGetLastError();
}

}  // namespace hopper
}  // namespace dv
