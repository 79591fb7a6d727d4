// The stride-2 3×3×3 conv and the stride-2 transposed conv (k3 s2 p1 op1,
// k4 s2 p1 op0) in bf16 on channels-last (NDHWC) volumes, built for the
// H100: csrc/conv3d_fold.cu (stride 2) and csrc/conv3d_up.cu call them.  The
// float32 forms stay the plain FMA kernel of conv_igemm.cuh (direct_f32).
//
// GEMM view.  A block owns M_TILE GEMM rows and BN output channels, with
// float32 accumulators in registers.  Two tensor-core forms:
//   mma.sync  8 warps stand WM along M by WN along N; each holds MT 16-row
//             tiles × BN/WN channels (bf16 m16n8k16, A and B from shared
//             memory by ldmatrix).  Every C_out tile width (16, 32, 64).
//   wgmma     BN 64 only: the 8 warps are 2 warpgroups, each warp holds MT
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
// input channels).  A stage copies (cp.async, 16 bytes a thread) the input
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
// Epilogue in float32 (+ bias, + residual, activation, × post_mul), one
// rounding to bfloat16, 8 channels (16 bytes) a thread; C_out must be a
// multiple of 8.
#pragma once

#include "conv_igemm.cuh"

namespace dv {
namespace hopper {

using igemm::Params;
using igemm::activate;
using igemm::cp_async16;
using igemm::ldsm_x4;
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

// Keep the compiler from moving accumulator accesses across the async products.
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+f"(d[j][k])::"memory");
}

// d (this warp's 16 rows of a 64 × 64 float32 tile) += a (16 × 16 bf16,
// mma.sync's A fragment) · B (16 × 64 bf16 at descriptor `b`, transposed:
// channels contiguous).  d[j][k] is mma.sync's accumulator layout for
// channels 8j … 8j + 7.
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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
            wgmma_n64(acc[t], fa[t][tt][q], sw128_desc(bs_s + (kw * CK + 16 * q) * ldb * 2));
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

// One instantiation: its shared-memory attribute is set once (to the most
// a block may opt in to), its occupancy looked up for a plan.
template <bool UP, int KS, int BN, int CK, int MT, bool WG>
struct Kernel {
  using G = Geo<UP, KS, BN, CK, MT, WG>;
  static cudaError_t prepare(int device) {
    static bool done = false;
    if (done) return cudaSuccess;
    int optin = 0;
    cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(conv_bf16<UP, KS, BN, CK, MT, WG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess) done = true;
    return e;
  }
  static int per_sm(int smem) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_bf16<UP, KS, BN, CK, MT, WG>, kThreads,
                                                  smem);
    return n;
  }
};

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
  using K = Kernel<UP, KS, BN, CK, MT, WG>;
  if (cudaError_t e = K::prepare(device)) return e;
  const int ph = UP ? p.h_in : p.h_out, pw = UP ? p.w_in : p.w_out;
  tile_plane(ph, pw, K::G::POS, pl.bh, pl.bmw);
  pl.nth = (ph + pl.bh - 1) / pl.bh;
  pl.ntw = (pw + pl.bmw - 1) / pl.bmw;
  pl.ntn = (p.cout + BN - 1) / BN;
  pl.bn = BN; pl.ck = CK; pl.mt = MT; pl.pos = K::G::POS; pl.wg = WG;
  pl.smem = K::G::smem(pl.bh, pl.bmw);
  pl.per_sm = K::per_sm(pl.smem);
  pl.blocks = pl.nth * pl.ntw * pl.ntn * (UP ? 2 : 1) * p.b * p.d_out;
  pl.splits = 1;
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

}  // namespace hopper
}  // namespace dv
