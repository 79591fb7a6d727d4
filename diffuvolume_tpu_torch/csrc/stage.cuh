// The kVec × kVec register transpose (kVec = 16 / sizeof(T): 8 bf16 or 4
// float32 elements, one 16-byte vector) and the staging of NCHW feature
// rows position-major built on it.  Shared by csrc/gwc_volume.cu (row 16's
// staging), csrc/concat_volume.cu (row 3's) and csrc/layout.cu (rows 11-12's
// 16-byte transpose).
#pragma once

#include "common.cuh"

namespace dv {

// The raw bits of one element.
template <typename T> struct BitsOf { using type = unsigned int; };
template <> struct BitsOf<__nv_bfloat16> { using type = unsigned short; };

// e[j] holds 16 bytes of row j (kVec elements); returns element p of each
// row, in row order, as 16 bytes: byte permutes of the bf16 pairs, word
// moves for float32.  p must be a constant after unrolling, or e spills.
template <typename T>
__device__ __forceinline__ uint4 transpose_column(const uint4 (&e)[16 / sizeof(T)], int p) {
  if constexpr (sizeof(T) == 2) {
    // element p of 8 rows: the low or high halves of word p / 2
    const unsigned sel = (p & 1) ? 0x7632u : 0x5410u;
    auto wd = [&](int j) { return reinterpret_cast<const unsigned*>(&e[j])[p >> 1]; };
    return make_uint4(__byte_perm(wd(0), wd(1), sel), __byte_perm(wd(2), wd(3), sel),
                      __byte_perm(wd(4), wd(5), sel), __byte_perm(wd(6), wd(7), sel));
  } else {
    auto wd = [&](int j) { return reinterpret_cast<const unsigned*>(&e[j])[p]; };
    return make_uint4(wd(0), wd(1), wd(2), wd(3));
  }
}

// Stage W positions [x0, x0 + n) ∩ [0, w) of image row y of batch b, the c
// channels of feat (B, c, h, w) then the cc channels of cat (B, cc, h, w;
// null when cc is 0), zeros up to a whole vector, as rows dst[(x − x0)·ld
// + ch] (ld a multiple of kVec).  Positions outside the image are not
// written.  chunk == kVec: a thread reads kVec W positions (16 bytes) of
// each of kVec channels and transposes them in registers, one 16-byte
// store a position; it needs h·w a multiple of kVec and both tensors
// 16-byte aligned.  chunk == 1: one element a channel.  All threads of the
// block take part.
template <typename T>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst, int ld, int x0, int n,
                                           const T* __restrict__ feat, int c,
                                           const T* __restrict__ cat, int cc, int b, int y,
                                           int h, int w, int chunk) {
  constexpr int kVec = 16 / sizeof(T);
  using Bits = typename BitsOf<T>::type;
  const int lo = max(x0, 0), hi = min(x0 + n, w);
  if (lo >= hi) return;
  const int nch = c + cc;
  const int noct = (nch + kVec - 1) / kVec;
  const long long hw = static_cast<long long>(h) * w;
  const long long row = static_cast<long long>(y) * w;
  auto channel = [&](int ch) -> const T* {
    if (ch < c) return feat + (static_cast<long long>(b) * c + ch) * hw + row;
    if (ch < nch) return cat + (static_cast<long long>(b) * cc + (ch - c)) * hw + row;
    return nullptr;
  };
  if (chunk == kVec) {
    // Chunks start where the element index is a multiple of kVec.
    const int xs = lo - static_cast<int>((row + lo) % kVec);
    const int nck = (hi - xs + kVec - 1) / kVec;
    for (int i = threadIdx.x; i < noct * nck; i += blockDim.x) {
      const int oct = i % noct, xa = xs + (i / noct) * kVec;
      uint4 e[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const T* src = channel(oct * kVec + j);
        e[j] = src ? *reinterpret_cast<const uint4*>(src + xa) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int p = 0; p < kVec; ++p) {
        const int x = xa + p;
        if (x < lo || x >= hi) continue;
        *reinterpret_cast<uint4*>(dst + (x - x0) * ld + oct * kVec) = transpose_column<T>(e, p);
      }
    }
  } else {
    for (int i = threadIdx.x; i < noct * (hi - lo); i += blockDim.x) {
      const int oct = i % noct, x = lo + i / noct;
      Bits e[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const T* src = channel(oct * kVec + j);
        e[j] = src ? reinterpret_cast<const Bits*>(src)[x] : Bits(0);
      }
      uint4 v;
      if constexpr (sizeof(T) == 2) {
        v = make_uint4(e[0] | unsigned(e[1]) << 16, e[2] | unsigned(e[3]) << 16,
                       e[4] | unsigned(e[5]) << 16, e[6] | unsigned(e[7]) << 16);
      } else {
        v = make_uint4(e[0], e[1], e[2], e[3]);
      }
      *reinterpret_cast<uint4*>(dst + (x - x0) * ld + oct * kVec) = v;
    }
  }
}

}  // namespace dv
