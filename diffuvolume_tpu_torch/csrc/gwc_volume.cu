// Group-wise correlation volumes.
//
// dv_gwc_volume: the NCDHW volume (the module paths of the ACV and IGEV models)
//   out[b, g, d, h, w] = mean_{c in group g} left[b, c, h, w] * right[b, c, h, w - d]
// for w >= d, zero elsewhere.  Features (B, C, H, W), volume (B, G, D, H, W).
//   Replaces diffuvolume_tpu/ops/pallas/gwc_volume.py:gwc_volume_pallas.
//   Plain version: ops/cost_volume.py build_gwc_volume.
//
// What bounds it on the H100: at the main path (C=320, G=40, D=48, 128×240,
// bf16) it reads 2×19.7 MB and writes 118 MB (about 47 µs at 3.35 TB/s)
// and does about 1.1 G float32 multiply-adds (about 17 µs at 67 TFLOP/s),
// so its bound is the bytes, nearly all of them the output.
//
// Design.  Each output vector is 16 bytes of one output row (b, g, d, h):
// V = 8 bf16 (4 float32) consecutive W positions.  A thread owns one item,
// V consecutive W positions and a range of disparities of one (b, g, h),
// taken in steps of V (gwc_plan: three).  A step makes the V × V outputs of
// disparities d0 … d0 + V − 1 and walks the group's cpg channels in order.
// For each channel it reads one 16-byte vector of the left row at x0 and the
// two 16-byte vectors of the right row at x0 − d0 − V and x0 − d0: every
// right position that any of its V × V outputs needs (x0 + k − d); x0 and
// d0 are multiples of V, so each vector lies wholly inside the row or
// wholly left of it (zeros).  The V × V float32 sums stay in registers, V²
// FMAs a channel from 3 loads, so an output costs 3·cpg / V² 16-byte loads
// (0.375 at cpg 8); the features are read straight from global memory (each
// right vector again by the items of the neighbouring W vectors and
// disparity steps, out of L1 and L2) and nothing is staged.  Items run W
// vector fastest, then the disparity ranges of one (b, g, h) row, so a
// block's items share their rows in L1.  Each output vector is one 16-byte
// streaming store (st.global.cs: the 118 MB ACV volume is 2.4 times the
// L2).  Sums in float32 in channel order, divided by cpg, rounded once to
// the output type (bf16 in pairs, cvt.rn.bf16x2); 0 where w < d.  The
// division is a multiply by 1/cpg where cpg is a power of two, else the
// quotient by the rounded reciprocal corrected once by its FMA remainder
// (div_cpg, the correctly rounded quotient in three instructions).  On the
// H100 the kernel is bound by instruction issue about as much as by bytes:
// an output costs cpg FMAs and, a channel, 3/64 loads and 24/64 bf16
// conversions; the IEEE division alone cost a quarter of IGEV's cpg-12
// time, and staging the rows in shared memory (cp.async) or prefetching them
// into L2 made both shapes slower (PERF.md).  A W that is not a
// multiple of V, or an unaligned tensor, takes the element form (the same
// items, element loads and stores, bounds checked).  cpg 1, 2, 3, 4, 6, 8,
// 12 and 16 are compiled; any other cpg runs a loop over a run-time count.
//
// dv_gwc_volume_slot: the volume written straight into the channels-last
// slot that the folded conv chain reads, with the concat halves fused in:
//   out (B, D, H, W, slot), per (d, h, w):
//     [0, G)          the group mean above (0 where w < d)
//     [G, G+cc)       cat_l[c, h, w]       (0 where w < d if mask_ref)
//     [G+cc, G+2cc)   cat_r[c, h, w - d]   (0 where w < d)
//     [G+2cc, slot)   0
//   Replaces diffuvolume_tpu/ops/pallas/gwc_volume.py:gwc_volume_packed
//   (the ACV attention chain's 40-in-48 volume; PCW's 40+12+12 = 64 volumes
//   at 1/4 … 1/32; IGEV's 8 groups of 12 channels in a 16 slot).  Plain
//   version: ops/cost_volume.py gwc_volume_slot.
//
// What bounds it on the H100: bytes, the output.  ACV (1, 48, 128, 240, 48)
// bf16 writes 141.6 MB (about 42 µs at 3.35 TB/s) from 39 MB of features;
// PCW's 1/4 volume (1, 48, 96, 312, 64) writes 184 MB (about 55 µs).  The
// 426 M (ACV) multiply-adds are about 13 µs of float32 work, but each one
// also costs a bf16 → float32 conversion and shared-memory bandwidth.
//
// Design.  The TPU kernel packs D-phases into 128 lanes with halo rows and
// slices the shifts out of a flattened row; none of that carries over.  A
// block owns one (b, h) row, a tile of `tw` W positions and a range of `ds`
// disparities (slot_plan below: 32 × 24 at full resolution, so that several
// small blocks an SM hide each other's staging; D split further where a
// small level's grid would leave SMs idle).  Staging (csrc/stage.cuh, shared
// with row 3): the features are NCHW, so a thread reads
// 16 bytes (8 bf16 W positions) of each of 8 channels and transposes them in
// registers (byte permutes) into 8 [position][channel] rows, one 16-byte
// store each; the row stride is an odd number of 16-byte units.  Compute: a
// thread owns half a 16-byte output vector (4 bf16 groups) of one position,
// keeps its left channels (4·cpg values) in float32 registers across the d
// loop and reads only the right row's 4·cpg channels a d, as 16-byte loads
// (8-byte for odd cpg); quarter-warps take 4 positions × 2 halves, so the
// reads fall in distinct bank groups.  The concat halves and the fill are
// copied by threads of their own.  Sums in float32 in channel order,
// divided by cpg, rounded once.  cpg 1, 2, 3, 4, 6, 8, 12 and 16 are
// compiled.
#include <cstring>

#include "common.cuh"
#include "stage.cuh"

namespace dv {
namespace {

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// One shape's plan, in ops/kernels/_build.py GWC_PLAN_KEYS order: an item
// makes tw W positions × ds disparities (a multiple of V), in steps of V;
// vec 1 for 16-byte loads and stores, 0 for the element form; items and
// the grid of blocks of `threads`; blocks an SM (the occupancy API); no
// shared memory.
struct GwcPlan {
  int tw, ds, vec, items, threads, blocks, blocks_per_sm, smem_bytes;
};

constexpr int kGwcMaxThreads = 512;  // gwc_ncdhw_kernel's launch bound: ≤ 128 registers

struct GwcGeom {
  int c, h, w, groups, cpg, dmax, ds, nvec, nds, items;
};

// a / n from inv = 1 / n rounded: the quotient by the reciprocal,
// corrected once by its remainder (an FMA, exact where the quotient is
// normal).  Correctly rounded for normal quotients; three instructions in
// place of the IEEE division's reciprocal, refinement and range check.
__device__ __forceinline__ float div_cpg(float a, float n, float inv) {
  const float q = a * inv;
  return fmaf(fmaf(-q, n, a), inv, q);
}

// Two float32 values rounded to bf16 (to nearest even) in one word, the
// first in the low half.
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// V elements of row `row` from position p (a multiple of V) → float32;
// zeros left of the row; the element form checks each position.
template <typename T, bool VEC>
__device__ __forceinline__ void load_run(const T* __restrict__ row, int p, int w, float* f) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (VEC) {
    if (p < 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = 0.f;
      return;
    }
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + p));
    const unsigned wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 2) {
        f[2 * i] = bf16_lo(wd[i]);
        f[2 * i + 1] = bf16_hi(wd[i]);
      } else {
        f[i] = __uint_as_float(wd[i]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = (p + i >= 0 && p + i < w) ? to_f32(row[p + i]) : 0.f;
  }
}

template <typename T, int CPG, bool VEC>
__global__ void __launch_bounds__(kGwcMaxThreads)
    gwc_ncdhw_kernel(const T* __restrict__ left, const T* __restrict__ right,
                     T* __restrict__ out, GwcGeom g) {
  constexpr int V = 16 / sizeof(T);
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= g.items) return;
  int rest = item;
  const int xv = rest % g.nvec;
  rest /= g.nvec;
  const int dc = rest % g.nds;
  rest /= g.nds;
  const int y = rest % g.h;
  rest /= g.h;
  const int grp = rest % g.groups;
  const int b = rest / g.groups;
  const int cpg = CPG > 0 ? CPG : g.cpg;
  const int x0 = xv * V;
  const long long hw = static_cast<long long>(g.h) * g.w;
  const long long in_off =
      (static_cast<long long>(b) * g.c + static_cast<long long>(grp) * cpg) * hw +
      static_cast<long long>(y) * g.w;
  const T* lrow = left + in_off;
  const T* rrow = right + in_off;
  T* orow = out + (static_cast<long long>(b) * g.groups + grp) * g.dmax * hw +
            static_cast<long long>(y) * g.w + x0;
  const float n = static_cast<float>(cpg), inv = 1.f / n;
  constexpr bool pow2 = CPG > 0 && (CPG & (CPG - 1)) == 0;  // then a · inv is a / n
  const int dbeg = dc * g.ds, dend = min(dbeg + g.ds, g.dmax);
  for (int d0 = dbeg; d0 < dend; d0 += V) {
    float acc[V][V];
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[j][k] = 0.f;
#pragma unroll 2
    for (int ch = 0; ch < cpg; ++ch) {
      float lf[V], win[2 * V];  // win[i]: right position x0 − d0 − V + i
      load_run<T, VEC>(lrow + ch * hw, x0, g.w, lf);
      load_run<T, VEC>(rrow + ch * hw, x0 - d0 - V, g.w, win);
      load_run<T, VEC>(rrow + ch * hw, x0 - d0, g.w, win + V);
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int k = 0; k < V; ++k) acc[j][k] = fmaf(lf[k], win[k - j + V], acc[j][k]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int d = d0 + j;
      if (d >= dend) break;
      float v[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        v[k] = x0 + k < d ? 0.f : pow2 ? acc[j][k] * inv : div_cpg(acc[j][k], n, inv);
      T* o = orow + d * hw;
      if constexpr (VEC) {
        uint4 u;
        if constexpr (sizeof(T) == 2) {
          u = make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
                         bf16x2(v[6], v[7]));
        } else {
          u = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                         __float_as_uint(v[3]));
        }
        __stcs(reinterpret_cast<uint4*>(o), u);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (x0 + k < g.w) o[k] = from_f32<T>(v[k]);
      }
    }
  }
}

template <typename T, bool VEC>
const void* gwc_fn(int cpg) {
  switch (cpg) {
    case 1: return reinterpret_cast<const void*>(gwc_ncdhw_kernel<T, 1, VEC>);
    case 2: return reinterpret_cast<const void*>(gwc_ncdhw_kernel<T, 2, VEC>);
    case 3: return reinterpret_cast<const void*>(gwc_ncdhw_kernel<T, 3, VEC>);
    case 4: return reinterpret_cast<const void*>(gwc_ncdhw_kernel<T, 4, VEC>);
    case 6: return reinterpret_cast<const void*>(gwc_ncdhw_kernel<T, 6, VEC>);
    case 8: return reinterpret_cast<const void*>(gwc_ncdhw_kernel<T, 8, VEC>);
    case 12: return reinterpret_cast<const void*>(gwc_ncdhw_kernel<T, 12, VEC>);
    case 16: return reinterpret_cast<const void*>(gwc_ncdhw_kernel<T, 16, VEC>);
    default: return reinterpret_cast<const void*>(gwc_ncdhw_kernel<T, 0, VEC>);
  }
}

template <typename T>
const void* gwc_fn(int cpg, bool vec) {
  return vec ? gwc_fn<T, true>(cpg) : gwc_fn<T, false>(cpg);
}

// The rule, from the H100's times at the ACV and IGEV module paths' shapes
// (PERF.md): three steps of V disparities an item (24 bf16; all of D when
// that is less) and 128 threads a block.  At ACV one step an item read 25%
// slower, all 48 disparities 3% slower, 256 or 512 threads 4-9% slower; at
// IGEV 256 or 512 threads read 3% faster.  vec when W is a multiple of V
// and both tensors are 16-byte aligned (`aligned`).
// force_ds > 0 (rounded up to a multiple of V) and force_threads > 0 take
// those instead (for timing).
template <typename T>
cudaError_t gwc_plan(int b, int c, int h, int w, int groups, int d, bool aligned, int force_ds,
                     int force_threads, int device, GwcPlan& p) {
  constexpr int V = 16 / sizeof(T);
  if (b < 1 || h < 1 || w < 1 || d < 1 || groups < 1 || c % groups) return cudaErrorInvalidValue;
  p.tw = V;
  p.ds = min(force_ds > 0 ? ceil_div(force_ds, V) * V : 3 * V, ceil_div(d, V) * V);
  p.vec = aligned && w % V == 0;
  p.threads = force_threads > 0 ? force_threads : 128;
  if (p.threads % 32 || p.threads > kGwcMaxThreads) return cudaErrorInvalidValue;
  const long long items =
      static_cast<long long>(b) * groups * h * ceil_div(w, V) * ceil_div(d, p.ds);
  if (items > (1LL << 31) - 1) return cudaErrorInvalidValue;
  p.items = static_cast<int>(items);
  p.blocks = ceil_div(items, p.threads);
  p.smem_bytes = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.blocks_per_sm,
                                                       gwc_fn<T>(c / groups, p.vec), p.threads, 0);
}

template <typename T>
int launch(const void* left, const void* right, void* out, const GwcPlan& p, int b, int c, int h,
           int w, int groups, int dmax, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  GwcGeom g{c, h, w, groups, c / groups, dmax, p.ds, ceil_div(w, V), ceil_div(dmax, p.ds),
            p.items};
  auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  if (p.tw != V || p.ds % V || p.ds < 1 || c % groups ||
      static_cast<long long>(b) * groups * h * g.nvec * g.nds != p.items ||
      (p.vec && (w % V || !aligned(left) || !aligned(right) || !aligned(out))))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  T* o = static_cast<T*>(out);
  void* args[] = {&l, &r, &o, &g};
  if (cudaError_t e = cudaLaunchKernel(gwc_fn<T>(g.cpg, p.vec), dim3(p.blocks), dim3(p.threads),
                                       args, 0, stream))
    return static_cast<int>(e);
  return end();
}

// -- the volume in the conv slot ----------------------------------------------

// One shape's plan, in ops/kernels/_build.py SLOT_PLAN_KEYS order: a block
// makes tw W positions × ds disparities of one row (nds blocks split D) from
// a staged left tile and right strip of tw + ds − 1 positions, rows ld
// elements apart, with `threads` threads; `blocks` the grid.
struct SlotPlan {
  int tw, ds, nds, threads, smem_bytes, blocks, ld;
};

constexpr int kSlotMaxDs = 24;       // disparities a block at most
constexpr int kSlotMaxThreads = 512;  // gwc_slot_kernel's launch bound

// The rule, from the H100's times at every path's shape (PERF.md): tiles of
// 32 positions (16 below W 128, 8 below W 64), so that several small blocks
// an SM hide each other's staging; at most kSlotMaxDs disparities a block,
// half of D below that; D split further while the grid would leave SMs
// idle; rows of C + cc channels rounded up to whole 16-byte units, then to
// an odd number of them (neighbouring positions in distinct bank groups);
// one thread a work item (half a 16-byte output vector a position).
// force_tw, force_ds > 0 take that tile instead (for timing).
inline cudaError_t slot_plan(int b, int c, int cc, int h, int w, int d, int slot, int elsize,
                             int force_tw, int force_ds, int device, SlotPlan& p) {
  int sms = 0, optin = 0;
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
    return e;
  if (cudaError_t e =
          cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device))
    return e;
  if ((elsize != 2 && elsize != 4) || d < 1) return cudaErrorInvalidValue;
  const int vec = 16 / elsize;
  p.tw = force_tw > 0 ? force_tw : (w >= 128 ? 32 : (w >= 64 ? 16 : 8));
  auto blocks = [&](int ds) {
    return static_cast<long long>(ceil_div(w, p.tw)) * h * b * ceil_div(d, ds);
  };
  if (force_ds > 0) {
    p.ds = force_ds;
  } else {
    p.ds = d >= kSlotMaxDs ? kSlotMaxDs : (d + 1) / 2;
    while (blocks(p.ds) < sms && p.ds > 1) p.ds = (p.ds + 1) / 2;
  }
  int units = (c + cc + vec - 1) / vec;
  if (units % 2 == 0) ++units;
  p.ld = units * vec;
  p.nds = ceil_div(d, p.ds);
  const long long smem = static_cast<long long>(2 * p.tw + p.ds - 1) * p.ld * elsize;
  const int items = p.tw * slot / (8 / elsize);
  p.threads = items < kSlotMaxThreads ? ceil_div(items, 32) * 32 : kSlotMaxThreads;
  p.smem_bytes = static_cast<int>(smem);
  p.blocks = static_cast<int>(blocks(p.ds));
  if (p.tw < 4 || p.tw % 4 || p.ds < 1 || smem > optin) return cudaErrorInvalidValue;
  return cudaSuccess;
}

struct SlotGeom {
  int c, cc, groups, slot, dmax, h, w, mask_ref;
  int tw, ds, nds, ld, chunk;  // from the plan; ld: staged row stride in elements
};

// N elements at p (8·k bytes, aligned to 16 when a multiple of 16) → float32.
template <typename T, int N>
__device__ __forceinline__ void lds_f32(const T* p, float (&f)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes % 8 == 0, "whole 8-byte units");
  unsigned u[kBytes / 4];
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      u[4 * i] = v.x, u[4 * i + 1] = v.y, u[4 * i + 2] = v.z, u[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[i];
      u[2 * i] = v.x, u[2 * i + 1] = v.y;
    }
  }
#pragma unroll
  for (int i = 0; i < kBytes / 4; ++i) {
    if constexpr (sizeof(T) == 2) {
      f[2 * i] = bf16_lo(u[i]);
      f[2 * i + 1] = bf16_hi(u[i]);
    } else {
      f[i] = __uint_as_float(u[i]);
    }
  }
}

// 8 bytes of T (4 bf16 or 2 float32) from float32 values, rounded once.
template <typename T>
__device__ __forceinline__ uint2 pack8(const float* v) {
  if constexpr (sizeof(T) == 2) {
    auto b = [](float x) {
      return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(x)));
    };
    return make_uint2(b(v[0]) | b(v[1]) << 16, b(v[2]) | b(v[3]) << 16);
  } else {
    return make_uint2(__float_as_uint(v[0]), __float_as_uint(v[1]));
  }
}

template <typename T, int CPG>
__global__ void __launch_bounds__(kSlotMaxThreads)
    gwc_slot_kernel(const T* __restrict__ left, const T* __restrict__ right,
                    const T* __restrict__ cat_l, const T* __restrict__ cat_r,
                    T* __restrict__ out, SlotGeom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kHalf = kVec / 2;  // groups a thread makes: 8 output bytes
  T* ls = reinterpret_cast<T*>(smem_raw);  // (tw, ld): the left tile
  T* rs = ls + g.tw * g.ld;                // (tw + ds − 1, ld): the right strip
  const int w0 = blockIdx.x * g.tw;
  const int y = blockIdx.y;
  const int b = blockIdx.z / g.nds;
  const int d0 = (blockIdx.z % g.nds) * g.ds;
  const int dend = min(d0 + g.ds, g.dmax);
  // Right position x − d lies at strip row (x − w0) + d0 + ds − 1 − d.
  // The C feature channels then the cc concat channels (stage.cuh).
  stage_rows(ls, g.ld, w0, g.tw, left, g.c, cat_l, g.cc, b, y, g.h, g.w, g.chunk);
  stage_rows(rs, g.ld, w0 - d0 - g.ds + 1, g.tw + g.ds - 1, right, g.c, cat_r, g.cc, b, y, g.h,
             g.w, g.chunk);
  __syncthreads();

  // Work items: the group half-vectors (in pairs: quarter-warps take 4
  // positions × 2 halves), then the rest of the slot, half a vector each.
  const int nhv = (g.groups / kHalf) & ~1;
  const int nvp = nhv / 2;
  const int ntail = g.slot / kHalf - nhv;
  const int n_gwc = g.tw * nhv;
  const int n_items = n_gwc + g.tw * ntail;
  const size_t dstride = static_cast<size_t>(g.h) * g.w * g.slot;
  const float n = static_cast<float>(CPG);
  for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
    int pos, hv;
    if (it < n_gwc) {
      const int rest = it >> 3;
      pos = 4 * (rest / nvp) + ((it >> 1) & 3);
      hv = 2 * (rest % nvp) + (it & 1);
    } else {
      pos = (it - n_gwc) / ntail;
      hv = nhv + (it - n_gwc) % ntail;
    }
    const int x = w0 + pos;
    if (x >= g.w) continue;
    T* o = out + (((static_cast<size_t>(b) * g.dmax + d0) * g.h + y) * g.w + x) * g.slot +
           hv * kHalf;
    const T* lrow = ls + pos * g.ld;
    const T* rrow = rs + (pos + d0 + g.ds - 1) * g.ld;  // at d = 0; minus d rows
    if (it < n_gwc) {
      float lf[kHalf * CPG];
      lds_f32<T, kHalf * CPG>(lrow + hv * kHalf * CPG, lf);
      for (int d = d0; d < dend; ++d, o += dstride) {
        float v[kHalf];
        if (x >= d) {
          float rf[kHalf * CPG];
          lds_f32<T, kHalf * CPG>(rrow - d * g.ld + hv * kHalf * CPG, rf);
#pragma unroll
          for (int k = 0; k < kHalf; ++k) {
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < CPG; ++j) s = fmaf(lf[k * CPG + j], rf[k * CPG + j], s);
            v[k] = s / n;
          }
        } else {
#pragma unroll
          for (int k = 0; k < kHalf; ++k) v[k] = 0.f;
        }
        *reinterpret_cast<uint2*>(o) = pack8<T>(v);
      }
    } else {
      for (int d = d0; d < dend; ++d, o += dstride) {
        const bool valid = x >= d;
        const T* r = rrow - d * g.ld;
        float v[kHalf];
#pragma unroll
        for (int k = 0; k < kHalf; ++k) {
          const int ch = hv * kHalf + k;
          float val = 0.f;
          if (ch < g.groups) {  // groups past the last whole pair of half-vectors
            if (valid) {
              float s = 0.f;
#pragma unroll
              for (int j = 0; j < CPG; ++j)
                s = fmaf(to_f32(lrow[ch * CPG + j]), to_f32(r[ch * CPG + j]), s);
              val = s / n;
            }
          } else if (ch < g.groups + g.cc) {
            if (valid || !g.mask_ref) val = to_f32(lrow[g.c + ch - g.groups]);
          } else if (ch < g.groups + 2 * g.cc) {
            if (valid) val = to_f32(r[g.c + ch - g.groups - g.cc]);
          }
          v[k] = val;
        }
        *reinterpret_cast<uint2*>(o) = pack8<T>(v);
      }
    }
  }
}

template <typename T, int CPG>
int launch_slot_cpg(const void* left, const void* right, const void* cat_l, const void* cat_r,
                    void* out, int b, const SlotGeom& g, const SlotPlan& p,
                    cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(gwc_slot_kernel<T, CPG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       p.smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(ceil_div(g.w, g.tw), g.h, b * g.nds);
  gwc_slot_kernel<T, CPG><<<grid, p.threads, p.smem_bytes, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right), static_cast<const T*>(cat_l),
      static_cast<const T*>(cat_r), static_cast<T*>(out), g);
  return end();
}

inline bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch_slot(const void* left, const void* right, const void* cat_l, const void* cat_r,
                void* out, int b, SlotGeom g, const SlotPlan& p, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  g.tw = p.tw, g.ds = p.ds, g.nds = p.nds, g.ld = p.ld;
  const bool vec = (static_cast<long long>(g.h) * g.w) % kVec == 0 && aligned16(left) &&
                   aligned16(right) && aligned16(cat_l) && aligned16(cat_r);
  g.chunk = vec ? kVec : 1;
  switch (g.c / g.groups) {
    case 1: return launch_slot_cpg<T, 1>(left, right, cat_l, cat_r, out, b, g, p, stream);
    case 2: return launch_slot_cpg<T, 2>(left, right, cat_l, cat_r, out, b, g, p, stream);
    case 3: return launch_slot_cpg<T, 3>(left, right, cat_l, cat_r, out, b, g, p, stream);
    case 4: return launch_slot_cpg<T, 4>(left, right, cat_l, cat_r, out, b, g, p, stream);
    case 6: return launch_slot_cpg<T, 6>(left, right, cat_l, cat_r, out, b, g, p, stream);
    case 8: return launch_slot_cpg<T, 8>(left, right, cat_l, cat_r, out, b, g, p, stream);
    case 12: return launch_slot_cpg<T, 12>(left, right, cat_l, cat_r, out, b, g, p, stream);
    case 16: return launch_slot_cpg<T, 16>(left, right, cat_l, cat_r, out, b, g, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace dv

// The plan (GwcPlan's ints) of the NCDHW volume for a shape: dtype code,
// whether both features are 16-byte aligned, a forced disparities an item
// and threads a block (0: the rule's), device.
DV_EXPORT int dv_gwc_plan(int b, int c, int h, int w, int groups, int d, int dtype, int aligned,
                          int ds, int threads, int device, int* plan) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  dv::GwcPlan p;
  cudaError_t e = dtype == dv::kBF16
                      ? dv::gwc_plan<__nv_bfloat16>(b, c, h, w, groups, d, aligned, ds, threads,
                                                    device, p)
                      : dv::gwc_plan<float>(b, c, h, w, groups, d, aligned, ds, threads, device, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::memcpy(plan, &p, sizeof p);
  return 0;
}

// `plan`: dv_gwc_plan's for this shape, dtype and device.
DV_EXPORT int dv_gwc_volume(const void* left, const void* right, void* out, const int* plan,
                            int b, int c, int h, int w, int groups, int d, int dtype, int device,
                            void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  dv::GwcPlan p;
  std::memcpy(&p, plan, sizeof p);
  if (dtype == dv::kBF16)
    return dv::launch<__nv_bfloat16>(left, right, out, p, b, c, h, w, groups, d, s);
  return dv::launch<float>(left, right, out, p, b, c, h, w, groups, d, s);
}

// The plan (SlotPlan's ints) of the volume in the slot for a shape: dtype
// code, a forced tile (tw, ds; 0: the rule's), device.
DV_EXPORT int dv_gwc_slot_plan(int b, int c, int cc, int h, int w, int d, int slot, int dtype,
                               int tw, int ds, int device, int* plan) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  dv::SlotPlan p;
  const int elsize = dtype == dv::kBF16 ? 2 : 4;
  if (cudaError_t e = dv::slot_plan(b, c, cc, h, w, d, slot, elsize, tw, ds, device, p))
    return static_cast<int>(e);
  std::memcpy(plan, &p, sizeof p);
  return 0;
}

// `plan`: dv_gwc_slot_plan's for this shape, dtype and device.
DV_EXPORT int dv_gwc_volume_slot(const void* left, const void* right, const void* cat_l,
                                 const void* cat_r, void* out, const int* plan, int b, int c,
                                 int cc, int h, int w, int groups, int d, int slot, int mask_ref,
                                 int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  dv::SlotPlan p;
  std::memcpy(&p, plan, sizeof p);
  const dv::SlotGeom g{c, cc, groups, slot, d, h, w, mask_ref, 0, 0, 0, 0, 0};
  if (dtype == dv::kBF16)
    return dv::launch_slot<__nv_bfloat16>(left, right, cat_l, cat_r, out, b, g, p, s);
  return dv::launch_slot<float>(left, right, cat_l, cat_r, out, b, g, p, s);
}
