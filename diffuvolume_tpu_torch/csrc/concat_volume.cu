// The concat cost volume and the per-step conditioning multiply.
//
// dv_concat_volume: out (B, 2C, D, H, W) with
//   out[:, c,     d, h, w] = cl[:, c, h, w]                         (every d)
//   out[:, C + c, d, h, w] = cr[:, c, h, w - d] if w >= d else 0
// times att[:, d, h, w] when it is given (the baseline's attention-weighted
// volume; the DDIM prep builds it without att, once per pair).
//   Replaces diffuvolume_tpu/ops/pallas/conv3d.py:pack_concat_k.
//   Plain version: ops/cost_volume.py concat_volume_mul.
//
// dv_dhw_mul: out = vol (B, C, D, H, W) × (m1 ⊙ m2) (B, D, H, W), the map
// broadcast over channels (the ACV DDIM step's attention × noise); m2 may be
// null, and then the map is m1 alone (the PCW step's noise on its 32-channel
// combine volume).
//   Replaces diffuvolume_tpu/ops/pallas/conv3d.py:packed_dhw_mul_k.
//   Plain version: ops/cost_volume.py volume_dhw_mul.
//
// Channels-last forms (the folded path's conv kernels read NDHWC):
// dv_concat_volume_cl writes out (B, D, H, W, 2C) with the same values, and
// dv_dhw_mul_cl multiplies vol (B, D, H, W, C) by the (B, D, H, W) maps
// broadcast over the innermost C.  Both move 16 bytes of channels a thread,
// so both need C (a side's, for the concat) in whole 16-byte vectors; the
// wrappers refuse any other C.
//
// What bounds them on the H100: both stream.  At the main path (C=32 per
// side, D=48, 128×240, bf16) the build writes 189 MB (about 56 µs at
// 3.35 TB/s) and the multiply reads and writes 189 MB each (about 113 µs);
// each does at most one multiply per element (plus att·noise once per map
// position in the multiply).
//
// Design, NCDHW.  The TPU kernels write a lane-packed, halo-padded layout
// that its conv kernels read; here the output is the plain NCDHW volume that
// F.conv3d reads.  A thread owns one (b, channel, h, w) or (b, d, h, w)
// position and walks the other axis: the build loads its left feature once
// and writes it D times (the right half loads the shifted feature per d);
// the multiply loads m1 ⊙ m2 once and applies it to all C channels.  Along
// a warp the threads hold consecutive w, so every load and store is
// contiguous.  Products are taken in float32 in the order (m1·m2)·v and
// rounded once, so the results equal the plain versions bit for bit.
//
// Design, the channels-last concat (row 3 on the folded path).  A plane's
// row of outputs is W·2C contiguous elements, so the volume is written as
// whole 16-byte vectors, warp after warp over contiguous bytes.  The work
// is split into equal items, (b, h, a W tile of tw positions, a range of ds
// disparities), walked by a persistent grid sized from the SM count and the
// occupancy (concat_plan_t below: tw a divisor of W, 60 at the ACV shape, so
// no tile is part empty; D split only where the items would not fill the
// grid, or to even out its rounds).  An item stages its left tile and the
// right strip its shifts reach (tw + ds − 1 positions) once, in the output
// dtype and position-major ([x][channel], rows of C unpadded), by 16-byte
// reads transposed in registers (stage.cuh stage_rows, row 16's staging),
// and att's ds × tw values when given.  A thread then owns one 16-byte
// vector of a position's left or right half and walks the item's planes:
// one 16-byte shared-memory read (the right half x − d rows back, zero for
// x < d), with att one float32 multiply an element rounded once (equal to
// the plain version bit for bit), and one 16-byte streaming store
// (st.global.cs: the 189 MB volume is 3.8 times the L2).  Quarter-warps
// take 8 / (C / kVec) positions of one half, so their shared-memory reads
// are 128 contiguous bytes (no bank conflicts), and a warp's stores are
// whole positions.  The registers are held to two blocks of 512 threads an
// SM.  Bulk async copies from a double-buffered shared tile a plane
// (cp.async.bulk) measured slower at every tile than these stores (PERF.md).
#include <cstring>

#include "common.cuh"
#include "stage.cuh"

namespace dv {
namespace {

template <typename T>
__global__ void concat_kernel(const T* __restrict__ cl, const T* __restrict__ cr,
                              const T* __restrict__ att, T* __restrict__ out, int c,
                              int dmax, int h, int w) {
  const size_t hw = static_cast<size_t>(h) * w;
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  if (pos >= hw) return;
  const int ch = blockIdx.y;  // output channel in [0, 2c)
  const int b = blockIdx.z;
  const int x = pos % w;
  const size_t map_off = static_cast<size_t>(b) * dmax * hw + pos;
  T* o = out + (static_cast<size_t>(b) * 2 * c + ch) * dmax * hw + pos;

  float left = 0.f;
  const T* rrow = nullptr;
  if (ch < c) {
    left = to_f32(cl[(static_cast<size_t>(b) * c + ch) * hw + pos]);
  } else {
    rrow = cr + (static_cast<size_t>(b) * c + (ch - c)) * hw + (pos - x);
  }
  for (int d = 0; d < dmax; ++d) {
    float v = rrow ? (x >= d ? to_f32(rrow[x - d]) : 0.f) : left;
    if (att) v = v * to_f32(att[map_off + d * hw]);
    o[d * hw] = from_f32<T>(v);
  }
}

template <typename T>
__global__ void dhw_mul_kernel(const T* __restrict__ vol, const T* __restrict__ m1,
                               const T* __restrict__ m2, T* __restrict__ out, int c,
                               long long dhw) {
  const long long pos = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pos >= dhw) return;
  const int b = blockIdx.y;
  const size_t map_off = static_cast<size_t>(b) * dhw + pos;
  const float m = to_f32(m1[map_off]) * (m2 ? to_f32(m2[map_off]) : 1.f);
  const size_t base = static_cast<size_t>(b) * c * dhw + pos;
#pragma unroll 8
  for (int ch = 0; ch < c; ++ch) {
    const size_t off = base + static_cast<size_t>(ch) * dhw;
    out[off] = from_f32<T>(to_f32(vol[off]) * m);
  }
}

// -- the channels-last concat --------------------------------------------------

// One shape's plan, in ops/kernels/_build.py CONCAT_PLAN_KEYS order: items
// of tw W positions × ds disparities of one (b, h) row, `items` of them
// walked by `blocks` blocks of `threads` (blocks_per_sm of them fit an SM),
// smem_bytes of shared memory a block.
struct ConcatPlan {
  int tw, ds, items, threads, blocks, blocks_per_sm, smem_bytes;
};

constexpr int kConcatMaxThreads = 512;
constexpr int kConcatMinBlocks = 2;  // blocks an SM the registers must allow

struct ConcatGeom {
  int c, dmax, h, w;
  int tw, ds, nwt, nds, chunk;  // from the plan; nwt W tiles a row, nds D ranges
};

// Shared memory a block: the left tile and the right strip, then att's
// rows from a 16-byte boundary.
__host__ __device__ inline long long concat_smem(int c, int tw, int ds, int elsize, bool att) {
  const long long feat = (static_cast<long long>(2 * tw + ds - 1) * c * elsize + 15) / 16 * 16;
  return feat + (att ? static_cast<long long>(ds) * tw * elsize : 0);
}

template <typename T>
__device__ __forceinline__ uint4 scaled(uint4 v, float a) {
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int k = 0; k < 16 / static_cast<int>(sizeof(T)); ++k) e[k] = from_f32<T>(to_f32(e[k]) * a);
  return v;
}

template <typename T, bool ATT>
__global__ void __launch_bounds__(kConcatMaxThreads, kConcatMinBlocks)
    concat_cl_kernel(const T* __restrict__ cl, const T* __restrict__ cr,
                     const T* __restrict__ att, T* __restrict__ out, ConcatGeom g, int items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = 16 / sizeof(T);
  T* ls = reinterpret_cast<T*>(smem_raw);  // (tw, c): the left tile
  T* rs = ls + g.tw * g.c;                 // (tw + ds − 1, c): the right strip
  T* as = reinterpret_cast<T*>(smem_raw + concat_smem(g.c, g.tw, g.ds, sizeof(T), false));
  const int nvs = g.c / kVec;                    // 16-byte vectors a half
  const int gx = nvs < 8 ? max(8 / nvs, 1) : 1;  // positions a quarter-warp takes of one half
  const int per = gx * nvs;
  const int ipp = (g.tw + gx - 1) / gx * 2 * per;  // work items a plane
  const int c2 = 2 * g.c;
  const size_t hw = static_cast<size_t>(g.h) * g.w;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int dc = item % g.nds;
    const int wt = (item / g.nds) % g.nwt;
    const int y = (item / (g.nds * g.nwt)) % g.h;
    const int b = item / (g.nds * g.nwt * g.h);
    const int w0 = wt * g.tw, d0 = dc * g.ds, dend = min(d0 + g.ds, g.dmax);
    const long long row = static_cast<long long>(y) * g.w;
    // Right position x − d lies at strip row (x − w0) + d0 + ds − 1 − d.
    const T* none = nullptr;  // no concat channels
    stage_rows(ls, g.c, w0, g.tw, cl, g.c, none, 0, b, y, g.h, g.w, g.chunk);
    stage_rows(rs, g.c, w0 - d0 - g.ds + 1, g.tw + g.ds - 1, cr, g.c, none, 0, b, y, g.h, g.w,
               g.chunk);
    if constexpr (ATT) {
      const T* ab = att + (static_cast<size_t>(b) * g.dmax + d0) * hw + row + w0;
      for (int i = threadIdx.x; i < (dend - d0) * g.tw; i += blockDim.x) {
        const int dd = i / g.tw, xl = i - dd * g.tw;
        as[i] = w0 + xl < g.w ? ab[dd * hw + xl] : from_f32<T>(0.f);
      }
    }
    __syncthreads();
    // Work item j → (position xl, half, vector k): quarter-warps take gx
    // positions × nvs vectors of one half.
    for (int j = threadIdx.x; j < ipp; j += blockDim.x) {
      const int grp = j / (2 * per), r = j - grp * 2 * per;
      const int half = r / per, q = r - half * per;
      const int xl = grp * gx + q / nvs, k = q % nvs;
      const int x = w0 + xl;
      if (xl >= g.tw || x >= g.w) continue;
      // The left half reads its one row every plane; the right half steps
      // back a row a plane.
      const T* src = (half ? rs + (xl + g.ds - 1) * g.c : ls + xl * g.c) + k * kVec;
      const int step = half ? g.c : 0;
      T* o = out + ((static_cast<size_t>(b) * g.dmax + d0) * hw + row + x) * c2 + half * g.c +
             k * kVec;
      for (int d = d0; d < dend; ++d, src -= step, o += hw * c2) {
        uint4 v = (!half || x >= d) ? *reinterpret_cast<const uint4*>(src)
                                    : make_uint4(0, 0, 0, 0);
        if constexpr (ATT) v = scaled<T>(v, to_f32(as[(d - d0) * g.tw + xl]));
        __stcs(reinterpret_cast<uint4*>(o), v);
      }
    }
    __syncthreads();  // the tiles are read before the next item restages them
  }
}

template <typename T>
const void* concat_cl_fn(bool att) {
  return att ? reinterpret_cast<const void*>(concat_cl_kernel<T, true>)
             : reinterpret_cast<const void*>(concat_cl_kernel<T, false>);
}

// The W tile: the largest divisor of W in [16, 64] that is a multiple of 4
// (60 of the ACV shape's 240), else 32 (the last tile part empty).
inline int concat_tile(int w) {
  for (int t = 64; t >= 16; t -= 4)
    if (w % t == 0) return t;
  return w < 32 ? (w + 3) / 4 * 4 : 32;
}

// The rule: tiles of concat_tile(W); a work item all of D, split in k
// ranges (k = 2, 3, … 8) while the items leave over half the grid idle or
// their rounds on the grid fill it less than 90%; threads: one a work item
// of a plane, at most kConcatMaxThreads; blocks: the wave the occupancy
// allows, or one an item where the items are fewer.  force_* > 0 take that
// tile, D range or grid instead.
template <typename T>
cudaError_t concat_plan_t(int b, int c, int h, int w, int d, bool att, int force_tw,
                          int force_ds, int force_blocks, int device, ConcatPlan& p) {
  constexpr int kVec = 16 / sizeof(T);
  int sms = 0, optin = 0;
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
    return e;
  if (cudaError_t e =
          cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device))
    return e;
  if (c % kVec || c < kVec || d < 1 || w < 1 || h < 1 || b < 1) return cudaErrorInvalidValue;
  const int nvs = c / kVec;
  const int gx = nvs < 8 ? max(8 / nvs, 1) : 1;
  p.tw = force_tw > 0 ? force_tw : concat_tile(w);
  const int ipp = (p.tw + gx - 1) / gx * gx * 2 * nvs;
  p.threads = min((ipp + 31) / 32 * 32, kConcatMaxThreads);
  const long long rows = static_cast<long long>(b) * h * ceil_div(w, p.tw);
  const void* fn = concat_cl_fn<T>(att);
  // Blocks an SM at D range ds.
  auto fits = [&](int ds, int& bps) -> cudaError_t {
    const long long smem = concat_smem(c, p.tw, ds, sizeof(T), att);
    if (smem > optin) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      if (cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)))
        return e;
    }
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fn, p.threads,
                                                         static_cast<size_t>(smem));
  };
  int bps = 0;
  p.ds = force_ds > 0 ? force_ds : d;
  if (cudaError_t e = fits(p.ds, bps)) return e;
  if (force_ds <= 0) {
    const long long cap = static_cast<long long>(sms) * max(bps, 1);
    auto fill = [&](int ds) {
      const long long n = rows * ceil_div(d, ds);
      const long long rounds = (n + cap - 1) / cap;
      return rounds == 1 ? (2 * n >= cap ? 1.0 : static_cast<double>(n) / cap)
                         : static_cast<double>(n) / (rounds * cap);
    };
    for (int k = 2; k <= 8 && fill(p.ds) < 0.9; ++k) {
      const int ds = ceil_div(d, k);
      if (ds < p.ds && fill(ds) > fill(p.ds)) p.ds = ds;
    }
    if (cudaError_t e = fits(p.ds, bps)) return e;
  }
  p.blocks_per_sm = bps;
  if (bps < 1) return cudaErrorInvalidConfiguration;
  p.smem_bytes = static_cast<int>(concat_smem(c, p.tw, p.ds, sizeof(T), att));
  const long long n = rows * ceil_div(d, p.ds);
  p.items = static_cast<int>(n);
  const long long cap = static_cast<long long>(sms) * bps;
  p.blocks = force_blocks > 0 ? force_blocks : static_cast<int>(n < cap ? n : cap);
  return cudaSuccess;
}

template <typename T>
int launch_concat_cl(const void* cl, const void* cr, const void* att, void* out,
                     const ConcatPlan& p, int b, int c, int dmax, int h, int w,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  if (!aligned(out) || c % kVec) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (static_cast<long long>(h) * w) % kVec == 0 && aligned(cl) && aligned(cr);
  const ConcatGeom g{c, dmax, h, w, p.tw, p.ds, ceil_div(w, p.tw), ceil_div(dmax, p.ds),
                     vec ? kVec : 1};
  if (p.smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(concat_cl_fn<T>(att != nullptr),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto kern = att ? concat_cl_kernel<T, true> : concat_cl_kernel<T, false>;
  kern<<<p.blocks, p.threads, p.smem_bytes, stream>>>(
      static_cast<const T*>(cl), static_cast<const T*>(cr), static_cast<const T*>(att),
      static_cast<T*>(out), g, p.items);
  return end();
}

// Channels-last multiply: one thread per 16 bytes of one position's channels.
template <typename T>
__global__ void dhw_mul_cl_kernel(const T* __restrict__ vol, const T* __restrict__ m1,
                                  const T* __restrict__ m2, T* __restrict__ out, int c,
                                  long long positions) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = c / kVec;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= positions * nvec) return;
  const long long pos = i / nvec;
  const float m = to_f32(m1[pos]) * (m2 ? to_f32(m2[pos]) : 1.f);
  const size_t off = static_cast<size_t>(pos) * c + static_cast<size_t>(i % nvec) * kVec;
  uint4 raw = *reinterpret_cast<const uint4*>(vol + off);
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = from_f32<T>(to_f32(v[k]) * m);
  *reinterpret_cast<uint4*>(out + off) = raw;
}

constexpr int kThreads = 256;

template <typename T>
int launch_mul_cl(const void* vol, const void* m1, const void* m2, void* out, int b, int c,
                  long long dhw, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long positions = static_cast<long long>(b) * dhw;
  dhw_mul_cl_kernel<T><<<ceil_div(positions * (c / kVec), kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(vol), static_cast<const T*>(m1), static_cast<const T*>(m2),
      static_cast<T*>(out), c, positions);
  return end();
}

template <typename T>
int launch_concat(const void* cl, const void* cr, const void* att, void* out, int b, int c,
                  int dmax, int h, int w, cudaStream_t stream) {
  dim3 grid(ceil_div(static_cast<long long>(h) * w, kThreads), 2 * c, b);
  concat_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(cl), static_cast<const T*>(cr), static_cast<const T*>(att),
      static_cast<T*>(out), c, dmax, h, w);
  return end();
}

template <typename T>
int launch_mul(const void* vol, const void* m1, const void* m2, void* out, int b, int c,
               long long dhw, cudaStream_t stream) {
  dim3 grid(ceil_div(dhw, kThreads), b);
  dhw_mul_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(vol),
                                                   static_cast<const T*>(m1),
                                                   static_cast<const T*>(m2),
                                                   static_cast<T*>(out), c, dhw);
  return end();
}

}  // namespace
}  // namespace dv

DV_EXPORT int dv_concat_volume(const void* cl, const void* cr, const void* att, void* out,
                               int b, int c, int d, int h, int w, int dtype, int device,
                               void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16)
    return dv::launch_concat<__nv_bfloat16>(cl, cr, att, out, b, c, d, h, w, s);
  return dv::launch_concat<float>(cl, cr, att, out, b, c, d, h, w, s);
}

DV_EXPORT int dv_dhw_mul(const void* vol, const void* m1, const void* m2, void* out, int b,
                         int c, long long dhw, int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16) return dv::launch_mul<__nv_bfloat16>(vol, m1, m2, out, b, c, dhw, s);
  return dv::launch_mul<float>(vol, m1, m2, out, b, c, dhw, s);
}

// The plan (ConcatPlan's ints) of the channels-last concat for a shape:
// att given or not, dtype code, a forced tile, D range and grid (0: the
// rule's), device.
DV_EXPORT int dv_concat_plan(int b, int c, int h, int w, int d, int att, int dtype, int tw,
                             int ds, int blocks, int device, int* plan) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  dv::ConcatPlan p;
  cudaError_t e =
      dtype == dv::kBF16
          ? dv::concat_plan_t<__nv_bfloat16>(b, c, h, w, d, att, tw, ds, blocks, device, p)
          : dv::concat_plan_t<float>(b, c, h, w, d, att, tw, ds, blocks, device, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::memcpy(plan, &p, sizeof p);
  return 0;
}

// `plan`: dv_concat_plan's for this shape, att, dtype and device.
DV_EXPORT int dv_concat_volume_cl(const void* cl, const void* cr, const void* att, void* out,
                                  const int* plan, int b, int c, int d, int h, int w, int dtype,
                                  int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  dv::ConcatPlan p;
  std::memcpy(&p, plan, sizeof p);
  if (dtype == dv::kBF16)
    return dv::launch_concat_cl<__nv_bfloat16>(cl, cr, att, out, p, b, c, d, h, w, s);
  return dv::launch_concat_cl<float>(cl, cr, att, out, p, b, c, d, h, w, s);
}

DV_EXPORT int dv_dhw_mul_cl(const void* vol, const void* m1, const void* m2, void* out, int b,
                            int c, long long dhw, int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16)
    return dv::launch_mul_cl<__nv_bfloat16>(vol, m1, m2, out, b, c, dhw, s);
  return dv::launch_mul_cl<float>(vol, m1, m2, out, b, c, dhw, s);
}
