// Per-channel dilated (1, 3, 3) stencils on a channels-last volume:
//   out[b, d, h, w, c] = Σ_{i, j ∈ {0,1,2}} wt[i, j, c] ·
//                        x[b, d, h + (i − 1)·dil[c], w + (j − 1)·dil[c], c]
// with zero padding in H and W only: a tap never reaches another d plane.
// No bias.  x, out (B, D, H, W, C); wt (3, 3, C) float32; dil (C,) int32.
//   Replaces diffuvolume_tpu/ops/pallas/conv3d.py:depthwise_hw_p (the ACV
//   patch convs: `patch` on all 40 channels at dilation 1, then `patch_l1/
//   l2/l3` on channels 0–7, 8–23, 24–39 at dilations 1, 2, 3; the 48-slot's
//   fill channels carry zero weights and stay zero).
//   Plain version: ops/kernels/depthwise.py depthwise_hw_plain.
// dv_depthwise_hw2 applies two such stencils back to back in one launch
// (`patch`, then `patch_l123`), rounding the intermediate to the volume's
// dtype exactly as two launches do.  Plain version: depthwise_hw_plain2.
//
// What bounds it on the H100: bytes.  The ACV volume (1, 48, 128, 240, 48)
// bf16 is read once and written once, 2 × 141.6 MB (about 85 µs at 3.35
// TB/s) for one stencil or for the fused pair; the 9 multiply-adds an
// element (0.6 G a stencil) are about 9 µs of float32 work, but each also
// costs a conversion and shared-memory bandwidth.
//
// Design.  The TPU kernel lays the weights on diagonal 128×128 matrices so
// that its shifted windows feed the MXU; here a stencil is shifted 16-byte
// shared-memory loads.  W tiles of `tw` positions cut each (b, d) plane into
// columns of H rows; a persistent grid (plan() below) gives each block an
// equal share of (column, row) pairs,
// which it walks one row a step: each step copies one input row of the tile
// and its halo (contiguous in the channels-last volume) into a ring of rows
// in shared memory by `cp.async` (16 bytes a thread; rows and positions
// outside the image zero-filled, so the stencils need no bounds checks),
// two rows ahead, so each input row crosses L2 once; the rings restart only
// where a block moves to another column.  A warp owns one 16-byte channel
// vector (one dilation, checked on the host) of one stage; each lane makes
// a run of kRun outputs spaced by the dilation, so each input vector is
// loaded and converted once for up to three outputs (9 loads and 72
// conversions an output become 4.5 and 36 at runs of 4).  A position's
// 16-byte units lie at q·ldu + skew·⌊q/4⌋ (ldu odd, skew_for below),
// which puts a quarter-warp's lanes in distinct bank groups, or nearly so.  The weights sit in shared memory,
// read a tap row at a time (one broadcast a warp).  Everything a step
// repeats (the warp's dilation, its lanes' positions, the copies' addresses)
// is worked out before the step loop, and ring slots advance without a
// division: with one block an SM, a step's latency is the kernel's time.
// One stencil: output row t − 2·dil_max, staged in shared memory and stored
// a step later, consecutive threads storing consecutive 16 bytes.  Fused:
// half the warps make intermediate row t − 2·dil1_max (rounded into a ring
// of 2·dil2_max + 2 rows, zero outside the image), the other half output
// row t − 2·(dil1_max + dil2_max) − 1 from it, stored from registers (the
// rings leave no room to stage it); one barrier a step.  Sums in float32 in
// tap order, rounded once a stencil.
#include <cstring>

#include "common.cuh"

namespace dv {
namespace {

struct DwGeom {
  int h, w, c, tw, cols, dm1, dm2;  // cols: (b, d) planes × W tiles
  int ldu, skew;  // a position's stride and skew in 16-byte units
};

constexpr int kPrefetch = 2;  // input rows in flight ahead of the one in use
constexpr int kRun = 4;       // outputs a lane makes along W, spaced by the dilation
// Threads a block at most: bf16 lanes hold about 100 registers, float32
// ones fewer.
template <typename T> constexpr int kMaxThreads = sizeof(T) == 4 ? 1024 : 512;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The skew of a staged row of odd stride ldu (16-byte units): a quarter-warp's
// 8 lanes, each at the start of its run of kRun outputs at dilation 1, 2 or
// 3, load positions whose units q·ldu + skew·⌊q/4⌋ fall in distinct bank
// groups (8 of 16 bytes) at dilation 1 and meet the fewest conflicts at 2
// and 3; of the 8 skews, (ldu + 4) mod 8 is that one for every odd ldu
// (tests/test_torch_front_plan.py repeats the search).
inline int skew_for(int ldu) { return (ldu + 4) & 7; }

// The 16-byte units of the first n positions of a staged row, and the first
// unit of position q: q·ldu + skew·⌊q/4⌋.
__host__ __device__ inline int row_units(int n, int ldu, int skew) {
  return n * ldu + skew * ((n + 3) / 4);
}
__device__ __forceinline__ int pos_unit(int q, const DwGeom& g) {
  return q * g.ldu + g.skew * (q >> 2);
}

// kRun outputs of one stencil at positions at, at + dl, … of the three tap
// rows rows[i] (unit pointers already offset to the warp's channel vector);
// wt: the warp's float32 weights, tap (i, j) at wt[(i·3 + j)·wstride], kW
// 16-byte units.  Each of the kRun + 2 input vectors a row is loaded and
// converted once and feeds the up to three outputs whose taps reach it;
// each output sums its taps in (i, j) row-major order, as a one-position
// stencil does.
template <typename T, int kVec>
__device__ __forceinline__ void stencil_run(const uint4* const (&rows)[3], int at, int dl,
                                            const uint4* __restrict__ wt, int wstride,
                                            const DwGeom& g, uint4 (&out)[kRun]) {
  constexpr int kW = kVec / 4;  // 16-byte units of weights a tap
  int off[kRun + 2];
#pragma unroll
  for (int m = 0; m < kRun + 2; ++m) off[m] = pos_unit(at + (m - 1) * dl, g);
  float acc[kRun][kVec];
#pragma unroll
  for (int r = 0; r < kRun; ++r)
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[r][k] = 0.f;
#pragma unroll
  for (int ti = 0; ti < 3; ++ti) {
    float w[3][kVec];
#pragma unroll
    for (int tj = 0; tj < 3; ++tj)
#pragma unroll
      for (int q = 0; q < kW; ++q) {
        const uint4 u = wt[(ti * 3 + tj) * wstride + q];
        w[tj][4 * q] = __uint_as_float(u.x), w[tj][4 * q + 1] = __uint_as_float(u.y);
        w[tj][4 * q + 2] = __uint_as_float(u.z), w[tj][4 * q + 3] = __uint_as_float(u.w);
      }
#pragma unroll
    for (int m = 0; m < kRun + 2; ++m) {
      const uint4 raw = rows[ti][off[m]];
      const unsigned u[4] = {raw.x, raw.y, raw.z, raw.w};
      float v[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if constexpr (sizeof(T) == 2) {
          v[k] = __uint_as_float((k & 1) ? (u[k >> 1] & 0xffff0000u) : (u[k >> 1] << 16));
        } else {
          v[k] = __uint_as_float(u[k]);
        }
      }
      // output r takes this vector as its tap j = m − r
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const int tj = m - r;
        if (tj < 0 || tj > 2) continue;
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc[r][k] = fmaf(w[tj][k], v[k], acc[r][k]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if constexpr (sizeof(T) == 2) {
      unsigned o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[k] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(acc[r][2 * k]))) |
               static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(acc[r][2 * k + 1])))
                   << 16;
      }
      out[r] = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      out[r] = make_uint4(__float_as_uint(acc[r][0]), __float_as_uint(acc[r][1]),
                          __float_as_uint(acc[r][2]), __float_as_uint(acc[r][3]));
    }
  }
}

// A lane's run: lane slot `slot` of a row, at dilation dl, starts at
// position (slot / dl)·kRun·dl + slot % dl.
__device__ __forceinline__ int run_start(int slot, int dl) {
  return (slot / dl) * kRun * dl + slot % dl;
}

// Ring slot r + k for 0 ≤ r < n and |k| < n, without a division.
__device__ __forceinline__ int wrap(int r, int k, int n) {
  r += k;
  return r < 0 ? r + n : (r >= n ? r - n : r);
}

template <typename T, bool FUSED>
__global__ void __launch_bounds__(kMaxThreads<T>)
    depthwise_hw_kernel(const T* __restrict__ x, const float* __restrict__ wt1,
                        const int* __restrict__ dil1, const float* __restrict__ wt2,
                        const int* __restrict__ dil2, T* __restrict__ out, DwGeom g) {
  extern __shared__ __align__(16) uint4 smem[];
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kW = kVec / 4;
  const int nvec = g.c / kVec;
  const int halo = g.dm1 + g.dm2;
  const int dmax = max(g.dm1, g.dm2);
  const int npx = g.tw + 2 * halo;          // input ring: positions a row
  const int npi = g.tw + 2 * g.dm2;         // intermediate ring: positions a row
  // Row strides: a ragged last run reads up to (kRun − 1)·dil past its row
  // (values that only feed outputs it drops).
  const int rux = row_units(npx + (kRun - 1) * dmax, g.ldu, g.skew);
  const int rui = row_units(npi + (kRun - 1) * g.dm2, g.ldu, g.skew);
  const int ruo = row_units(g.tw, g.ldu, g.skew);
  const int nxr = 2 * g.dm1 + 1 + kPrefetch;
  const int nir = 2 * g.dm2 + 2;
  uint4* ws = smem;                                  // (stages, 9, nvec·kW) weights
  uint4* xs = ws + (FUSED ? 2 : 1) * 9 * nvec * kW;  // (nxr, rux): input rows
  uint4* ob = xs + nxr * rux;  // (2, ruo): staged output rows, one stencil
  uint4* is = xs + nxr * rux;  // (nir, rui): intermediate rows, fused
  const int lag = FUSED ? 2 * halo + 1 : 2 * g.dm1;  // output row o is made at step o + lag

  // The weights, as (tap, channel vector) 16-byte units: (3, 3, C) float32
  // is already that layout.
  for (int i = threadIdx.x; i < 9 * nvec * kW; i += blockDim.x) {
    ws[i] = reinterpret_cast<const uint4*>(wt1)[i];
    if (FUSED) ws[9 * nvec * kW + i] = reinterpret_cast<const uint4*>(wt2)[i];
  }

  // The copies of each input row and each output row: blockDim.x is a
  // multiple of nvec, so a thread keeps one channel vector and walks
  // positions u0, u0 + ustep, … every step; only the row moves.
  const int cvc = threadIdx.x % nvec, u0 = threadIdx.x / nvec, ustep = blockDim.x / nvec;

  // wpc warps own one channel vector of one stage (fused: warps [0,
  // wpc·nvec) make the intermediate row, the others the output row); their
  // lanes make runs of kRun outputs, as many passes of wpc·32 runs as the
  // row needs.
  const int wpc = blockDim.x / 32 / nvec / (FUSED ? 2 : 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool first = FUSED && warp < wpc * nvec;
  const int wi = FUSED && !first ? warp - wpc * nvec : warp;
  const int cv = wi / wpc, part = wi % wpc;
  const int dl = (first || !FUSED ? dil1 : dil2)[cv * kVec];
  const uint4* wt = ws + (FUSED && !first ? 9 * nvec * kW : 0) + cv * kW;
  const int at = first ? g.dm1 : (FUSED ? g.dm2 : g.dm1);  // first centre in its source row
  const int nsrc = first || !FUSED ? nxr : nir;

  // The grid is persistent: block b walks the (column, row) pairs
  // [b·span, (b + 1)·span) of the planes' W-tile columns, row by row, and
  // restarts its rings only where it moves to another column.
  const int tiles = (g.w + g.tw - 1) / g.tw;
  const long long total = static_cast<long long>(g.cols) * g.h;
  const long long span = (total + gridDim.x - 1) / gridDim.x;
  const long long end = min(total, (blockIdx.x + 1) * span);
  for (long long at_row = blockIdx.x * span; at_row < end;) {
    const int col = static_cast<int>(at_row / g.h), y0 = static_cast<int>(at_row % g.h);
    const int nrows = static_cast<int>(min(static_cast<long long>(g.h - y0), end - at_row));
    at_row += nrows;
    const int x0 = (col % tiles) * g.tw;
    const size_t plane = static_cast<size_t>(col / tiles) * g.h * g.w * g.c;
    const uint4* xp = reinterpret_cast<const uint4*>(x + plane);
    uint4* op = reinterpret_cast<uint4*>(out + plane);
    const int nx_rows = nrows + 2 * halo;  // input rows y0 − halo …
    const int steps = nx_rows + (FUSED ? 1 : 0);
    const int tw_in = min(g.tw, g.w - x0);

    auto stage_row = [&](int t) {  // input row y0 − halo + t → ring slot
      if (t < nx_rows) {
        const int yy = y0 - halo + t;
        uint4* dst = xs + (t % nxr) * rux + cvc;
        const bool row_ok = yy >= 0 && yy < g.h;
        const uint4* src = xp + (static_cast<long long>(yy) * g.w + x0 - halo) * nvec + cvc;
        for (int u = u0; u < npx; u += ustep) {
          const int xx = x0 - halo + u;
          const bool ok = row_ok && xx >= 0 && xx < g.w;
          cp_async16(dst + pos_unit(u, g), ok ? src + u * nvec : xp, ok);
        }
      }
      cp_async_commit();
    };
    // One stencil: output row o, made into ob[o & 1] at step o + lag, goes
    // to device memory at the next step, consecutive threads storing
    // consecutive 16 bytes.  (The fused pair has no room for staged rows:
    // its output warps store straight from registers.)
    auto store_row = [&](int o) {
      if (FUSED || o < 0 || o >= nrows) return;
      const uint4* src = ob + (o & 1) * ruo + cvc;
      uint4* dst = op + (static_cast<size_t>(y0 + o) * g.w + x0) * nvec + cvc;
      for (int p = u0; p < tw_in; p += ustep) dst[p * nvec] = src[pos_unit(p, g)];
    };

    const int npos = first ? npi : tw_in;  // positions the warp makes a row
    const int passes =
        (((npos + kRun * dl - 1) / (kRun * dl)) * dl + 32 * wpc - 1) / (32 * wpc);
    // Ring slots of this step's source rows (centre; taps at ± dl) and of
    // the row it writes, advanced by one a step.
    int centre = first || !FUSED ? wrap(0, -g.dm1, nxr) : (g.dm2 - lag) % nir;
    if (centre < 0) centre += nir;
    int jslot = (-2 * g.dm1) % nir;  // intermediate row j = t − 2·dm1 → slot j mod nir
    if (jslot < 0) jslot += nir;

    for (int t = 0; t < kPrefetch; ++t) stage_row(t);
    for (int t = 0; t < steps; ++t) {
      cp_async_wait<kPrefetch - 1>();
      __syncthreads();
      stage_row(t + kPrefetch);
      store_row(t - 1 - lag);
      const int row = first ? t - 2 * g.dm1 : t - lag;  // the row this warp makes
      const bool active = row >= 0 && row < nrows + (first ? 2 * g.dm2 : 0);
      if (active) {
        const uint4* base = first || !FUSED ? xs : is;
        const int stride = first || !FUSED ? rux : rui;
        const uint4* rows[3] = {base + wrap(centre, -dl, nsrc) * stride + cv,
                                base + centre * stride + cv,
                                base + wrap(centre, dl, nsrc) * stride + cv};
        uint4* dst = first ? is + jslot * rui + cv : ob + (row & 1) * ruo + cv;
        uint4* gdst = op + (static_cast<size_t>(y0 + row) * g.w + x0) * nvec + cv;
        const bool row_in = !first || (y0 - g.dm2 + row >= 0 && y0 - g.dm2 + row < g.h);
        for (int pass = 0; pass < passes; ++pass) {
          const int p0 = run_start((pass * wpc + part) * 32 + lane, dl);
          if (p0 >= npos) break;
          uint4 v[kRun];
          stencil_run<T, kVec>(rows, p0 + at, dl, wt, nvec * kW, g, v);
#pragma unroll
          for (int r = 0; r < kRun; ++r) {
            const int p = p0 + r * dl;
            if (p >= npos) break;
            if (first) {  // zero outside the image: the second stencil's padding
              const int xi = x0 - g.dm2 + p;
              dst[pos_unit(p, g)] =
                  row_in && xi >= 0 && xi < g.w ? v[r] : make_uint4(0, 0, 0, 0);
            } else if (FUSED) {
              gdst[p * nvec] = v[r];
            } else {
              dst[pos_unit(p, g)] = v[r];
            }
          }
        }
      }
      centre = wrap(centre, 1, nsrc);
      jslot = wrap(jslot, 1, nir);
    }
    cp_async_wait<0>();
    __syncthreads();
    store_row(steps - 1 - lag);
    __syncthreads();  // the rings are refilled for the next column
  }
}

// One shape's plan, in ops/kernels/_build.py DW_PLAN_KEYS order: W tiles of
// tw positions, a grid of `blocks`, wpc warps a (stage, channel vector),
// the rows' skew, threads and shared memory a block, blocks an SM.
struct DwPlan {
  int tw, blocks, wpc, skew, threads, smem_bytes, blocks_per_sm;
};

// Shared memory a block takes (the kernel's carve-up): the weights; the
// input ring, kPrefetch rows ahead; the intermediate ring (fused) or two
// staged output rows (one stencil).
inline size_t dw_smem(int tw, int nvec, int kw, int dm1, int dm2, int ldu, int skew) {
  const int halo = dm1 + dm2, dmax = dm1 > dm2 ? dm1 : dm2;
  const size_t units =
      static_cast<size_t>(dm2 ? 2 : 1) * 9 * nvec * kw +
      static_cast<size_t>(2 * dm1 + 1 + kPrefetch) *
          row_units(tw + 2 * halo + (kRun - 1) * dmax, ldu, skew) +
      (dm2 ? static_cast<size_t>(2 * dm2 + 2) * row_units(tw + 2 * dm2 + (kRun - 1) * dm2, ldu, skew)
           : 2 * static_cast<size_t>(row_units(tw, ldu, skew)));
  return 16 * units;
}

// The rule, from the H100's times at the ACV shape (PERF.md): the widest
// tile whose rings fit a block's shared memory (fewer restarts and halo
// columns); as many warps a channel vector as one pass over a row needs,
// as far as the block's threads allow; as many blocks as the card holds at
// once (the occupancy API), at most one a (column, row).  force_tw,
// force_wpc, force_blocks > 0 take those instead (for timing).
template <typename T, bool FUSED>
cudaError_t plan(int planes, int h, int w, int c, int dm1, int dm2, int force_tw, int force_wpc,
                 int force_blocks, int device, DwPlan& p) {
  constexpr int kVec = 16 / sizeof(T);
  const int stages = FUSED ? 2 : 1;
  if (!FUSED) dm2 = 0;
  if (c % kVec || dm1 < 1 || (FUSED && dm2 < 1)) return cudaErrorInvalidValue;
  const int nvec = c / kVec, ldu = nvec | 1;
  if (32 * nvec * stages > kMaxThreads<T>) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
    return e;
  if (cudaError_t e =
          cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device))
    return e;
  // The kernel may take all the shared memory a block can opt in to (on
  // this device; launches leave the attribute as it is), so the occupancy
  // query below sees the plan's bytes.
  auto kern = depthwise_hw_kernel<T, FUSED>;
  if (cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin))
    return e;
  p.skew = skew_for(ldu);
  size_t smem = 0;
  if (force_tw > 0) {
    p.tw = force_tw;
    smem = dw_smem(p.tw, nvec, kVec / 4, dm1, dm2, ldu, p.skew);
  } else {
    for (int tiles = 1; tiles <= w; ++tiles) {
      p.tw = ceil_div(w, tiles);
      if (ceil_div(w, p.tw) != tiles) continue;
      smem = dw_smem(p.tw, nvec, kVec / 4, dm1, dm2, ldu, p.skew);
      if (smem <= static_cast<size_t>(optin)) break;
    }
  }
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  const int dmax = dm1 > dm2 ? dm1 : dm2;
  const int slots = ceil_div(p.tw + 2 * dm2, kRun * dmax) * dmax;  // lane runs a row needs
  const int most = kMaxThreads<T> / (32 * nvec * stages);
  p.wpc = force_wpc > 0 ? force_wpc : (ceil_div(slots, 32) < most ? ceil_div(slots, 32) : most);
  if (p.wpc < 1) p.wpc = 1;
  p.threads = 32 * nvec * stages * p.wpc;
  if (p.threads > kMaxThreads<T>) return cudaErrorInvalidValue;
  p.smem_bytes = static_cast<int>(smem);
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.blocks_per_sm, kern,
                                                                    p.threads, p.smem_bytes))
    return e;
  if (p.blocks_per_sm < 1) return cudaErrorInvalidValue;
  const long long pairs = static_cast<long long>(planes) * ceil_div(w, p.tw) * h;
  const long long slots_all = static_cast<long long>(sms) * p.blocks_per_sm;
  p.blocks = force_blocks > 0 ? force_blocks
                              : static_cast<int>(pairs < slots_all ? pairs : slots_all);
  return cudaSuccess;
}

template <typename T, bool FUSED>
int launch(const void* x, const void* wt1, const void* dil1, const void* wt2, const void* dil2,
           void* out, const DwPlan& p, int b, int d, int h, int w, int c, int dm1, int dm2,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = c / kVec;
  const DwGeom g{h, w, c, p.tw, b * d * ceil_div(w, p.tw), dm1, FUSED ? dm2 : 0, nvec | 1,
                 p.skew};
  auto kern = depthwise_hw_kernel<T, FUSED>;  // its shared-memory limit set by plan()
  kern<<<p.blocks, p.threads, p.smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(wt1), static_cast<const int*>(dil1),
      static_cast<const float*>(wt2), static_cast<const int*>(dil2), static_cast<T*>(out), g);
  return end();
}

template <bool FUSED>
int dispatch(int dtype, const void* x, const void* wt1, const void* dil1, const void* wt2,
             const void* dil2, void* out, const int* plan, int b, int d, int h, int w, int c,
             int dm1, int dm2, cudaStream_t stream) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  DwPlan p;
  std::memcpy(&p, plan, sizeof p);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, FUSED>(x, wt1, dil1, wt2, dil2, out, p, b, d, h, w, c, dm1,
                                         dm2, stream);
  return launch<float, FUSED>(x, wt1, dil1, wt2, dil2, out, p, b, d, h, w, c, dm1, dm2, stream);
}

}  // namespace
}  // namespace dv

// The plan (DwPlan's ints) of one stencil (dm2 0) or the fused pair for
// `planes` (B·D) planes of (h, w, c): the largest dilations, dtype code, a
// forced tile, warps a vector and grid (0: the rule's), device.
DV_EXPORT int dv_depthwise_plan(int planes, int h, int w, int c, int dm1, int dm2, int dtype,
                                int tw, int wpc, int blocks, int device, int* plan) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  dv::DwPlan p;
  cudaError_t e;
  if (dtype == dv::kBF16)
    e = dm2 ? dv::plan<__nv_bfloat16, true>(planes, h, w, c, dm1, dm2, tw, wpc, blocks, device, p)
            : dv::plan<__nv_bfloat16, false>(planes, h, w, c, dm1, 0, tw, wpc, blocks, device, p);
  else
    e = dm2 ? dv::plan<float, true>(planes, h, w, c, dm1, dm2, tw, wpc, blocks, device, p)
            : dv::plan<float, false>(planes, h, w, c, dm1, 0, tw, wpc, blocks, device, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::memcpy(plan, &p, sizeof p);
  return 0;
}

// `plan`: dv_depthwise_plan's for this shape, dilations, dtype and device.
DV_EXPORT int dv_depthwise_hw(const void* x, const void* wt, const void* dil, void* out,
                              const int* plan, int b, int d, int h, int w, int c, int dm,
                              int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  return dv::dispatch<false>(dtype, x, wt, dil, nullptr, nullptr, out, plan, b, d, h, w, c, dm,
                             0, static_cast<cudaStream_t>(stream));
}

DV_EXPORT int dv_depthwise_hw2(const void* x, const void* wt1, const void* dil1, const void* wt2,
                               const void* dil2, void* out, const int* plan, int b, int d, int h,
                               int w, int c, int dm1, int dm2, int dtype, int device,
                               void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  return dv::dispatch<true>(dtype, x, wt1, dil1, wt2, dil2, out, plan, b, d, h, w, c, dm1, dm2,
                            static_cast<cudaStream_t>(stream));
}
