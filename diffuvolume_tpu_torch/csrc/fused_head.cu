// Fused trilinear upsample → softmax over disparity → soft-argmin and
// renewal uncertainty, without materialising the full-resolution volume.
//
// Replaces diffuvolume_tpu/ops/pallas/fused_head.py:fused_upsample_softargmin.
// Plain version: ops/regression.py upsample_cost_and_regress +
// disparity_uncertainty.
//
// What bounds it on the H100: at the main path (cost 1×48×128×240 → 512×960,
// 192 bins) the kernel reads 5.9 MB and writes 3.9 MB (about 3 µs at
// 3.35 TB/s) but does about 1.3 G float32 operations (lerps, exp, the three
// sums; about 20 µs at 67 TFLOP/s), so it is bound by operations.  One exp a
// bin on the SFU (16 a clock an SM, 132 SMs near 1.75 GHz) puts a floor near
// 25 µs beside that: 94 M exps at the main path.  Before the operations,
// shared memory: each bin's logit is a lerp of two values of the pixel's
// column and a tap, and the SM serves one shared-memory wavefront a clock.
//
// Design.  The TPU kernel lifts W and D with dense interpolation matrices on
// the MXU; those matrices have exactly two non-zero taps per row, so here
// each axis is a 2-tap lerp and no work is spent on zeros.  A block owns 64
// output pixels × 4 rows.  A pixel's bins are split in 4 contiguous chunks
// of NB (16, 48 or 96: up to 384 bins), one a thread; warp w holds chunk
// w / 2 of 32 neighbouring pixels, so every tap it reads is one broadcast
// address.  Once a block: the D taps (as offsets into the pixels' columns),
// the rows' H taps and the pixels' W taps.  Each row:
//   1. the block's source columns of the row's two source rows (every
//      quarter-resolution bin) arrive by cp.async into one of two raw
//      buffers, the next row's copy in flight while this row is computed;
//      they are lerped in H, then each pixel's column in W ([bin][pixel]:
//      a warp's 32 pixels read 32 banks);
//   2. each thread's NB logits, straight-line: one tap and two column values
//      a bin (three shared-memory wavefronts a bin for the warp);
//   3. the logits stay in registers: the chunk's max, one exp a bin (the
//      exponentials overwrite the logits; ex2.approx of a fused
//      (l − m)·log2 e), Σe and Σe·d, then Σe·|d − d̂|; the four chunks meet
//      through shared memory (the max, the two sums, the uncertainty).
// Tap positions are computed in double, as the interpolation matrices are,
// and the weights rounded to float32 once (tap() below, unchanged).
// Accumulation is in float32.
//
// dv_fused_uncertainty_at: Σ_d softmax(upsampled logits)_d · |d − q| at a
// given query field q (B, H, W), the PCW renewal score against the refined
// disparity, which exists only after the refinement net has read the first
// pass's disparity.
//   Replaces diffuvolume_tpu/ops/pallas/fused_head.py:fused_uncertainty_at.
//   Plain version: ops/kernels/fused_head.py fused_uncertainty_at_plain.
// Bound by operations too: at the PCW path (cost 1×48×96×312 → 384×1248,
// 192 bins) it reads 5.8 MB + 1.9 MB and writes 1.9 MB (about 3 µs) and does
// about 0.9 G float32 operations (about 14 µs at 67 TFLOP/s).  The same
// kernel as the head (AT true) with q in place of d̂: no disparity sum.
#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace dv {
namespace {

struct Tap {
  int lo, hi;
  float w_lo, w_hi;
};

// Linear-interpolation taps of output index o (in_size → out_size), with
// the same conventions as ops/regression.py _interp_matrix.
__device__ __forceinline__ Tap tap(int o, int in_size, int out_size, bool align_corners) {
  Tap t;
  if (in_size == out_size) {
    t.lo = t.hi = o;
    t.w_lo = 1.f;
    t.w_hi = 0.f;
    return t;
  }
  double src;
  if (align_corners) {
    src = out_size == 1 ? 0.0 : o * double(in_size - 1) / double(out_size - 1);
  } else {
    src = (o + 0.5) * (double(in_size) / double(out_size)) - 0.5;
  }
  src = fmin(fmax(src, 0.0), double(in_size - 1));
  int lo = static_cast<int>(floor(src));
  double w = src - lo;
  t.lo = lo;
  t.hi = min(lo + 1, in_size - 1);
  t.w_lo = static_cast<float>(1.0 - w);
  t.w_hi = static_cast<float>(w);
  return t;
}

constexpr int kLanes = 4;                 // bin chunks a pixel, one a thread
constexpr int kPix = 64;                  // pixels a block, along one output row
constexpr int kRows = 4;                  // output rows a block, one after another
constexpr int kThreads = kLanes * kPix;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx: about 2⁻²² relative error).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One source element into the staging buffer: cp.async (4 bytes, no
// registers) for float32; bfloat16 through registers, widened.
__device__ __forceinline__ void stage(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}
__device__ __forceinline__ void stage_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// AT false: the head, (disp, unc) with unc = Σ p·|d − d̂|.  AT true: the
// uncertainty at `query`, unc = Σ p·|d − q| (disp unused).  A block owns
// kPix pixels × kRows rows; warp w holds 32 pixels' bin chunk w / 2, so a
// warp reads one tap at a time.  Dynamic shared memory (sized in
// launch_nb()): the D taps, the rows' H taps, the pixels' W taps, two raw
// staging buffers (the two source rows × d4 bins × cw columns, cw =
// 2^cw_log2 ≥ the block's source columns), the H-lerped columns [column][d4
// + 1], every pixel's column of quarter-resolution logits [bin][kPix], and
// the chunks' partial sums [4][kLanes][kPix].
template <typename T, int NB, bool AT>
__global__ void __launch_bounds__(kThreads)
    head_kernel(const T* __restrict__ cost, const float* __restrict__ query,
                float* __restrict__ disp, float* __restrict__ unc, int d4, int h4, int w4,
                int dfull, int h, int w, bool align_corners, int cw_log2, int ncols_max) {
  extern __shared__ float4 smem4[];
  __shared__ int xs[2];                                          // the block's source columns
  float4* taps = smem4;                                          // [NB · kLanes], bin order
  float4* trow = taps + NB * kLanes;                             // [kRows]
  float4* tcol = trow + kRows;                                   // [kPix]
  const int cw = 1 << cw_log2, ld = d4 + 1;
  float* raw = reinterpret_cast<float*>(tcol + kPix);            // [2][2][d4][cw]
  float* hs = raw + 4 * d4 * cw;                                 // [column][d4 + 1]
  float* col = hs + ncols_max * ld;                              // [d4][kPix]
  float* red = col + d4 * kPix;                                  // [4][kLanes][kPix]
  const int tid = threadIdx.x, warp = tid / 32;
  const int j = warp / (kPix / 32), p = warp % (kPix / 32) * 32 + tid % 32;
  const int x0 = blockIdx.x * kPix, y0 = blockIdx.y * kRows, b = blockIdx.z;
  const int rows = min(kRows, h - y0), npix = min(kPix, w - x0);
  const int x = x0 + p;

  // 1. Taps, once a block: D (bins past dfull take the last bin's and are
  // masked below; lo and hi as offsets into the pixels' columns), H for each
  // row, W for each pixel.
  for (int o = tid; o < NB * kLanes; o += kThreads) {
    const Tap t = tap(min(o, dfull - 1), d4, dfull, align_corners);
    taps[o] = make_float4(__int_as_float(t.lo * kPix), __int_as_float(t.hi * kPix), t.w_lo,
                          t.w_hi);
  }
  if (tid < rows) {
    const Tap t = tap(y0 + tid, h4, h, align_corners);
    trow[tid] = make_float4(__int_as_float(t.lo), __int_as_float(t.hi), t.w_lo, t.w_hi);
  }
  if (j == 0) {
    const Tap t = tap(min(x, w - 1), w4, w, align_corners);
    tcol[p] = make_float4(__int_as_float(t.lo), __int_as_float(t.hi), t.w_lo, t.w_hi);
    if (p == 0) xs[0] = t.lo;
    if (p == npix - 1) xs[1] = t.hi;
  }
  __syncthreads();
  const int xs0 = xs[0], ncols = xs[1] - xs0 + 1;
  const float4 tx = tcol[p];

  // 2. Row r's two source rows (every bin, the block's columns) into raw
  // buffer r % 2, and from there lerped in H into hs.  The copy of row r + 1
  // is in flight while row r is computed.
  const int c = tid & (cw - 1), k0 = tid >> cw_log2, kstep = kThreads >> cw_log2;
  const size_t plane = static_cast<size_t>(h4) * w4;
  auto copy_row = [&](int r) {
    if (c < ncols) {
      const float4 t = trow[r];
      const size_t base = static_cast<size_t>(b) * d4 * h4;
      const T* s0 = cost + (base + __float_as_int(t.x)) * w4 + xs0 + c;
      const T* s1 = cost + (base + __float_as_int(t.y)) * w4 + xs0 + c;
      float* dst = raw + (r & 1) * 2 * d4 * cw + c;
      for (int k = k0; k < d4; k += kstep) {
        stage(dst + k * cw, s0 + k * plane);
        stage(dst + (d4 + k) * cw, s1 + k * plane);
      }
    }
    stage_commit();
  };

  // This thread's share of its pixel's column: bins kc·j … kc·j + kc − 1.
  const int kc = (d4 + kLanes - 1) / kLanes;
  const int ka = min(kc * j, d4), kb = min(ka + kc, d4);
  const float* hlo = hs + (__float_as_int(tx.x) - xs0) * ld;
  const float* hhi = hs + (__float_as_int(tx.y) - xs0) * ld;
  const float* cp = col + p;
  const float4* tj = taps + j * NB;
  float* rp = red + p;
  const int o0 = j * NB;
  const float d0 = static_cast<float>(o0);
  copy_row(0);
  for (int r = 0; r < rows; ++r) {
    stage_wait();
    __syncthreads();  // raw buffer r % 2 whole; hs, col and red read for row r − 1
    if (r + 1 < rows) copy_row(r + 1);
    if (c < ncols) {
      const float4 t = trow[r];
      const float* src = raw + (r & 1) * 2 * d4 * cw + c;
      // H first, then W: the order of the separable matrix products.
      for (int k = k0; k < d4; k += kstep)
        hs[c * ld + k] = src[k * cw] * t.z + src[(d4 + k) * cw] * t.w;
    }
    __syncthreads();
    for (int k = ka; k < kb; ++k) col[k * kPix + p] = hlo[k] * tx.z + hhi[k] * tx.w;
    __syncthreads();

    // 3. This thread's logits, its pixel's column lerped in D, straight-line
    // over its chunk's bins (one tap a bin for the whole warp).
    float l[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float4 t = tj[i];
      l[i] = cp[__float_as_int(t.x)] * t.z + cp[__float_as_int(t.y)] * t.w;
    }
    if (o0 + NB > dfull) {
#pragma unroll
      for (int i = 0; i < NB; ++i)
        if (o0 + i >= dfull) l[i] = -CUDART_INF_F;
    }

    // 4. Softmax moments over registers, one exp a bin; the four chunks of
    // a pixel combined through shared memory.
    float m = l[0];
#pragma unroll
    for (int i = 1; i < NB; ++i) m = fmaxf(m, l[i]);
    rp[j * kPix] = m;
    __syncthreads();
    m = fmaxf(fmaxf(rp[0], rp[kPix]), fmaxf(rp[2 * kPix], rp[3 * kPix]));
    const float mk = m * kLog2e;
    float z = 0.f, sd = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      l[i] = ex2(fmaf(l[i], kLog2e, -mk));
      z += l[i];
      if constexpr (!AT) sd = fmaf(l[i], static_cast<float>(i), sd);
    }
    float* rz = rp + kLanes * kPix;
    rz[j * kPix] = z;
    if constexpr (!AT) rz[(kLanes + j) * kPix] = fmaf(d0, z, sd);
    __syncthreads();
    const float zq = (rz[0] + rz[kPix]) + (rz[2 * kPix] + rz[3 * kPix]);
    const size_t o = (static_cast<size_t>(b) * h + y0 + r) * w + min(x, w - 1);
    float ref;
    if constexpr (AT) {
      ref = query[o];
    } else {
      const float* rs = rz + kLanes * kPix;
      ref = ((rs[0] + rs[kPix]) + (rs[2 * kPix] + rs[3 * kPix])) / zq;
    }
    const float a = d0 - ref;
    float u = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i) u = fmaf(l[i], fabsf(a + static_cast<float>(i)), u);
    float* ru = rz + 2 * kLanes * kPix;
    ru[j * kPix] = u;
    __syncthreads();
    if (j == 0 && x < w) {
      if constexpr (!AT) disp[o] = ref;
      unc[o] = ((ru[0] + ru[kPix]) + (ru[2 * kPix] + ru[3 * kPix])) / zq;
    }
  }
}

// The most source columns a block of kPix pixels reads along W (w4 → w):
// the span of kPix − 1 output steps, plus the two taps' reach and a margin
// for the rounding of the tap positions.
int head_cols(int w4, int w) {
  double s = static_cast<double>(w4) / w;
  if (w > 1) s = fmax(s, static_cast<double>(w4 - 1) / (w - 1));
  return std::min(w4, static_cast<int>(std::ceil((kPix - 1) * s)) + 4);
}

template <typename T, int NB, bool AT>
int launch_nb(const void* cost, const void* query, void* disp, void* unc, int b, int d4, int h4,
              int w4, int dfull, int h, int w, int align_corners, cudaStream_t stream) {
  const int ncols = head_cols(w4, w);
  int cw_log2 = 0;
  while ((1 << cw_log2) < ncols) ++cw_log2;
  if ((1 << cw_log2) > kThreads) return static_cast<int>(cudaErrorInvalidValue);  // W shrinks
  const size_t smem = sizeof(float4) * (NB * kLanes + kRows + kPix) +
                      sizeof(float) * (4 * d4 * (1 << cw_log2) + ncols * (d4 + 1) +
                                       d4 * kPix + 4 * kLanes * kPix);
  auto kern = head_kernel<T, NB, AT>;
  if (smem > 48 * 1024) {
    if (cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem)))
      return static_cast<int>(e);
  }
  dim3 grid(ceil_div(w, kPix), ceil_div(h, kRows), b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(cost), static_cast<const float*>(query), static_cast<float*>(disp),
      static_cast<float*>(unc), d4, h4, w4, dfull, h, w, align_corners != 0, cw_log2, ncols);
  return end();
}

// Bins a lane: the fewest of 16, 48, 96 that cover dfull over the quad.
template <typename T, bool AT>
int launch(const void* cost, const void* query, void* disp, void* unc, int b, int d4, int h4,
           int w4, int dfull, int h, int w, int align_corners, cudaStream_t s) {
  if (dfull < 1 || d4 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dfull <= 16 * kLanes)
    return launch_nb<T, 16, AT>(cost, query, disp, unc, b, d4, h4, w4, dfull, h, w,
                                align_corners, s);
  if (dfull <= 48 * kLanes)
    return launch_nb<T, 48, AT>(cost, query, disp, unc, b, d4, h4, w4, dfull, h, w,
                                align_corners, s);
  if (dfull <= 96 * kLanes)
    return launch_nb<T, 96, AT>(cost, query, disp, unc, b, d4, h4, w4, dfull, h, w,
                                align_corners, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace dv

DV_EXPORT int dv_fused_head(const void* cost, void* disp, void* unc, int b, int d4, int h4,
                            int w4, int d, int h, int w, int align_corners, int dtype,
                            int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16)
    return dv::launch<__nv_bfloat16, false>(cost, nullptr, disp, unc, b, d4, h4, w4, d, h, w,
                                            align_corners, s);
  return dv::launch<float, false>(cost, nullptr, disp, unc, b, d4, h4, w4, d, h, w,
                                  align_corners, s);
}

DV_EXPORT int dv_fused_uncertainty_at(const void* cost, const void* query, void* unc, int b,
                                      int d4, int h4, int w4, int d, int h, int w,
                                      int align_corners, int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16)
    return dv::launch<__nv_bfloat16, true>(cost, query, nullptr, unc, b, d4, h4, w4, d, h, w,
                                           align_corners, s);
  return dv::launch<float, true>(cost, query, nullptr, unc, b, d4, h4, w4, d, h, w,
                                 align_corners, s);
}
