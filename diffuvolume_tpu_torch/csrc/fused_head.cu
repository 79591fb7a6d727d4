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
// sums; about 20 µs at 67 TFLOP/s), so it is bound by operations.
//
// Design.  The TPU kernel lifts W and D with dense interpolation matrices on
// the MXU; those matrices have exactly two non-zero taps per row, so here
// each axis is a 2-tap lerp and no work is spent on zeros.  One thread owns
// one output pixel.  It first lerps the D4 quarter-resolution logits of its
// column in H and W into shared memory (the cost volume is small and stays
// in L2), then makes three passes over the D output bins, each lerping two
// neighbours from shared memory: the max, then Σe and Σe·d (disparity), then
// Σe·|d - d̂| (uncertainty, which needs d̂ first).  Recomputing the lerp and
// exp in each pass costs less than holding 192 values per thread.  The D
// taps are shared by the block and computed once into shared memory.  Tap
// positions are computed in double, as the interpolation matrices are, and
// the weights rounded to float32 once.  Accumulation is in float32.
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

template <typename T>
__global__ void fused_head_kernel(const T* __restrict__ cost, float* __restrict__ disp,
                                  float* __restrict__ unc, int d4, int h4, int w4, int dfull,
                                  int h, int w, bool align_corners) {
  extern __shared__ float smem[];
  float* col = smem;                                        // [d4][blockDim.x]
  int* d_lo = reinterpret_cast<int*>(col + d4 * blockDim.x);  // [dfull]
  int* d_hi = d_lo + dfull;                                 // [dfull]
  float* d_wlo = reinterpret_cast<float*>(d_hi + dfull);    // [dfull]
  float* d_whi = d_wlo + dfull;                             // [dfull]

  for (int d = threadIdx.x; d < dfull; d += blockDim.x) {
    Tap t = tap(d, d4, dfull, align_corners);
    d_lo[d] = t.lo;
    d_hi[d] = t.hi;
    d_wlo[d] = t.w_lo;
    d_whi[d] = t.w_hi;
  }
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= w) return;  // no barrier below this point

  const Tap ty = tap(y, h4, h, align_corners);
  const Tap tx = tap(x, w4, w, align_corners);
  const T* base = cost + static_cast<size_t>(b) * d4 * h4 * w4;
  const int tid = threadIdx.x;
  const int stride = blockDim.x;
  for (int k = 0; k < d4; ++k) {
    const T* plane = base + static_cast<size_t>(k) * h4 * w4;
    const T* r0 = plane + static_cast<size_t>(ty.lo) * w4;
    const T* r1 = plane + static_cast<size_t>(ty.hi) * w4;
    // H first, then W: the order of the separable matrix products.
    float a = to_f32(r0[tx.lo]) * ty.w_lo + to_f32(r1[tx.lo]) * ty.w_hi;
    float c = to_f32(r0[tx.hi]) * ty.w_lo + to_f32(r1[tx.hi]) * ty.w_hi;
    col[k * stride + tid] = a * tx.w_lo + c * tx.w_hi;
  }

  auto logit = [&](int d) {
    return col[d_lo[d] * stride + tid] * d_wlo[d] + col[d_hi[d] * stride + tid] * d_whi[d];
  };

  float m = -CUDART_INF_F;
  for (int d = 0; d < dfull; ++d) m = fmaxf(m, logit(d));
  float z = 0.f, s = 0.f;
  for (int d = 0; d < dfull; ++d) {
    float e = expf(logit(d) - m);
    z += e;
    s += e * static_cast<float>(d);
  }
  const float dh = s / z;
  float u = 0.f;
  for (int d = 0; d < dfull; ++d) {
    float e = expf(logit(d) - m);
    u += e * fabsf(static_cast<float>(d) - dh);
  }
  const size_t o = (static_cast<size_t>(b) * h + y) * w + x;
  disp[o] = dh;
  unc[o] = u / z;
}

constexpr int kThreads = 128;

template <typename T>
int launch(const void* cost, void* disp, void* unc, int b, int d4, int h4, int w4, int dfull,
           int h, int w, int align_corners, cudaStream_t stream) {
  size_t smem = sizeof(float) * d4 * kThreads + (2 * sizeof(int) + 2 * sizeof(float)) * dfull;
  auto kern = fused_head_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(ceil_div(w, kThreads), h, b);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(cost), static_cast<float*>(disp),
                                         static_cast<float*>(unc), d4, h4, w4, dfull, h, w,
                                         align_corners != 0);
  return end();
}

}  // namespace
}  // namespace dv

DV_EXPORT int dv_fused_head(const void* cost, void* disp, void* unc, int b, int d4, int h4,
                            int w4, int d, int h, int w, int align_corners, int dtype,
                            int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16)
    return dv::launch<__nv_bfloat16>(cost, disp, unc, b, d4, h4, w4, d, h, w, align_corners, s);
  return dv::launch<float>(cost, disp, unc, b, d4, h4, w4, d, h, w, align_corners, s);
}
