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
// column staging and bin lerps as the head, with two passes (the max, then Σe
// and Σe·|d − q|): q is known, so the disparity pass is not needed.
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

// Shared memory of one block: the D4 lerped logits of each thread's column,
// then the D output bins' taps (shared by the block).
struct HeadSmem {
  float* col;  // [d4][blockDim.x]
  int* d_lo;   // [dfull]
  int* d_hi;
  float* d_wlo;
  float* d_whi;
};

__device__ __forceinline__ HeadSmem head_smem(float* smem, int d4, int dfull) {
  HeadSmem s;
  s.col = smem;
  s.d_lo = reinterpret_cast<int*>(s.col + d4 * blockDim.x);
  s.d_hi = s.d_lo + dfull;
  s.d_wlo = reinterpret_cast<float*>(s.d_hi + dfull);
  s.d_whi = s.d_wlo + dfull;
  return s;
}

// The D taps into shared memory (all threads, one barrier), then this
// thread's column (x, y) lerped in H and W at every quarter-resolution bin.
// Returns false for a thread past the row's end (no barrier may follow).
template <typename T>
__device__ __forceinline__ bool head_column(const T* __restrict__ cost, const HeadSmem& s,
                                            int d4, int h4, int w4, int dfull, int h, int w,
                                            bool align_corners, int x, int y, int b) {
  for (int d = threadIdx.x; d < dfull; d += blockDim.x) {
    Tap t = tap(d, d4, dfull, align_corners);
    s.d_lo[d] = t.lo;
    s.d_hi[d] = t.hi;
    s.d_wlo[d] = t.w_lo;
    s.d_whi[d] = t.w_hi;
  }
  __syncthreads();
  if (x >= w) return false;

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
    s.col[k * stride + tid] = a * tx.w_lo + c * tx.w_hi;
  }
  return true;
}

// The upsampled logit of output bin d, lerped from the thread's column.
__device__ __forceinline__ float head_logit(const HeadSmem& s, int d) {
  const int tid = threadIdx.x, stride = blockDim.x;
  return s.col[s.d_lo[d] * stride + tid] * s.d_wlo[d] +
         s.col[s.d_hi[d] * stride + tid] * s.d_whi[d];
}

template <typename T>
__global__ void fused_head_kernel(const T* __restrict__ cost, float* __restrict__ disp,
                                  float* __restrict__ unc, int d4, int h4, int w4, int dfull,
                                  int h, int w, bool align_corners) {
  extern __shared__ float smem[];
  const HeadSmem s = head_smem(smem, d4, dfull);
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (!head_column(cost, s, d4, h4, w4, dfull, h, w, align_corners, x, y, b)) return;

  float m = -CUDART_INF_F;
  for (int d = 0; d < dfull; ++d) m = fmaxf(m, head_logit(s, d));
  float z = 0.f, sd = 0.f;
  for (int d = 0; d < dfull; ++d) {
    float e = expf(head_logit(s, d) - m);
    z += e;
    sd += e * static_cast<float>(d);
  }
  const float dh = sd / z;
  float u = 0.f;
  for (int d = 0; d < dfull; ++d) {
    float e = expf(head_logit(s, d) - m);
    u += e * fabsf(static_cast<float>(d) - dh);
  }
  const size_t o = (static_cast<size_t>(b) * h + y) * w + x;
  disp[o] = dh;
  unc[o] = u / z;
}

// The renewal uncertainty against a given disparity q (B, H, W):
// Σ_d softmax(upsampled logits)_d · |d − q|, two passes over the bins.
template <typename T>
__global__ void fused_unc_at_kernel(const T* __restrict__ cost, const float* __restrict__ query,
                                    float* __restrict__ unc, int d4, int h4, int w4, int dfull,
                                    int h, int w, bool align_corners) {
  extern __shared__ float smem[];
  const HeadSmem s = head_smem(smem, d4, dfull);
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (!head_column(cost, s, d4, h4, w4, dfull, h, w, align_corners, x, y, b)) return;

  const size_t o = (static_cast<size_t>(b) * h + y) * w + x;
  const float q = query[o];
  float m = -CUDART_INF_F;
  for (int d = 0; d < dfull; ++d) m = fmaxf(m, head_logit(s, d));
  float z = 0.f, u = 0.f;
  for (int d = 0; d < dfull; ++d) {
    float e = expf(head_logit(s, d) - m);
    z += e;
    u += e * fabsf(static_cast<float>(d) - q);
  }
  unc[o] = u / z;
}

constexpr int kThreads = 128;

size_t head_smem_bytes(int d4, int dfull) {
  return sizeof(float) * d4 * kThreads + (2 * sizeof(int) + 2 * sizeof(float)) * dfull;
}

template <typename Kernel>
int prepare(Kernel kern, size_t smem) {
  if (smem > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  }
  return 0;
}

template <typename T>
int launch(const void* cost, void* disp, void* unc, int b, int d4, int h4, int w4, int dfull,
           int h, int w, int align_corners, cudaStream_t stream) {
  const size_t smem = head_smem_bytes(d4, dfull);
  auto kern = fused_head_kernel<T>;
  if (int e = prepare(kern, smem)) return e;
  dim3 grid(ceil_div(w, kThreads), h, b);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(cost), static_cast<float*>(disp),
                                         static_cast<float*>(unc), d4, h4, w4, dfull, h, w,
                                         align_corners != 0);
  return end();
}

template <typename T>
int launch_unc_at(const void* cost, const void* query, void* unc, int b, int d4, int h4, int w4,
                  int dfull, int h, int w, int align_corners, cudaStream_t stream) {
  const size_t smem = head_smem_bytes(d4, dfull);
  auto kern = fused_unc_at_kernel<T>;
  if (int e = prepare(kern, smem)) return e;
  dim3 grid(ceil_div(w, kThreads), h, b);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(cost),
                                         static_cast<const float*>(query),
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

DV_EXPORT int dv_fused_uncertainty_at(const void* cost, const void* query, void* unc, int b,
                                      int d4, int h4, int w4, int d, int h, int w,
                                      int align_corners, int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16)
    return dv::launch_unc_at<__nv_bfloat16>(cost, query, unc, b, d4, h4, w4, d, h, w,
                                            align_corners, s);
  return dv::launch_unc_at<float>(cost, query, unc, b, d4, h4, w4, d, h, w, align_corners, s);
}
