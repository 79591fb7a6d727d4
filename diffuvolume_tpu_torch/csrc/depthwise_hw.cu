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
//
// What bounds it on the H100: bytes.  The ACV volume (1, 48, 128, 240, 48)
// bf16 is read once and written once, 2 × 141.6 MB (about 85 µs at 3.35
// TB/s); the 9 multiply-adds an element (0.6 G) are about 9 µs of float32
// work.
//
// Design.  The TPU kernel lays the weights on diagonal 128×128 matrices so
// that its shifted windows feed the MXU; here a stencil is nine loads.  A
// thread owns 16 bytes of channels of one position (8 bf16 or 4 float32
// channels, one dilation for all of them: the wrapper holds each vector to
// one), loads the nine taps as 16-byte vectors (neighbouring threads read
// neighbouring positions, so the re-reads of a tap come from L1/L2, and
// HBM sees about one read of the volume) and sums in float32 in tap order,
// rounding once.  One launch per stencil: two per attention chain.
#include "common.cuh"

namespace dv {
namespace {

template <typename T>
__global__ void depthwise_hw_kernel(const T* __restrict__ x, const float* __restrict__ wt,
                                    const int* __restrict__ dil, T* __restrict__ out, int h,
                                    int w, int c, long long positions) {
  constexpr int kVec = 16 / sizeof(T);
  const int nv = c / kVec;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= positions * nv) return;
  const long long pos = i / nv;
  const int c0 = static_cast<int>(i % nv) * kVec;
  const int xw = static_cast<int>(pos % w);
  const int yh = static_cast<int>((pos / w) % h);
  const int dl = dil[c0];
  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
#pragma unroll
  for (int ti = 0; ti < 3; ++ti) {
    const int yy = yh + (ti - 1) * dl;
    if (yy < 0 || yy >= h) continue;
#pragma unroll
    for (int tj = 0; tj < 3; ++tj) {
      const int xx = xw + (tj - 1) * dl;
      if (xx < 0 || xx >= w) continue;
      const long long src = pos + static_cast<long long>(ti - 1) * dl * w + (tj - 1) * dl;
      const uint4 raw = *reinterpret_cast<const uint4*>(x + src * c + c0);
      const T* v = reinterpret_cast<const T*>(&raw);
      const float* wk = wt + (ti * 3 + tj) * c + c0;
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[k] = fmaf(__ldg(wk + k), to_f32(v[k]), acc[k]);
    }
  }
  uint4 raw;
  T* o = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec; ++k) o[k] = from_f32<T>(acc[k]);
  *reinterpret_cast<uint4*>(out + pos * c + c0) = raw;
}

constexpr int kThreads = 256;

template <typename T>
int launch(const void* x, const void* wt, const void* dil, void* out, int b, int d, int h, int w,
           int c, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long positions = static_cast<long long>(b) * d * h * w;
  depthwise_hw_kernel<T><<<ceil_div(positions * (c / kVec), kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(wt), static_cast<const int*>(dil),
      static_cast<T*>(out), h, w, c, positions);
  return end();
}

}  // namespace
}  // namespace dv

DV_EXPORT int dv_depthwise_hw(const void* x, const void* wt, const void* dil, void* out, int b,
                              int d, int h, int w, int c, int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16) return dv::launch<__nv_bfloat16>(x, wt, dil, out, b, d, h, w, c, s);
  return dv::launch<float>(x, wt, dil, out, b, d, h, w, c, s);
}
