// Group-wise correlation volume:
//   out[b, g, d, h, w] = mean_{c in group g} left[b, c, h, w] * right[b, c, h, w - d]
// for w >= d, zero elsewhere.  Features (B, C, H, W), volume (B, G, D, H, W).
//
// Replaces diffuvolume_tpu/ops/pallas/gwc_volume.py:gwc_volume_pallas.
// Plain version: ops/cost_volume.py build_gwc_volume.
//
// What bounds it on the H100: at the main path (C=320, G=40, D=48, 128×240,
// bf16) it reads 2×19.7 MB and writes 118 MB (about 47 µs at 3.35 TB/s)
// and does about 1.1 G float32 multiply-adds (about 17 µs at 67 TFLOP/s),
// so it is bound by bytes, nearly all of them the output.
//
// Design.  One full row pair at C=320 is 2×154 KB in bf16, over a block's
// 227 KB of shared memory, so a block takes one (b, h, group): the group's
// cpg channels of one left and one right row, converted to float32 into
// shared memory once (2×8×240×4 = 15 KB), then every (d, w) output of that
// row and group.  Consecutive threads own consecutive w of one d, so both
// the shared-memory reads and the global stores are contiguous.  The
// products are summed in float32 and divided by cpg, as the mean is.
#include "common.cuh"

namespace dv {
namespace {

template <typename T>
__global__ void gwc_kernel(const T* __restrict__ left, const T* __restrict__ right,
                           T* __restrict__ out, int c, int h, int w, int groups, int dmax) {
  extern __shared__ float smem[];
  const int cpg = c / groups;
  float* ls = smem;            // [cpg][w]
  float* rs = smem + cpg * w;  // [cpg][w]
  const int row = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t in_off = (static_cast<size_t>(b) * c + static_cast<size_t>(g) * cpg) * hw +
                        static_cast<size_t>(row) * w;
  for (int i = threadIdx.x; i < cpg * w; i += blockDim.x) {
    const int ch = i / w, x = i - ch * w;
    const size_t off = in_off + ch * hw + x;
    ls[i] = to_f32(left[off]);
    rs[i] = to_f32(right[off]);
  }
  __syncthreads();

  T* obase = out + (static_cast<size_t>(b) * groups + g) * dmax * hw + static_cast<size_t>(row) * w;
  const float n = static_cast<float>(cpg);
  for (int i = threadIdx.x; i < dmax * w; i += blockDim.x) {
    const int d = i / w, x = i - d * w;
    float v = 0.f;
    if (x >= d) {
      float acc = 0.f;
      for (int ch = 0; ch < cpg; ++ch) acc += ls[ch * w + x] * rs[ch * w + x - d];
      v = acc / n;
    }
    obase[d * hw + x] = from_f32<T>(v);
  }
}

constexpr int kThreads = 256;

template <typename T>
int launch(const void* left, const void* right, void* out, int b, int c, int h, int w,
           int groups, int dmax, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * (c / groups) * w;
  auto kern = gwc_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(h, groups, b);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(left),
                                         static_cast<const T*>(right), static_cast<T*>(out), c,
                                         h, w, groups, dmax);
  return end();
}

}  // namespace
}  // namespace dv

DV_EXPORT int dv_gwc_volume(const void* left, const void* right, void* out, int b, int c, int h,
                            int w, int groups, int d, int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16)
    return dv::launch<__nv_bfloat16>(left, right, out, b, c, h, w, groups, d, s);
  return dv::launch<float>(left, right, out, b, c, h, w, groups, d, s);
}
