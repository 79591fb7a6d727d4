// Group-wise correlation volumes.
//
// dv_gwc_volume: the NCDHW volume (the module path of the ACV model)
//   out[b, g, d, h, w] = mean_{c in group g} left[b, c, h, w] * right[b, c, h, w - d]
// for w >= d, zero elsewhere.  Features (B, C, H, W), volume (B, G, D, H, W).
//   Replaces diffuvolume_tpu/ops/pallas/gwc_volume.py:gwc_volume_pallas.
//   Plain version: ops/cost_volume.py build_gwc_volume.
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
//   at 1/4 … 1/32).  Plain version: ops/cost_volume.py gwc_volume_slot.
//
// What bounds it on the H100: bytes, the output.  ACV (1, 48, 128, 240, 48)
// bf16 writes 141.6 MB (about 42 µs at 3.35 TB/s) from 39 MB of features;
// PCW's 1/4 volume (1, 48, 96, 312, 64) writes 184 MB (about 55 µs).  The
// 472 M (ACV) multiply-adds are about 14 µs of float32 work.
//
// Design.  The TPU kernel packs D-phases into 128 lanes with halo rows and
// slices the shifts out of a flattened row; none of that carries over.  A
// block owns one (b, h) row and 32 W positions: it copies the left tile and
// the right strip that the shifts reach (32 + D − 1 positions), all C + cc
// channels each, into shared memory as [position][channel] rows (the row
// stride an odd number of 16-byte units), then loops over d inside the
// block.  Each thread makes 16 bytes of one (d, w) slot; the 8 threads of a
// quarter-warp take one channel vector at 8 neighbouring positions, so their
// 16-byte reads of the staged rows fall in distinct bank groups, and a warp
// stores each position's slot in whole 16-byte runs.  (Channel vectors
// first, the first design, read one row with 6 threads at once: 0.55 ms at
// the ACV shape, H100.)  Sums in float32 in channel order, divided by cpg,
// rounded once.
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


// -- the volume in the conv slot ----------------------------------------------

constexpr int kSlotTileW = 32;

struct SlotGeom {
  int c, cc, groups, slot, dmax, h, w, mask_ref;
};

// Shared-memory row stride in elements: C + cc channels rounded up to whole
// 16-byte vectors, then to an odd number of them.
template <typename T>
__host__ __device__ inline int slot_row_stride(int channels) {
  constexpr int kVec = 16 / sizeof(T);
  int n = (channels + kVec - 1) / kVec;
  if (n % 2 == 0) ++n;
  return n * kVec;
}

// Σ a[j]·b[j] over n elements in float32, in order; 16-byte reads where
// `vec` says both rows are aligned to them and n is a whole number of them.
template <typename T>
__device__ __forceinline__ float row_dot(const T* a, const T* b, int n, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  float s = 0.f;
  if (vec) {
    for (int j = 0; j < n; j += kVec) {
      const uint4 ra = *reinterpret_cast<const uint4*>(a + j);
      const uint4 rb = *reinterpret_cast<const uint4*>(b + j);
      const T* pa = reinterpret_cast<const T*>(&ra);
      const T* pb = reinterpret_cast<const T*>(&rb);
#pragma unroll
      for (int k = 0; k < kVec; ++k) s += to_f32(pa[k]) * to_f32(pb[k]);
    }
  } else {
    for (int j = 0; j < n; ++j) s += to_f32(a[j]) * to_f32(b[j]);
  }
  return s;
}

template <typename T>
__global__ void gwc_slot_kernel(const T* __restrict__ left, const T* __restrict__ right,
                                const T* __restrict__ cat_l, const T* __restrict__ cat_r,
                                T* __restrict__ out, SlotGeom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr int kVec = 16 / sizeof(T);
  const int nch = g.c + g.cc;                 // channels staged per position
  const int ld = slot_row_stride<T>(nch);
  const int rw = kSlotTileW + g.dmax - 1;     // right strip: w0 - D + 1 … w0 + 31
  T* ls = sm;                                 // (kSlotTileW, ld)
  T* rs = sm + kSlotTileW * ld;               // (rw, ld)
  const int w0 = blockIdx.x * kSlotTileW;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const size_t hw = static_cast<size_t>(g.h) * g.w;

  // Stage the rows: feature channels, then the concat channels; positions
  // outside the image are zero.  Consecutive threads read consecutive w.
  auto stage = [&](T* dst, int npos, int x0, const T* feat, const T* cat) {
    for (int i = threadIdx.x; i < nch * npos; i += blockDim.x) {
      const int ch = i / npos, k = i % npos, x = x0 + k;
      T v = from_f32<T>(0.f);
      if (x >= 0 && x < g.w) {
        const size_t at = static_cast<size_t>(y) * g.w + x;
        v = ch < g.c ? feat[(static_cast<size_t>(b) * g.c + ch) * hw + at]
                     : cat[(static_cast<size_t>(b) * g.cc + (ch - g.c)) * hw + at];
      }
      dst[k * ld + ch] = v;
    }
  };
  stage(ls, kSlotTileW, w0, left, cat_l);
  stage(rs, rw, w0 - (g.dmax - 1), right, cat_r);
  __syncthreads();

  const int cpg = g.c / g.groups;
  const bool vec = cpg % kVec == 0;
  const float n = static_cast<float>(cpg);
  // Work item → (d, group of 8 positions, channel vector, position in the
  // group): the 8 threads of each quarter-warp read 8 different staged rows
  // (distinct 16-byte bank groups, as the row stride is odd) and the warp
  // stores whole 16-byte runs of each position's slot.
  const int nv = g.slot / kVec;
  for (int i = threadIdx.x; i < g.dmax * kSlotTileW * nv; i += blockDim.x) {
    const int ch0 = ((i / 8) % nv) * kVec;
    const int xl = i % 8 + 8 * ((i / (8 * nv)) % (kSlotTileW / 8));
    const int d = i / (nv * kSlotTileW);
    const int x = w0 + xl;
    if (x >= g.w) continue;
    const bool valid = x >= d;
    const T* lrow = ls + xl * ld;
    const T* rrow = rs + (xl + g.dmax - 1 - d) * ld;
    uint4 raw;
    T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int ch = ch0 + k;
      float v = 0.f;
      if (ch < g.groups) {
        if (valid) v = row_dot(lrow + ch * cpg, rrow + ch * cpg, cpg, vec) / n;
      } else if (ch < g.groups + g.cc) {
        if (valid || !g.mask_ref) v = to_f32(lrow[g.c + ch - g.groups]);
      } else if (ch < g.groups + 2 * g.cc) {
        if (valid) v = to_f32(rrow[g.c + ch - g.groups - g.cc]);
      }
      vals[k] = from_f32<T>(v);
    }
    const size_t o = (((static_cast<size_t>(b) * g.dmax + d) * g.h + y) * g.w + x) * g.slot + ch0;
    *reinterpret_cast<uint4*>(out + o) = raw;
  }
}

template <typename T>
int launch_slot(const void* left, const void* right, const void* cat_l, const void* cat_r,
                void* out, int b, const SlotGeom& g, cudaStream_t stream) {
  const int ld = slot_row_stride<T>(g.c + g.cc);
  const size_t smem = sizeof(T) * static_cast<size_t>(ld) * (2 * kSlotTileW + g.dmax - 1);
  cudaError_t e = cudaFuncSetAttribute(gwc_slot_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(ceil_div(g.w, kSlotTileW), g.h, b);
  gwc_slot_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right), static_cast<const T*>(cat_l),
      static_cast<const T*>(cat_r), static_cast<T*>(out), g);
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

DV_EXPORT int dv_gwc_volume_slot(const void* left, const void* right, const void* cat_l,
                                 const void* cat_r, void* out, int b, int c, int cc, int h,
                                 int w, int groups, int d, int slot, int mask_ref, int dtype,
                                 int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  const dv::SlotGeom g{c, cc, groups, slot, d, h, w, mask_ref};
  if (dtype == dv::kBF16)
    return dv::launch_slot<__nv_bfloat16>(left, right, cat_l, cat_r, out, b, g, s);
  return dv::launch_slot<float>(left, right, cat_l, cat_r, out, b, g, s);
}
