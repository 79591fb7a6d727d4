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
// broadcast over the innermost C.  The concat reads its (B, C, H, W)
// features into shared memory for one (b, h) row and a tile of 32 W
// positions (the right features with the D - 1 positions to the left that
// the shifts reach), then writes each d plane's 32 × 2C contiguous outputs
// 16 bytes a thread, consecutive threads on consecutive channels.  The
// multiply moves 16 bytes a thread along C.  So both need C (a side's, for
// the concat) in whole 16-byte vectors; the wrappers refuse any other C.
//
// What bounds them on the H100: both stream.  At the main path (C=32 per
// side, D=48, 128×240, bf16) the build writes 189 MB (about 56 µs at
// 3.35 TB/s) and the multiply reads and writes 189 MB each (about 113 µs);
// each does at most one multiply per element (plus att·noise once per map
// position in the multiply).
//
// Design.  The TPU kernels write a lane-packed, halo-padded layout that its
// conv kernels read; here the output is the plain NCDHW volume that
// F.conv3d reads.  A thread owns one (b, channel, h, w) or (b, d, h, w)
// position and walks the other axis: the build loads its left feature once
// and writes it D times (the right half loads the shifted feature per d);
// the multiply loads m1 ⊙ m2 once and applies it to all C channels.  Along
// a warp the threads hold consecutive w, so every load and store is
// contiguous.  Products are taken in float32 in the order (m1·m2)·v and
// rounded once, so the results equal the plain versions bit for bit.
#include "common.cuh"

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

// Channels-last concat: block = (one (b, h), 32 W positions), all d and 2C.
constexpr int kTileW = 32;

template <typename T>
__global__ void concat_cl_kernel(const T* __restrict__ cl, const T* __restrict__ cr,
                                 const T* __restrict__ att, T* __restrict__ out, int c,
                                 int dmax, int h, int w) {
  extern __shared__ float sm[];
  const int lw = kTileW + 1;              // left tile row stride (odd: no bank conflicts)
  const int rw = kTileW + dmax;           // right tile: W positions w0 - dmax + 1 .. w0 + 31
  const int rws = rw | 1;
  float* left = sm;                       // (c, lw)
  float* right = sm + c * lw;             // (c, rws)
  const int w0 = blockIdx.x * kTileW;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const size_t hw = static_cast<size_t>(h) * w;
  const T* clb = cl + static_cast<size_t>(b) * c * hw + static_cast<size_t>(y) * w;
  const T* crb = cr + static_cast<size_t>(b) * c * hw + static_cast<size_t>(y) * w;
  for (int i = threadIdx.x; i < c * kTileW; i += blockDim.x) {
    const int ch = i / kTileW, x = w0 + i % kTileW;
    left[ch * lw + i % kTileW] = x < w ? to_f32(clb[ch * hw + x]) : 0.f;
  }
  for (int i = threadIdx.x; i < c * rw; i += blockDim.x) {
    const int ch = i / rw, k = i % rw;
    const int x = w0 - (dmax - 1) + k;
    right[ch * rws + k] = (x >= 0 && x < w) ? to_f32(crb[ch * hw + x]) : 0.f;
  }
  __syncthreads();
  const int c2 = 2 * c;
  // The value of output channel ch at tile position xl, plane d.
  auto value = [&](int ch, int xl, int d) {
    return ch < c ? left[ch * lw + xl]
                  : (w0 + xl >= d ? right[(ch - c) * rws + xl + dmax - 1 - d] : 0.f);
  };
  // kVec channels (16 bytes) a thread; the wrapper holds C to a multiple.
  constexpr int kVec = 16 / sizeof(T);
  const int nv = c2 / kVec;
  for (int d = 0; d < dmax; ++d) {
    T* o = out + ((static_cast<size_t>(b) * dmax + d) * h + y) * static_cast<size_t>(w) * c2;
    const T* arow = att ? att + ((static_cast<size_t>(b) * dmax + d) * h + y) * w : nullptr;
    for (int i = threadIdx.x; i < kTileW * nv; i += blockDim.x) {
      const int xl = i / nv, x = w0 + xl;
      if (x >= w) continue;
      const float a = arow ? to_f32(arow[x]) : 1.f;
      const int ch0 = (i % nv) * kVec;
      uint4 raw;
      T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float v = value(ch0 + k, xl, d);
        vals[k] = from_f32<T>(arow ? v * a : v);
      }
      *reinterpret_cast<uint4*>(o + static_cast<size_t>(x) * c2 + ch0) = raw;
    }
  }
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
int launch_concat_cl(const void* cl, const void* cr, const void* att, void* out, int b,
                     int c, int dmax, int h, int w, cudaStream_t stream) {
  const size_t smem = sizeof(float) * c * ((kTileW + 1) + ((kTileW + dmax) | 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(concat_cl_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(ceil_div(w, kTileW), h, b);
  concat_cl_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(cl), static_cast<const T*>(cr), static_cast<const T*>(att),
      static_cast<T*>(out), c, dmax, h, w);
  return end();
}

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

DV_EXPORT int dv_concat_volume_cl(const void* cl, const void* cr, const void* att, void* out,
                                  int b, int c, int d, int h, int w, int dtype, int device,
                                  void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16)
    return dv::launch_concat_cl<__nv_bfloat16>(cl, cr, att, out, b, c, d, h, w, s);
  return dv::launch_concat_cl<float>(cl, cr, att, out, b, c, d, h, w, s);
}

DV_EXPORT int dv_dhw_mul_cl(const void* vol, const void* m1, const void* m2, void* out, int b,
                            int c, long long dhw, int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16)
    return dv::launch_mul_cl<__nv_bfloat16>(vol, m1, m2, out, b, c, dhw, s);
  return dv::launch_mul_cl<float>(vol, m1, m2, out, b, c, dhw, s);
}
