// Layout steps between PyTorch's NCDHW modules and the channels-last conv
// kernels.
//
// dv_pack:   x (B, C, S) → out (B, S, c_slot), S = D·H·W, channels
//            C..c_slot zero-filled (the attention block's output re-enters
//            the hourglass; the slot fill serves volumes narrower than the
//            conv's 16-channel step).
//   Replaces diffuvolume_tpu/ops/pallas/conv3d.py:pack_padded_k.
// dv_unpack: x (B, S, C) → out (B, C, S) (the hourglass bottleneck enters
//            the attention block).
//   Replaces diffuvolume_tpu/ops/pallas/conv3d.py:unpack_padded_k.
//   Plain versions: ops/kernels/layout.py pack_plain / unpack_plain.
//
// What bounds them on the H100: bytes; one read and one write of the volume
// (the 128-channel bottleneck at (12, 32, 60) is 5.9 MB each way in bf16,
// 3.5 µs at 3.35 TB/s).
//
// Design: the classic shared-memory transpose.  A 32×32 tile (32 positions
// × 32 channels) is read coalesced along the input's minor axis and written
// coalesced along the output's; the tile has one padding column so neither
// side conflicts on banks.  The TPU kernels' D-phase lane packing, halo
// cells and tile rows are not carried over.
#include "common.cuh"

namespace dv {
namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // threads per tile column; each moves kTile / kRows

// out (B, S, c_out) ← x (B, c_in, S); channels ≥ c_in are written as zero.
template <typename T>
__global__ void to_last_kernel(const T* __restrict__ x, T* __restrict__ out, int c_in,
                               int c_out, long long s) {
  __shared__ T tile[kTile][kTile + 1];
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile;
  const int c0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * c_in * s;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int c = c0 + i;
    const long long p = s0 + threadIdx.x;
    tile[i][threadIdx.x] = (c < c_in && p < s) ? xb[c * s + p] : from_f32<T>(0.f);
  }
  __syncthreads();
  T* ob = out + static_cast<size_t>(b) * c_out * s;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const long long p = s0 + i;
    const int c = c0 + threadIdx.x;
    if (p < s && c < c_out) ob[p * c_out + c] = tile[threadIdx.x][i];
  }
}

// out (B, c, S) ← x (B, S, c).
template <typename T>
__global__ void to_first_kernel(const T* __restrict__ x, T* __restrict__ out, int c,
                                long long s) {
  __shared__ T tile[kTile][kTile + 1];
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile;
  const int c0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * c * s;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const long long p = s0 + i;
    const int ch = c0 + threadIdx.x;
    if (p < s && ch < c) tile[i][threadIdx.x] = xb[p * c + ch];
  }
  __syncthreads();
  T* ob = out + static_cast<size_t>(b) * c * s;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int ch = c0 + i;
    const long long p = s0 + threadIdx.x;
    if (p < s && ch < c) ob[ch * s + p] = tile[threadIdx.x][i];
  }
}

template <typename T>
int launch_pack(const void* x, void* out, int b, int c, long long s, int c_slot,
                cudaStream_t stream) {
  dim3 grid(ceil_div(s, kTile), ceil_div(c_slot, kTile), b);
  to_last_kernel<T><<<grid, dim3(kTile, kRows), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), c, c_slot, s);
  return end();
}

template <typename T>
int launch_unpack(const void* x, void* out, int b, int c, long long s, cudaStream_t stream) {
  dim3 grid(ceil_div(s, kTile), ceil_div(c, kTile), b);
  to_first_kernel<T><<<grid, dim3(kTile, kRows), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), c, s);
  return end();
}

}  // namespace
}  // namespace dv

DV_EXPORT int dv_pack(const void* x, void* out, int b, int c, long long s, int c_slot,
                      int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16) return dv::launch_pack<__nv_bfloat16>(x, out, b, c, s, c_slot, st);
  return dv::launch_pack<float>(x, out, b, c, s, c_slot, st);
}

DV_EXPORT int dv_unpack(const void* x, void* out, int b, int c, long long s, int dtype,
                        int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16) return dv::launch_unpack<__nv_bfloat16>(x, out, b, c, s, st);
  return dv::launch_unpack<float>(x, out, b, c, s, st);
}
