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
// dv_unpack_hwdc: x (B, D, S, c_slot) → out (B, S, D·co), the first co
//            channels of each slot (IGEV: the GEV (B, 48, 96·312, 16) →
//            (B, 96·312, 48·8), the geometry pyramid's layout; the
//            classifier's cost with co = 1 → (B, H, W, D)).
//   Replaces diffuvolume_tpu/ops/pallas/conv3d.py:unpack_hwdc_k.
//   Plain versions: ops/kernels/layout.py pack_plain / unpack_plain /
//   unpack_hwdc_plain.
//
// What bounds them on the H100: bytes; one read and one write of the volume
// (the 128-channel bottleneck at (12, 32, 60) is 5.9 MB each way in bf16,
// 3.5 µs at 3.35 TB/s; the GEV's 8 of 16 channels, 23 MB each way, 14 µs).
//
// Design: the classic shared-memory transpose.  A 32×32 tile (32 positions
// × 32 channels) is read coalesced along the input's minor axis and written
// coalesced along the output's; the tile has one padding column so neither
// side conflicts on banks.  unpack_hwdc transposes (d, s) the same way with
// co channels as the unit: one 16-byte vector where co fills one (the GEV),
// else one channel a block layer (the cost, co = 1, coalesced on both sides).
// The TPU kernels' D-phase lane packing, halo cells, tile rows and 0/1
// channel-selection matmul are not carried over.
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

// out (B, S, D, co units) ← x (B, D, S, slot units), unit 0 of each slot:
// V is the 16-byte vector that holds the co channels.
__global__ void hwdc_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int d,
                                long long s, int slot_units) {
  __shared__ uint4 tile[kTile][kTile + 1];
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile;
  const int d0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int dd = d0 + i;
    const long long p = s0 + threadIdx.x;
    if (dd < d && p < s) {
      tile[i][threadIdx.x] = x[((static_cast<long long>(b) * d + dd) * s + p) * slot_units];
    }
  }
  __syncthreads();
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const long long p = s0 + i;
    const int dd = d0 + threadIdx.x;
    if (dd < d && p < s) out[(static_cast<long long>(b) * s + p) * d + dd] = tile[threadIdx.x][i];
  }
}

// out (B, S, D·co) ← x (B, D, S, c_slot), one channel c of co per block layer.
template <typename T>
__global__ void hwdc_kernel(const T* __restrict__ x, T* __restrict__ out, int d, long long s,
                            int c_slot, int co) {
  __shared__ T tile[kTile][kTile + 1];
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile;
  const int d0 = blockIdx.y * kTile;
  const int b = blockIdx.z / co, c = blockIdx.z % co;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int dd = d0 + i;
    const long long p = s0 + threadIdx.x;
    if (dd < d && p < s) {
      tile[i][threadIdx.x] = x[((static_cast<long long>(b) * d + dd) * s + p) * c_slot + c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const long long p = s0 + i;
    const int dd = d0 + threadIdx.x;
    if (dd < d && p < s) {
      out[((static_cast<long long>(b) * s + p) * d + dd) * co + c] = tile[threadIdx.x][i];
    }
  }
}

template <typename T>
int launch_hwdc(const void* x, void* out, int b, int d, long long s, int c_slot, int co,
                cudaStream_t stream) {
  const bool vec = co * sizeof(T) == 16 && (c_slot * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    dim3 grid(ceil_div(s, kTile), ceil_div(d, kTile), b);
    hwdc_vec_kernel<<<grid, dim3(kTile, kRows), 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), d, s,
        static_cast<int>(c_slot * sizeof(T) / 16));
  } else {
    dim3 grid(ceil_div(s, kTile), ceil_div(d, kTile), b * co);
    hwdc_kernel<T><<<grid, dim3(kTile, kRows), 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), d, s, c_slot, co);
  }
  return end();
}

}  // namespace
}  // namespace dv

DV_EXPORT int dv_unpack_hwdc(const void* x, void* out, int b, int d, long long s, int c_slot,
                             int co, int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16) return dv::launch_hwdc<__nv_bfloat16>(x, out, b, d, s, c_slot, co, st);
  return dv::launch_hwdc<float>(x, out, b, d, s, c_slot, co, st);
}

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
