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
// Design, pack and unpack: one transposer.  Both are the transpose of a
// (B, M, N) matrix into (B, N, ldo), the columns M..ldo zero: pack M = C,
// N = S, ldo = c_slot; unpack M = S, N = C, ldo = S.  At the main path's
// shape a launch moves 5.9 MB each way, both sides hot in L2, so it is
// ramp, tail and access width more than bytes.  The 16-byte form
// (transpose_vec_kernel): a thread loads a kVec × kVec block (8 × 8 bf16, 4
// × 4 float32) by kVec 16-byte loads, transposes it in registers (stage.cuh
// transpose_column: byte permutes) and makes kVec 16-byte stores.  A warp
// tile is LR blocks down the input's rows × 32 / LR across its columns, so
// each load instruction reads LR runs of 512 / LR contiguous bytes and each
// store writes 32 / LR runs of 16·LR bytes (LR 4 by default: 128-byte loads,
// 64-byte stores; every 32-byte sector whole).  A single wave of persistent
// blocks (sized from the SM count and the occupancy) walks the warp tiles.
// It needs N and ldo in whole 16-byte vectors and both pointers 16-byte
// aligned (M is free: rows ≥ M read as zero, the slot fill); any other
// call takes the element form, a 32 × 32 shared-memory tile read and
// written coalesced along each side's minor axis (one padding column, no
// bank conflicts).
//
// unpack_hwdc transposes (d, s) with a shared-memory tile, co channels as
// the unit: one 16-byte vector where co fills one (the GEV), else one
// channel a block layer; a one-channel slot (the cost) is the transposer's
// (D, S) → (S, D).  The
// TPU kernels' D-phase lane packing, halo cells, tile rows and 0/1
// channel-selection matmul are not carried over.
#include <cstring>

#include "common.cuh"
#include "stage.cuh"

namespace dv {
namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // threads per tile column; each moves kTile / kRows

// -- pack / unpack: the transposer -----------------------------------------

// One shape's plan, in ops/kernels/_build.py TRANSPOSE_PLAN_KEYS order: the
// 16-byte form (vec 1) or the element form (0), its lanes a tile column
// (LR), warp tiles (32 × 32 tiles for the element form), threads and
// blocks, blocks an SM.
struct TransposePlan {
  int vec, lr, tiles, threads, blocks, blocks_per_sm;
};

constexpr int kTThreads = 256;  // the 16-byte form's threads a block

// out (B, N, ldo) ← x (B, M, N): out[b][j][i] = x[b][i][j] for i < M, 0 for
// M ≤ i < ldo.  N and ldo whole 16-byte vectors, both pointers aligned.
template <typename T, int LR>
__global__ void __launch_bounds__(kTThreads)
    transpose_vec_kernel(const T* __restrict__ x, T* __restrict__ out, int m, int n, int ldo,
                         int row_tiles, int col_tiles, int tiles) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowsW = kVec * LR;          // input rows a warp tile
  constexpr int kColsW = kVec * (32 / LR);   // input columns a warp tile
  const int lane = threadIdx.x & 31;
  const int lr = lane % LR, lc = lane / LR;
  const int warps = gridDim.x * (blockDim.x / 32);
  for (int t = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; t < tiles; t += warps) {
    const int ct = t % col_tiles, rt = (t / col_tiles) % row_tiles;
    const int b = t / (col_tiles * row_tiles);
    const int i0 = rt * kRowsW + lr * kVec;  // the lane's first input row (output column)
    const int j0 = ct * kColsW + lc * kVec;  // its first input column (output row)
    if (i0 >= ldo || j0 >= n) continue;
    const T* xb = x + static_cast<size_t>(b) * m * n + j0;
    uint4 e[kVec];
#pragma unroll
    for (int r = 0; r < kVec; ++r) {
      e[r] = i0 + r < m ? __ldg(reinterpret_cast<const uint4*>(xb + static_cast<size_t>(i0 + r) * n))
                        : make_uint4(0, 0, 0, 0);
    }
    T* ob = out + (static_cast<size_t>(b) * n + j0) * ldo + i0;
#pragma unroll
    for (int p = 0; p < kVec; ++p)
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(p) * ldo) = transpose_column<T>(e, p);
  }
}

// The element form of the same transpose: a 32 × 32 tile a block, the grid
// over (B, column tiles, row tiles) in one dimension.
template <typename T>
__global__ void transpose_tile_kernel(const T* __restrict__ x, T* __restrict__ out, int m,
                                      int n, int ldo, int col_tiles, int row_tiles) {
  __shared__ T tile[kTile][kTile + 1];
  const int ct = blockIdx.x % col_tiles, rt = (blockIdx.x / col_tiles) % row_tiles;
  const int b = blockIdx.x / (col_tiles * row_tiles);
  const int j0 = ct * kTile, i0 = rt * kTile;
  const T* xb = x + static_cast<size_t>(b) * m * n;
  for (int r = threadIdx.y; r < kTile; r += kRows) {
    const int i = i0 + r, j = j0 + threadIdx.x;
    tile[r][threadIdx.x] = (i < m && j < n) ? xb[static_cast<size_t>(i) * n + j] : from_f32<T>(0.f);
  }
  __syncthreads();
  T* ob = out + static_cast<size_t>(b) * n * ldo;
  for (int r = threadIdx.y; r < kTile; r += kRows) {
    const int j = j0 + r, i = i0 + threadIdx.x;
    if (j < n && i < ldo) ob[static_cast<size_t>(j) * ldo + i] = tile[threadIdx.x][r];
  }
}

// The 16-byte form at lr lanes a tile column (2, 4 or 8).
template <typename T>
auto transpose_vec_for(int lr) {
  return lr == 2 ? transpose_vec_kernel<T, 2>
                 : (lr == 8 ? transpose_vec_kernel<T, 8> : transpose_vec_kernel<T, 4>);
}

// The rule: the 16-byte form where N and ldo are whole vectors and both
// pointers aligned (`aligned`), 4 lanes a tile column, kTThreads threads a
// block, one warp a tile, as many blocks as the tiles need up to the wave
// the occupancy allows (then the warps walk the rest); else the element
// form, one block a tile.  force_lr > 0 takes that form instead (1 the
// element form, 2, 4 or 8 lanes a tile column), force_blocks > 0 that grid.
template <typename T>
cudaError_t transpose_plan_t(int b, int m, int n, int ldo, bool aligned, int force_lr,
                             int force_blocks, int device, TransposePlan& p) {
  constexpr int kVec = 16 / sizeof(T);
  if (b < 1 || m < 1 || n < 1 || ldo < m) return cudaErrorInvalidValue;
  int sms = 0;
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
    return e;
  const bool can_vec = aligned && n % kVec == 0 && ldo % kVec == 0;
  p.vec = force_lr == 1 ? 0 : (force_lr > 1 ? 1 : can_vec);
  if (p.vec && !can_vec) return cudaErrorInvalidValue;
  if (!p.vec) {
    p.lr = 0;
    p.threads = kTile * kRows;
    p.tiles = b * ceil_div(n, kTile) * ceil_div(ldo, kTile);
    p.blocks = p.tiles;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.blocks_per_sm,
                                                         transpose_tile_kernel<T>, p.threads, 0);
  }
  p.lr = force_lr > 1 ? force_lr : 4;
  if (p.lr != 2 && p.lr != 4 && p.lr != 8) return cudaErrorInvalidValue;
  p.threads = kTThreads;
  const long long tiles = static_cast<long long>(b) * ceil_div(ldo, kVec * p.lr) *
                          ceil_div(n, kVec * (32 / p.lr));
  if (tiles > (1LL << 31) - 1) return cudaErrorInvalidValue;
  p.tiles = static_cast<int>(tiles);
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &p.blocks_per_sm, transpose_vec_for<T>(p.lr), p.threads, 0))
    return e;
  const long long wave = static_cast<long long>(sms) * max(p.blocks_per_sm, 1);
  p.blocks = force_blocks > 0
                 ? force_blocks
                 : static_cast<int>(ceil_div(tiles, kTThreads / 32) < wave
                                        ? ceil_div(tiles, kTThreads / 32)
                                        : wave);
  return cudaSuccess;
}

template <typename T>
int launch_transpose(const void* x, void* out, const TransposePlan& p, int b, int m, int n,
                     int ldo, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  auto xs = static_cast<const T*>(x);
  auto os = static_cast<T*>(out);
  if (!p.vec) {
    transpose_tile_kernel<T><<<p.blocks, dim3(kTile, kRows), 0, stream>>>(
        xs, os, m, n, ldo, ceil_div(n, kTile), ceil_div(ldo, kTile));
    return end();
  }
  auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  if (!aligned(x) || !aligned(out) || n % kVec || ldo % kVec ||
      (p.lr != 2 && p.lr != 4 && p.lr != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = ceil_div(ldo, kVec * p.lr), col_tiles = ceil_div(n, kVec * (32 / p.lr));
  auto kern = transpose_vec_for<T>(p.lr);
  kern<<<p.blocks, p.threads, 0, stream>>>(xs, os, m, n, ldo, row_tiles, col_tiles, p.tiles);
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

// A one-channel slot (the cost, c_slot = co = 1) is the transpose of (B, D,
// S) into (B, S, D): pack's transposer on `plan` (its plan for (b, D, S,
// D)), which measured 2.8 times faster at IGEV's shape than a tile of
// single channels.
template <typename T>
int launch_hwdc(const void* x, void* out, const int* plan, int b, int d, long long s,
                int c_slot, int co, cudaStream_t stream) {
  if (c_slot == 1) {
    if (plan == nullptr || s > (1LL << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
    TransposePlan p;
    std::memcpy(&p, plan, sizeof p);
    return launch_transpose<T>(x, out, p, b, d, static_cast<int>(s), d, stream);
  }
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

// `plan`: for a one-channel slot, dv_transpose_plan's for (b, d, s, d); else
// unused.
DV_EXPORT int dv_unpack_hwdc(const void* x, void* out, const int* plan, int b, int d,
                             long long s, int c_slot, int co, int dtype, int device,
                             void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == dv::kBF16)
    return dv::launch_hwdc<__nv_bfloat16>(x, out, plan, b, d, s, c_slot, co, st);
  return dv::launch_hwdc<float>(x, out, plan, b, d, s, c_slot, co, st);
}

// The plan (TransposePlan's ints) of pack / unpack's transpose for a
// (B, M, N) → (B, N, ldo) shape: dtype code, both pointers 16-byte aligned
// or not, a forced form and grid (0: the rule's), device.
DV_EXPORT int dv_transpose_plan(int b, int m, int n, int ldo, int dtype, int aligned, int lr,
                                int blocks, int device, int* plan) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  dv::TransposePlan p;
  cudaError_t e =
      dtype == dv::kBF16
          ? dv::transpose_plan_t<__nv_bfloat16>(b, m, n, ldo, aligned, lr, blocks, device, p)
          : dv::transpose_plan_t<float>(b, m, n, ldo, aligned, lr, blocks, device, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::memcpy(plan, &p, sizeof p);
  return 0;
}

template <typename T>
static int transpose_with(const void* x, void* out, const int* plan, int b, int m, int n,
                          int ldo, void* stream) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dv::TransposePlan p;
  std::memcpy(&p, plan, sizeof p);
  return dv::launch_transpose<T>(x, out, p, b, m, n, ldo, static_cast<cudaStream_t>(stream));
}

// pack: x (B, C, S) → out (B, S, c_slot); `plan`: dv_transpose_plan's for
// (b, C, S, c_slot).
DV_EXPORT int dv_pack(const void* x, void* out, const int* plan, int b, int c, long long s,
                      int c_slot, int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  if (s > (1LL << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(s);
  if (dtype == dv::kBF16) return transpose_with<__nv_bfloat16>(x, out, plan, b, c, n, c_slot, stream);
  return transpose_with<float>(x, out, plan, b, c, n, c_slot, stream);
}

// unpack: x (B, S, C) → out (B, C, S); `plan`: dv_transpose_plan's for
// (b, S, C, S).
DV_EXPORT int dv_unpack(const void* x, void* out, const int* plan, int b, int c, long long s,
                        int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  if (s > (1LL << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  const int m = static_cast<int>(s);
  if (dtype == dv::kBF16) return transpose_with<__nv_bfloat16>(x, out, plan, b, m, c, m, stream);
  return transpose_with<float>(x, out, plan, b, m, c, m, stream);
}
