// The bf16 1×1×1 conv on channels-last volumes (row 9, conv1x1_fold_p),
// through csrc/conv3d_fold.cu's dv_conv3d_fold with ks 1:
//   out (M, C_out) = act(x (M, C_in) · w (C_in, C_out) + bias (+ res))
// over the M = B·D·H·W positions, which NDHWC keeps contiguous.
//
// What bounds it on the H100: bytes.  At ACV's 32→32 at (48, 128, 240) it
// moves 94 MB in and 94 MB out (56 µs at 3.35 TB/s) for 2.4 G
// multiply-adds (5 µs at 989 TFLOP/s); at K = 16 … 128 every shape of the
// three paths is bound by its bytes.
//
// Design: a stream of tiles.  A tile is TM = 128·MT contiguous positions ×
// every input channel, with no W tails: the grid is persistent (as many
// blocks as the card holds, at most one a tile; block i takes tiles i,
// i + grid, …), and each block walks its tiles through a ring of 3 cp.async
// stages (2 where 3 do not fit, or where a block has 2 tiles at most and a
// smaller ring fits more blocks on an SM; 16 bytes a thread, the stage's
// tile and, where the conv has a residual, its residual tile), so the next
// tiles' copies are in flight while it multiplies one and stores another.  The x tile is stored
// swizzled (16-byte chunk c of a row at c ^ (row bits) within its 128-byte
// line), so the ldmatrix reads of 8 rows hit 8 bank groups at every C_in;
// the linear layout a bulk copy gives costs 4- to 8-way conflicts there.
// The weights (zero past C_out) and the bias are staged once a block, with
// the first tile.  The 8 warps each hold MT 16-position tiles × all BN
// channels of float32 accumulators (bf16 m16n8k16 mma.sync, A and B by
// ldmatrix); the epilogue (+ bias → + residual → act, one rounding, in
// float32 as before) writes bf16 into a staging buffer, and the block then
// stores the tile with 16-byte coalesced stores.  Two barriers a tile: one
// before the products (the stage has landed), one before the stores (the
// staging buffer is whole).  C_out above 128 runs as several BN-wide passes
// over the staged tile.  post_mul (IGEV's feature attention) never reaches
// a 1×1×1 conv and is refused.
#pragma once

#include "conv_igemm.cuh"

namespace dv {
namespace k1 {

using igemm::Params;
using igemm::activate;
using igemm::cp_async16;
using igemm::ldsm_x4;
using igemm::ldsm_x4_trans;
using igemm::mma_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;  // the most

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Every committed group of this thread but the newest stages − 1 complete.
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages == 3)
    asm volatile("cp.async.wait_group 2;\n" ::);
  else
    asm volatile("cp.async.wait_group 1;\n" ::);
}

// The 16-byte slot of chunk c (8 channels) of tile row r, with nc chunks a
// row: within each 128-byte line of the row-major tile, the slot's low three
// bits are XORed with the row's (nc ≥ 8) or the line's (nc < 8) low three
// bits, so any 8 consecutive rows' chunk c lie in 8 bank groups.
__device__ __forceinline__ int swz(int r, int c, int nc) {
  const int l = r * nc + c;
  const int key = nc >= 8 ? r : l >> 3;
  return (l & ~7) | ((l ^ key) & 7);
}

// Shared memory of one launch, in bytes: the ring (each stage the x tile,
// then the residual tile), the weights (C_in rows of ntn·BN channels + 8),
// the staging buffer (TM rows of C_out + 8 channels), the bias (float32,
// ntn·BN, zero past C_out).
struct Geo {
  int stages, ntn, ldb, lds;
  int x_bytes, stage_bytes, w_off, o_off, b_off, total;
};

inline int round128(int n) { return (n + 127) / 128 * 128; }

inline Geo geo(int tm, int bn, int cin, int cout, bool res, int stages) {
  Geo g;
  g.stages = stages;
  g.ntn = (cout + bn - 1) / bn;
  g.ldb = g.ntn * bn + 8;
  g.lds = cout + 8;
  g.x_bytes = tm * cin * 2;
  g.stage_bytes = round128(g.x_bytes + (res ? tm * cout * 2 : 0));
  g.w_off = stages * g.stage_bytes;
  g.o_off = g.w_off + round128(cin * g.ldb * 2);
  g.b_off = g.o_off + round128(tm * g.lds * 2);
  g.total = g.b_off + round128(g.ntn * bn * 4);
  return g;
}

// Two blocks an SM at least; four where a thread's accumulators are 16
// floats (BN·MT ≤ 32), so the small-channel shapes keep more tiles in flight.
template <int BN, int MT>
__global__ void __launch_bounds__(kThreads, BN * MT <= 32 ? 4 : 2)
    conv_k1(Params p, Geo g, long long m_total, int ntiles) {
  using bf16 = __nv_bfloat16;
  constexpr int TM = kWarps * 16 * MT;
  constexpr int N8 = BN / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem + g.w_off);
  bf16* ob = reinterpret_cast<bf16*>(smem + g.o_off);
  float* bs = reinterpret_cast<float*>(smem + g.b_off);
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.w);
  const bf16* res = static_cast<const bf16*>(p.res);
  bf16* out = static_cast<bf16*>(p.out);
  const int cin = p.cin, cout = p.cout, nc = cin / 8, vpr = cout / 8;
  const int coutp = g.ntn * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int first = blockIdx.x, step = gridDim.x;
  const int tiles = first < ntiles ? (ntiles - 1 - first) / step + 1 : 0;

  // Tile `it` of this block into stage it % stages, zero past the last
  // position (every thread, one commit group a tile even past the end).
  auto load = [&](int it) {
    if (it < tiles) {
      const long long m0 = static_cast<long long>(first + it * step) * TM;
      unsigned char* st = smem + static_cast<size_t>(it % g.stages) * g.stage_bytes;
      for (int i = tid; i < TM * nc; i += kThreads) {
        const int r = i / nc, c = i % nc;
        const bool ok = m0 + r < m_total;
        cp_async16(st + swz(r, c, nc) * 16, ok ? x + (m0 + r) * cin + c * 8 : x, ok);
      }
      if (res) {
        bf16* rs = reinterpret_cast<bf16*>(st + g.x_bytes);
        for (int i = tid; i < TM * vpr; i += kThreads) {
          const int r = i / vpr, v = i % vpr * 8;
          const bool ok = m0 + r < m_total;
          cp_async16(rs + r * cout + v, ok ? res + (m0 + r) * cout + v : res, ok);
        }
      }
    }
    cp_async_commit();
  };

  // The weights (zero past C_out) and the bias with the first tile.
  const int wv = coutp / 8;
  for (int i = tid; i < cin * wv; i += kThreads) {
    const int k = i / wv, n = i % wv * 8;
    const bool ok = n < cout;
    cp_async16(ws + k * g.ldb + n, ok ? w + static_cast<size_t>(k) * cout + n : w, ok);
  }
  for (int n = tid; n < coutp; n += kThreads) bs[n] = p.bias && n < cout ? p.bias[n] : 0.f;
  for (int it = 0; it < g.stages - 1; ++it) load(it);

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_chunk = lane >> 4;
  const int b_row = lane & 15, b_col = (lane >> 4) * 8;
  const int g4 = lane >> 2, q4 = lane & 3;
  const unsigned ws_s = static_cast<unsigned>(__cvta_generic_to_shared(ws));

  for (int it = 0; it < tiles; ++it) {
    load(it + g.stages - 1);
    cp_async_wait_ring(g.stages);
    __syncthreads();  // tile it has landed for every thread (and the weights)
    const long long m0 = static_cast<long long>(first + it * step) * TM;
    const int rows = static_cast<int>(m_total - m0 < TM ? m_total - m0 : TM);
    const unsigned char* st = smem + static_cast<size_t>(it % g.stages) * g.stage_bytes;
    const unsigned xs_s = static_cast<unsigned>(__cvta_generic_to_shared(st));
    const bf16* rs = reinterpret_cast<const bf16*>(st + g.x_bytes);

    for (int nt = 0; nt < g.ntn; ++nt) {
      float acc[MT][N8][4];
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int j = 0; j < N8; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[t][j][k] = 0.f;
      for (int kk = 0; kk < cin; kk += 16) {
        unsigned fa[MT][4];
#pragma unroll
        for (int t = 0; t < MT; ++t)
          ldsm_x4(fa[t], xs_s + 16 * swz((warp * MT + t) * 16 + a_row, kk / 8 + a_chunk, nc));
#pragma unroll
        for (int nb = 0; nb < BN / 16; ++nb) {
          unsigned fb[4];
          ldsm_x4_trans(fb, ws_s + 2 * ((kk + b_row) * g.ldb + nt * BN + nb * 16 + b_col));
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            mma_bf16(acc[t][2 * nb], fa[t], fb[0], fb[1]);
            mma_bf16(acc[t][2 * nb + 1], fa[t], fb[2], fb[3]);
          }
        }
      }
      // Epilogue: a thread's fragment (t, j) is rows r and r + 8, channels
      // c and c + 1 (C_out is a multiple of 8, so both or neither exist).
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        const int c = nt * BN + j * 8 + 2 * q4;
        if (c >= cout) continue;
        const float b0 = bs[c], b1 = bs[c + 1];
#pragma unroll
        for (int t = 0; t < MT; ++t) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = (warp * MT + t) * 16 + g4 + 8 * hf;
            float v0 = acc[t][j][2 * hf] + b0, v1 = acc[t][j][2 * hf + 1] + b1;
            if (res) {
              const __nv_bfloat162 rr =
                  *reinterpret_cast<const __nv_bfloat162*>(rs + static_cast<size_t>(r) * cout + c);
              v0 += __low2float(rr);
              v1 += __high2float(rr);
            }
            *reinterpret_cast<__nv_bfloat162*>(ob + r * g.lds + c) =
                __floats2bfloat162_rn(activate(v0, p.act), activate(v1, p.act));
          }
        }
      }
    }
    __syncthreads();  // the staging buffer is whole; stage it % stages is read
    bf16* og = out + m0 * cout;
    for (int i = tid; i < rows * vpr; i += kThreads) {
      const int r = i / vpr, v = i % vpr * 8;
      *reinterpret_cast<uint4*>(og + static_cast<size_t>(r) * cout + v) =
          *reinterpret_cast<const uint4*>(ob + r * g.lds + v);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);  // no copy outlives the block
}

// One launch's plan, in ops/kernels/_build.py K1_PLAN_KEYS order.
struct Plan {
  int tm, stages, blocks, per_sm, smem, tiles, bn;
};
constexpr int kPlanInts = sizeof(Plan) / sizeof(int);

// The grid: as many blocks as the card holds at the plan's shared memory
// and the kernel's registers (the occupancy API, the carveout set to all
// shared memory), at most one a tile.
template <int BN, int MT>
cudaError_t plan_for(const Params& p, int device, Plan& pl, Geo& g) {
  constexpr int TM = kWarps * 16 * MT;
  auto kernel = conv_k1<BN, MT>;
  static bool prepared = false;
  int sms = 0, optin = 0;
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
    return e;
  if (cudaError_t e =
          cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device))
    return e;
  if (!prepared) {
    if (cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin))
      return e;
    if (cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared))
      return e;
    prepared = true;
  }
  const long long m_total = static_cast<long long>(p.b) * p.d_out * p.h_out * p.w_out;
  const long long tiles = (m_total + TM - 1) / TM;
  int per_sm = 0;
  // 3 stages; 2 where 3 do not fit, or where every block has 2 tiles at
  // most and the smaller ring lets more blocks share an SM.
  for (int stages = kStages; stages >= 2; --stages) {
    const Geo gs = geo(TM, BN, p.cin, p.cout, p.res != nullptr, stages);
    if (gs.total > optin) continue;
    int n = 0;
    if (cudaError_t e =
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, gs.total))
      return e;
    if (n <= per_sm) break;
    g = gs;
    per_sm = n;
    if (tiles > 2LL * per_sm * sms) break;
  }
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long long slots = static_cast<long long>(per_sm) * sms;
  pl.tm = TM; pl.stages = g.stages; pl.per_sm = per_sm; pl.smem = g.total;
  pl.tiles = static_cast<int>(tiles); pl.bn = BN;
  pl.blocks = static_cast<int>(tiles < slots ? tiles : slots);
  return cudaSuccess;
}

template <int BN, int MT>
cudaError_t run(bool do_launch, const Params& p, int device, Plan& pl, cudaStream_t stream) {
  Geo g;
  if (cudaError_t e = plan_for<BN, MT>(p, device, pl, g)) return e;
  if (!do_launch) return cudaSuccess;
  const long long m_total = static_cast<long long>(p.b) * p.d_out * p.h_out * p.w_out;
  conv_k1<BN, MT><<<pl.blocks, kThreads, pl.smem, stream>>>(p, g, m_total, pl.tiles);
  return cudaGetLastError();
}

// The bf16 1×1×1 conv (C_in a multiple of 16, C_out of 8): planned
// (do_launch false: `pl` only) or planned and launched.  BN the C_out tile
// (16, 32, 64, or 128 as several passes); 256-position tiles (MT 2) at
// BN ≤ 32 where they still give every SM two, else 128.
inline cudaError_t k1(bool do_launch, const Params& p, int device, Plan& pl,
                      cudaStream_t stream) {
  if (p.ks != 1 || p.stride != 1 || p.cout % 8 != 0 || p.cin % 16 != 0 || p.post_mul)
    return cudaErrorInvalidValue;
  int sms = 0;
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
    return e;
  const long long m = static_cast<long long>(p.b) * p.d_out * p.h_out * p.w_out;
  const bool wide = m >= 256LL * 2 * sms;
  if (p.cout <= 16)
    return wide ? run<16, 2>(do_launch, p, device, pl, stream)
                : run<16, 1>(do_launch, p, device, pl, stream);
  if (p.cout <= 32)
    return wide ? run<32, 2>(do_launch, p, device, pl, stream)
                : run<32, 1>(do_launch, p, device, pl, stream);
  if (p.cout <= 64) return run<64, 1>(do_launch, p, device, pl, stream);
  return run<128, 1>(do_launch, p, device, pl, stream);
}

}  // namespace k1
}  // namespace dv
