// 3×3 dilated 2-D convolution + bias on channels-last (NHWC) tensors:
//   out (B, H, W, Co) = conv(x (B, H, W, Ci), w (3, 3, Ci, Co); pad d, dilation d) + bias
// with w in (kh, kw, Ci, Co) order and bias (Co,) float32 or null; a float32
// accumulator and one rounding to the input's dtype.
//   Replaces diffuvolume_tpu/ops/pallas/conv2d.py conv2d_flat: every 3×3
//   conv of PCWNet's full-resolution refinement net (models/pcw.py
//   _refine_flat of the JAX package): 146 (in a 160 slot) → 128 … 32 → 1
//   channels at dilations 1 to 16, 11 a refinement.
//   Plain version: ops/kernels/conv2d.py conv2d_flat_plain.
//
// What bounds it on the H100: bf16 tensor-core operations.  The 128→128
// conv at 384×1248 does 70.7 G multiply-adds (0.143 ms at 989 TFLOP/s) and
// moves 245 MB (0.073 ms at 3.35 TB/s).
//
// Design: conv_igemm.cuh's implicit GEMM in 2-D.  A block owns BH output
// rows of BM = 64 positions along W and BN output channels; each of its 8
// warps holds MT 16-position tiles × BN/8 channel tiles of float32
// accumulators.  A stage is one kh tap and one chunk of CK input channels:
// the block copies (cp.async) the BH input rows at offset (kh − 1)·d from
// its output rows, each a strip of BM + 2d positions, and the chunk's
// weights for the three kw taps; tap kw of output (r, m) reads strip row r,
// position m + kw·d.  Staging one kh tap at a time keeps the strip at BH rows
// whatever the dilation (d only widens each row by 2d positions: 96 at
// d = 16), where staging every row the block reaches would need BH + 2d.  A
// tap whose rows all fall in the padding is skipped; strip positions outside
// the input are zero, so the ragged W edge (1248 = 19.5 × 64) and H edge
// are masked like the padding.  C_in must be a multiple of 8 (16-byte rows;
// PCW's 146-channel input lives in a zero-filled 160-channel slot); a last
// chunk past C_in is zero-filled in shared memory.  C_out not a multiple of
// 8 (conv8's single channel) runs on zero weight columns and stores only the
// real channels.  The float32 form is a plain FMA kernel (no TF32) used
// where the agreement with the CPU is checked.  Inside a block the copies do
// not overlap the products (two blocks an SM overlap each other); TMA and
// wgmma are not used yet.
#include "conv_igemm.cuh"

namespace dv {
namespace conv2d {

using igemm::BM;
using igemm::kThreads;
using igemm::kWarps;

struct Params {
  const void* x;
  const void* w;       // (3, 3, C_in, C_out)
  const float* bias;   // (C_out,) or null
  void* out;
  int b, h, wd, cin, cout, dil;
};

// BH output rows of BM positions so that each warp holds MT × BN/8 tiles
// (64 accumulators a thread, 32 at BN 16), as igemm::Cfg.
template <int BN, int CK>
struct Cfg {
  static constexpr int BH = 256 / BN < 8 ? 256 / BN : 8;
  static constexpr int MT = BH * (BM / 16) / kWarps;
  static constexpr int N8 = BN / 8;
  // Row strides in elements: an odd multiple of 16 bytes, so the 8 rows one
  // ldmatrix phase reads fall in 8 different 16-byte bank groups.
  static constexpr int lda = CK + 8;
  static constexpr int ldb = BN + 8;
  static constexpr int ldc = BN + 4;   // float32 epilogue rows
  static __host__ __device__ int cols(int d) { return BM + 2 * d; }
  static __host__ __device__ size_t a_elems(int d) {
    return static_cast<size_t>(BH) * cols(d) * lda;
  }
  static __host__ __device__ size_t bytes(int d) {
    const size_t ab = a_elems(d) * 2 + static_cast<size_t>(3) * CK * ldb * 2;
    const size_t c = static_cast<size_t>(BH) * BM * ldc * 4;
    return ab > c ? ab : c;
  }
};

template <int BN, int CK>
__global__ void __launch_bounds__(kThreads, 2) conv2d_bf16(Params p) {
  using bf16 = __nv_bfloat16;
  using C = Cfg<BN, CK>;
  constexpr int BH = C::BH, MT = C::MT, N8 = C::N8;
  constexpr int lda = C::lda, ldb = C::ldb, ldc = C::ldc;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // Block → (W tile, N tile) × row tile × image.
  const int ntw = (p.wd + BM - 1) / BM;
  const int wt = blockIdx.x % ntw;
  const int n0 = (blockIdx.x / ntw) * BN;
  const int hy = blockIdx.y;
  const int b = blockIdx.z;
  const int d = p.dil;
  const int cols = C::cols(d);
  const int wbase = wt * BM - d;
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + C::a_elems(d);
  const unsigned as_s = static_cast<unsigned>(__cvta_generic_to_shared(as));
  const unsigned bs_s = static_cast<unsigned>(__cvta_generic_to_shared(bs));
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.w);
  const bf16* ximg = x + static_cast<size_t>(b) * p.h * p.wd * p.cin;

  float acc[MT][N8][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[t][j][k] = 0.f;

  // C_out not a multiple of 8: the weight columns past C_out are zeroed
  // once here and never written by a stage.
  const int nreal = p.cout - n0 < BN ? p.cout - n0 : BN;
  if (p.cout % 8 != 0) {
    for (int i = tid; i < 3 * CK * ldb; i += kThreads) bs[i] = __float2bfloat16(0.f);
  }

  // This lane's row / column within the 16×16 blocks that ldmatrix reads.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = lane & 15, b_col = (lane >> 4) * 8;

  for (int kh = 0; kh < 3; ++kh) {
    const int hb = hy * BH + (kh - 1) * d;  // input row of output row 0 at this tap
    if (hb + BH <= 0 || hb >= p.h) continue;  // every row in the padding: contributes 0
    for (int c0 = 0; c0 < p.cin; c0 += CK) {
      __syncthreads();  // the previous stage's products are done
      constexpr int vpr = CK / 8;
      for (int row = 0; row < BH; ++row) {
        const int hi = hb + row;
        const bool hok = hi >= 0 && hi < p.h;
        const bf16* xrow = ximg + (hok ? static_cast<size_t>(hi) * p.wd * p.cin : 0) + c0;
        bf16* dst = as + static_cast<size_t>(row) * cols * lda;
        for (int i = tid; i < cols * vpr; i += kThreads) {
          const int col = i / vpr, v = i % vpr;
          const int wi = wbase + col;
          const bool ok = hok && wi >= 0 && wi < p.wd && c0 + v * 8 < p.cin;
          igemm::cp_async16(dst + col * lda + v * 8,
                            ok ? xrow + static_cast<size_t>(wi) * p.cin + v * 8 : x, ok);
        }
      }
      if (p.cout % 8 == 0) {
        constexpr int nv = BN / 8;
        for (int i = tid; i < 3 * CK * nv; i += kThreads) {
          const int n = (i % nv) * 8, rest = i / nv;
          const int k = rest % CK, kw = rest / CK;
          const bool ok = n0 + n < p.cout && c0 + k < p.cin;
          igemm::cp_async16(
              bs + (kw * CK + k) * ldb + n,
              ok ? w + (static_cast<size_t>(kh * 3 + kw) * p.cin + c0 + k) * p.cout + n0 + n : w,
              ok);
        }
      } else {
        for (int i = tid; i < 3 * CK * nreal; i += kThreads) {
          const int n = i % nreal, rest = i / nreal;
          const int k = rest % CK, kw = rest / CK;
          bs[(kw * CK + k) * ldb + n] =
              c0 + k < p.cin
                  ? w[(static_cast<size_t>(kh * 3 + kw) * p.cin + c0 + k) * p.cout + n0 + n]
                  : __float2bfloat16(0.f);
        }
      }
      igemm::cp_async_wait_all();
      __syncthreads();

#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const unsigned bb = bs_s + 2 * (kw * CK * ldb + b_row * ldb + b_col);
        unsigned ab[MT];
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const int tile = warp * MT + t;
          const int r = tile / (BM / 16), m0 = (tile % (BM / 16)) * 16;
          ab[t] = as_s + 2 * ((r * cols + m0 + a_row + kw * d) * lda + a_col);
        }
#pragma unroll
        for (int kk = 0; kk < CK; kk += 16) {
          unsigned fa[MT][4];
#pragma unroll
          for (int t = 0; t < MT; ++t) igemm::ldsm_x4(fa[t], ab[t] + 2 * kk);
#pragma unroll
          for (int nb = 0; nb < BN / 16; ++nb) {
            unsigned fb[4];
            igemm::ldsm_x4_trans(fb, bb + 2 * (kk * ldb + nb * 16));
#pragma unroll
            for (int t = 0; t < MT; ++t) {
              igemm::mma_bf16(acc[t][2 * nb], fa[t], fb[0], fb[1]);
              igemm::mma_bf16(acc[t][2 * nb + 1], fa[t], fb[2], fb[3]);
            }
          }
        }
      }
    }
  }

  __syncthreads();  // strips and weights are dead; reuse the space for C
  float* cs = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int tile = warp * MT + t;
      const int r = tile / (BM / 16), m0 = (tile % (BM / 16)) * 16;
      float* c = cs + (r * BM + m0 + g) * ldc + 2 * q;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        *reinterpret_cast<float2*>(c + j * 8) = make_float2(acc[t][j][0], acc[t][j][1]);
        *reinterpret_cast<float2*>(c + 8 * ldc + j * 8) = make_float2(acc[t][j][2], acc[t][j][3]);
      }
    }
  }
  __syncthreads();

  // Epilogue: + bias, one rounding; 8 channels (16 bytes) a thread where
  // C_out allows, else one.
  bf16* out = static_cast<bf16*>(p.out);
  const int vec = p.cout % 8 == 0 ? 8 : 1;
  const int nvec = vec == 8 ? BN / 8 : nreal;
  for (int e = tid; e < BH * BM * nvec; e += kThreads) {
    const int n = (e % nvec) * vec;
    const int m = (e / nvec) % BM;
    const int r = e / (nvec * BM);
    const int co = n0 + n;
    const int ho = hy * BH + r;
    const int wo = wt * BM + m;
    if (co >= p.cout || ho >= p.h || wo >= p.wd) continue;
    const size_t o = ((static_cast<size_t>(b) * p.h + ho) * p.wd + wo) * p.cout + co;
    const float* c = cs + (r * BM + m) * ldc + n;
    if (vec == 8) {
      uint4 ov;
      bf16* oo = reinterpret_cast<bf16*>(&ov);
#pragma unroll
      for (int k = 0; k < 8; ++k) oo[k] = __float2bfloat16(c[k] + (p.bias ? p.bias[co + k] : 0.f));
      *reinterpret_cast<uint4*>(out + o) = ov;
    } else {
      out[o] = __float2bfloat16(c[0] + (p.bias ? p.bias[co] : 0.f));
    }
  }
}

// float32: one thread per output element, taps and input channels in order.
__global__ void conv2d_f32(Params p) {
  const long long total = static_cast<long long>(p.b) * p.h * p.wd * p.cout;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int co = static_cast<int>(e % p.cout);
  long long pos = e / p.cout;
  const int wo = static_cast<int>(pos % p.wd); pos /= p.wd;
  const int ho = static_cast<int>(pos % p.h);
  const int b = static_cast<int>(pos / p.h);
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  float acc = 0.f;
  for (int kh = 0; kh < 3; ++kh) {
    const int hi = ho + (kh - 1) * p.dil;
    if (hi < 0 || hi >= p.h) continue;
    for (int kw = 0; kw < 3; ++kw) {
      const int wi = wo + (kw - 1) * p.dil;
      if (wi < 0 || wi >= p.wd) continue;
      const float* xp = x + ((static_cast<size_t>(b) * p.h + hi) * p.wd + wi) * p.cin;
      const float* wp = w + static_cast<size_t>(kh * 3 + kw) * p.cin * p.cout + co;
      for (int ci = 0; ci < p.cin; ++ci) {
        acc = fmaf(xp[ci], wp[static_cast<size_t>(ci) * p.cout], acc);
      }
    }
  }
  if (p.bias) acc += p.bias[co];
  static_cast<float*>(p.out)[e] = acc;
}

template <int BN, int CK>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using C = Cfg<BN, CK>;
  const size_t smem = C::bytes(p.dil);
  cudaError_t e = cudaFuncSetAttribute(conv2d_bf16<BN, CK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(ceil_div(p.wd, BM) * ceil_div(p.cout, BN), ceil_div(p.h, C::BH), p.b);
  conv2d_bf16<BN, CK><<<grid, kThreads, smem, stream>>>(p);
  return end();
}

// Input channels a stage: 32, or 16 where C_in is not a multiple of 32 (the
// last chunk zero-filled past C_in).
template <int BN>
int launch_bf16(const Params& p, cudaStream_t stream) {
  return p.cin % 32 == 0 ? launch_bf16<BN, 32>(p, stream) : launch_bf16<BN, 16>(p, stream);
}

// N tile by C_out: 16 (conv8's single channel), 32, 64, 128; C_out 96 as
// three 32-channel tiles, not a 128 tile a quarter empty.
int launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == kBF16) {
    if (p.cout <= 16) return launch_bf16<16>(p, stream);
    if (p.cout <= 32) return launch_bf16<32>(p, stream);
    if (p.cout <= 64) return launch_bf16<64>(p, stream);
    if (p.cout % 128 == 0) return launch_bf16<128>(p, stream);
    return launch_bf16<32>(p, stream);
  }
  const long long total = static_cast<long long>(p.b) * p.h * p.wd * p.cout;
  constexpr int threads = 256;
  conv2d_f32<<<ceil_div(total, threads), threads, 0, stream>>>(p);
  return end();
}

}  // namespace conv2d
}  // namespace dv

DV_EXPORT int dv_conv2d_flat(const void* x, const void* w, const void* bias, void* out, int b,
                             int h, int wd, int cin, int cout, int dil, int dtype, int device,
                             void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  dv::conv2d::Params p;
  p.x = x; p.w = w; p.bias = static_cast<const float*>(bias); p.out = out;
  p.b = b; p.h = h; p.wd = wd; p.cin = cin; p.cout = cout; p.dil = dil;
  return dv::conv2d::launch(p, dtype, static_cast<cudaStream_t>(stream));
}
