// Implicit-GEMM 3-D convolution on channels-last (NDHWC) volumes: the bf16
// 1×1×1 conv of csrc/conv3d_fold.cu (row 9, conv1x1_fold_p), and the float32
// FMA form of every conv, the stride-2 and transposed ones included
// (csrc/conv3d_up.cu).  The bf16 3×3×3 convs (stride 1, stride 2,
// transposed) are csrc/conv_hopper.cuh's; its kernels share this header's
// Params, epilogue activation and copy / ldmatrix / mma.sync helpers.
//
// GEMM view (1×1×1).  A block owns BH output rows of BM = 64 positions along
// W at one (b, d) and BN output channels: M = BH·BM positions, N = BN
// channels, K = C_in; BH = min(8, 256 / BN), so each of its 8 warps holds 64
// accumulators a thread.  A stage is one chunk of CK = 32 (or 16) input
// channels; channels past C_in in the last chunk are zero-filled in shared
// memory, input and weights alike.  The block copies (cp.async) its rows'
// positions and the chunk's weights, then every warp reads its operands
// with ldmatrix and runs bf16 m16n8k16 tensor-core products (mma.sync) into
// float32 accumulators.  Positions outside the input are zero.
//
// Transposed conv in gather form (the float32 form).  Output o takes input
// i = (o + 1 - k) / 2 where that is an integer in range.  k3 (op1): even o
// takes k = 1 (i = o/2), odd o takes k = 0 (i = (o+1)/2) and k = 2
// (i = (o-1)/2).  k4 (op0): even o takes k = 1 (i = o/2) and k = 3
// (i = o/2 - 1), odd o takes k = 0 (i = (o+1)/2) and k = 2 (i = (o-1)/2).
//
// Epilogue in float32: + bias, + residual (same shape as the output), the
// activation (none, ReLU, Mish or LeakyReLU 0.01), × post_mul (a
// (B, H_out, W_out, C_out) map broadcast over D: IGEV's feature attention),
// one rounding to bfloat16.  The float32 form is a plain FMA kernel (no TF32)
// used where the agreement with the CPU is checked.
#pragma once

#include "common.cuh"

namespace dv {
namespace igemm {

constexpr int BM = 64;       // output positions along W per row of a block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

struct Params {
  const void* x;
  const void* w;       // (k, k, k, C_in, C_out): tap-major, then C_in, then C_out
  const float* bias;   // (C_out,) or null
  const void* res;     // output-shaped residual or null
  const void* post_mul;  // (B, H_out, W_out, C_out) multiplier or null
  void* out;
  int b, d_in, h_in, w_in, cin;
  int d_out, h_out, w_out, cout;
  int ks, stride, pad, act;  // act: an Act code
};

// Activation codes, as in ops/kernels/conv3d_fold.py ACT_CODES.
enum Act { kActNone = 0, kActRelu = 1, kActMish = 2, kActLeaky = 3 };

// Mish as the TPU kernels take it (diffuvolume_tpu/ops/pallas/conv3d.py
// _apply_act): x·tanh(softplus(x)) = x·((1+eˣ)² − 1)/((1+eˣ)² + 1), one exp;
// x above 20 passes through (tanh has saturated), which also keeps eˣ finite.
// Always in float32, so a bf16 output never sees the intermediate.
__device__ __forceinline__ float activate(float x, int act) {
  if (act == kActRelu) return fmaxf(x, 0.f);
  if (act == kActLeaky) return x > 0.f ? x : 0.01f * x;
  if (act == kActMish) {
    if (x > 20.f) return x;
    const float z = expf(x);
    const float t = (1.f + z) * (1.f + z);
    return x * (t - 1.f) / (t + 1.f);
  }
  return x;
}

// The taps of one axis: tap t reads kernel index k[t] at input base + off[t].
struct Taps {
  int n;
  int k[3];
  int off[3];
};

__device__ __forceinline__ Taps conv_taps(int ks) {
  Taps t;
  t.n = ks;
  for (int i = 0; i < 3; ++i) t.k[i] = t.off[i] = i;
  return t;
}

// ConvTranspose s2 p1, output o = 2m + parity: k3 (op1) offsets from input
// m, k4 (op0) offsets from input m - 1 (up_lo).
__device__ __forceinline__ int up_lo(int ks) { return ks == 4 ? 1 : 0; }

__device__ __forceinline__ Taps up_taps(int parity, int ks) {
  Taps t;
  t.n = 2;
  t.k[2] = t.off[2] = 0;
  if (ks == 4) {
    if (parity == 0) {
      t.k[0] = 1; t.off[0] = 1;   // i = m
      t.k[1] = 3; t.off[1] = 0;   // i = m - 1
    } else {
      t.k[0] = 0; t.off[0] = 2;   // i = m + 1
      t.k[1] = 2; t.off[1] = 1;   // i = m
    }
  } else if (parity == 0) {
    t.n = 1;
    t.k[0] = 1; t.off[0] = 0;
    t.k[1] = t.off[1] = 0;
  } else {
    t.k[0] = 0; t.off[0] = 1;
    t.k[1] = 2; t.off[1] = 0;
  }
  return t;
}

// Tile configuration of the 1×1×1 conv for BN output channels and CK input
// channels a stage: BH output rows of BM positions, so that each of the 8
// warps holds MT 16-position tiles × BN/8 8-channel tiles of accumulators
// (64 floats a thread, 32 at BN 16).
template <int BN, int CK>
struct Cfg {
  static constexpr int BH = 256 / BN < 8 ? 256 / BN : 8;
  static constexpr int MT = BH * (BM / 16) / kWarps;
  static constexpr int N8 = BN / 8;
  // Row strides in elements.  Strip positions and weight rows are an odd
  // multiple of 16 bytes apart, so the 8 rows one ldmatrix phase reads fall
  // in 8 different 16-byte bank groups.
  static constexpr int lda = CK + 8;
  static constexpr int ldb = BN + 8;
  static constexpr int ldc = BN + 4;   // float32 epilogue rows
  static constexpr size_t a_elems = static_cast<size_t>(BH) * BM * lda;
  static constexpr size_t bytes() {
    const size_t ab = a_elems * 2 + static_cast<size_t>(CK) * ldb * 2;
    const size_t c = static_cast<size_t>(BH) * BM * ldc * 4;
    return ab > c ? ab : c;
  }
};

// 16-byte global → shared copy that bypasses registers; a false `valid`
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Four 8×8 b16 matrices from shared memory (lane l gives the shared-space
// byte address of row l % 8 of matrix l / 8); `.trans` hands each thread a
// column pair instead.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c (16×8 float32) += a (16×16 bf16, row-major) · b (16×8 bf16, col-major).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 1×1×1 conv.  Two blocks an SM (at most 128 registers a thread), so
// that one block's copies overlap the other's products.
template <int BN, int CK>
__global__ void __launch_bounds__(kThreads, 2) igemm_bf16(Params p) {
  using bf16 = __nv_bfloat16;
  using C = Cfg<BN, CK>;
  constexpr int BH = C::BH, MT = C::MT, N8 = C::N8;
  constexpr int lda = C::lda, ldb = C::ldb, ldc = C::ldc;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // Block → (W tile, N tile) × row tile × (b, d).
  const int ntw = (p.w_out + BM - 1) / BM;
  const int wt = blockIdx.x % ntw;
  const int n0 = blockIdx.x / ntw * BN;
  const int hy = blockIdx.y;
  const int b = blockIdx.z / p.d_out;
  const int dz = blockIdx.z % p.d_out;

  const int h0 = hy * BH, w0 = wt * BM;
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + C::a_elems;
  const unsigned as_s = static_cast<unsigned>(__cvta_generic_to_shared(as));
  const unsigned bs_s = static_cast<unsigned>(__cvta_generic_to_shared(bs));
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.w);
  const bf16* xplane = x + (static_cast<size_t>(b) * p.d_in + dz) * p.h_in *
                               static_cast<size_t>(p.w_in) * p.cin;

  float acc[MT][N8][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[t][j][k] = 0.f;

  // This lane's row / column within the 16×16 blocks that ldmatrix reads.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = lane & 15, b_col = (lane >> 4) * 8;

  for (int c0 = 0; c0 < p.cin; c0 += CK) {
    __syncthreads();  // the previous stage's products are done
    constexpr int vpr = CK / 8;
    for (int i = tid; i < BH * BM * vpr; i += kThreads) {
      const int v = i % vpr, m = (i / vpr) % BM, row = i / (vpr * BM);
      const int hi = h0 + row, wi = w0 + m;
      const bool ok = hi < p.h_in && wi < p.w_in && c0 + v * 8 < p.cin;
      cp_async16(as + (row * BM + m) * lda + v * 8,
                 ok ? xplane + (static_cast<size_t>(hi) * p.w_in + wi) * p.cin + c0 + v * 8 : x,
                 ok);
    }
    constexpr int nv = BN / 8;
    for (int i = tid; i < CK * nv; i += kThreads) {
      const int n = (i % nv) * 8, k = i / nv;
      const bool ok = n0 + n < p.cout && c0 + k < p.cin;
      cp_async16(bs + k * ldb + n, ok ? w + static_cast<size_t>(c0 + k) * p.cout + n0 + n : w, ok);
    }
    cp_async_wait_all();
    __syncthreads();

    const unsigned bb = bs_s + 2 * (b_row * ldb + b_col);
    unsigned ab[MT];
#pragma unroll
    for (int t = 0; t < MT; ++t) ab[t] = as_s + 2 * (((warp * MT + t) * 16 + a_row) * lda + a_col);
#pragma unroll
    for (int kk = 0; kk < CK; kk += 16) {
      unsigned fa[MT][4];
#pragma unroll
      for (int t = 0; t < MT; ++t) ldsm_x4(fa[t], ab[t] + 2 * kk);
#pragma unroll
      for (int nb = 0; nb < BN / 16; ++nb) {
        unsigned fb[4];
        ldsm_x4_trans(fb, bb + 2 * (kk * ldb + nb * 16));
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          mma_bf16(acc[t][2 * nb], fa[t], fb[0], fb[1]);
          mma_bf16(acc[t][2 * nb + 1], fa[t], fb[2], fb[3]);
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
      float* c = cs + ((warp * MT + t) * 16 + g) * ldc + 2 * q;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        *reinterpret_cast<float2*>(c + j * 8) = make_float2(acc[t][j][0], acc[t][j][1]);
        *reinterpret_cast<float2*>(c + 8 * ldc + j * 8) = make_float2(acc[t][j][2], acc[t][j][3]);
      }
    }
  }
  __syncthreads();

  // Epilogue, 8 channels (16 bytes) a thread.
  const bf16* res = static_cast<const bf16*>(p.res);
  const bf16* pm = static_cast<const bf16*>(p.post_mul);
  bf16* out = static_cast<bf16*>(p.out);
  constexpr int nvec = BN / 8;
  for (int e = tid; e < BH * BM * nvec; e += kThreads) {
    const int n = (e % nvec) * 8;
    const int m = (e / nvec) % BM;
    const int r = e / (nvec * BM);
    const int co = n0 + n;
    const int ho = h0 + r, wo = w0 + m;
    if (co >= p.cout || ho >= p.h_out || wo >= p.w_out) continue;
    const size_t o =
        (((static_cast<size_t>(b) * p.d_out + dz) * p.h_out + ho) * p.w_out + wo) * p.cout + co;
    // post_mul: the same (h, w) on every plane
    const size_t po = ((static_cast<size_t>(b) * p.h_out + ho) * p.w_out + wo) * p.cout + co;
    const float* c = cs + (r * BM + m) * ldc + n;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = c[k] + (p.bias ? p.bias[co + k] : 0.f);
    if (res) {
      const uint4 rv = *reinterpret_cast<const uint4*>(res + o);
      const bf16* rr = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] += __bfloat162float(rr[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = activate(v[k], p.act);
    if (pm) {
      const uint4 mv = *reinterpret_cast<const uint4*>(pm + po);
      const bf16* mm = reinterpret_cast<const bf16*>(&mv);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] *= __bfloat162float(mm[k]);
    }
    uint4 ov;
    bf16* oo = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int k = 0; k < 8; ++k) oo[k] = __float2bfloat16(v[k]);
    *reinterpret_cast<uint4*>(out + o) = ov;
  }
}

// float32: one thread per output element, taps and input channels in order.
template <bool UP>
__global__ void direct_f32(Params p) {
  const long long total = static_cast<long long>(p.b) * p.d_out * p.h_out * p.w_out * p.cout;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int co = static_cast<int>(e % p.cout);
  long long pos = e / p.cout;
  const int wo = static_cast<int>(pos % p.w_out); pos /= p.w_out;
  const int ho = static_cast<int>(pos % p.h_out); pos /= p.h_out;
  const int dz = static_cast<int>(pos % p.d_out);
  const int b = static_cast<int>(pos / p.d_out);
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  const Taps td = UP ? up_taps(dz % 2, p.ks) : conv_taps(p.ks);
  const Taps th = UP ? up_taps(ho % 2, p.ks) : conv_taps(p.ks);
  const Taps tw = UP ? up_taps(wo % 2, p.ks) : conv_taps(p.ks);
  const int lo = UP ? up_lo(p.ks) : 0;
  const int db = UP ? dz / 2 - lo : dz * p.stride - p.pad;
  const int hb = UP ? ho / 2 - lo : ho * p.stride - p.pad;
  const int wb = UP ? wo / 2 - lo : wo * p.stride - p.pad;
  float acc = 0.f;
  for (int a = 0; a < td.n; ++a) {
    const int di = db + td.off[a];
    if (di < 0 || di >= p.d_in) continue;
    for (int c = 0; c < th.n; ++c) {
      const int hi = hb + th.off[c];
      if (hi < 0 || hi >= p.h_in) continue;
      for (int t = 0; t < tw.n; ++t) {
        const int wi = wb + tw.off[t];
        if (wi < 0 || wi >= p.w_in) continue;
        const float* xp =
            x + (((static_cast<size_t>(b) * p.d_in + di) * p.h_in + hi) * p.w_in + wi) * p.cin;
        const float* wp =
            w + static_cast<size_t>((td.k[a] * p.ks + th.k[c]) * p.ks + tw.k[t]) * p.cin * p.cout +
            co;
        for (int ci = 0; ci < p.cin; ++ci) acc = fmaf(xp[ci], wp[static_cast<size_t>(ci) * p.cout], acc);
      }
    }
  }
  if (p.bias) acc += p.bias[co];
  if (p.res) acc += static_cast<const float*>(p.res)[e];
  acc = activate(acc, p.act);
  if (p.post_mul) {
    acc *= static_cast<const float*>(
        p.post_mul)[((static_cast<size_t>(b) * p.h_out + ho) * p.w_out + wo) * p.cout + co];
  }
  static_cast<float*>(p.out)[e] = acc;
}

// The dynamic shared-memory attribute, set once an instantiation.
template <int BN, int CK>
cudaError_t prepare_bf16() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(igemm_bf16<BN, CK>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(Cfg<BN, CK>::bytes()));
  done = e == cudaSuccess;
  return e;
}

template <int BN, int CK>
int launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int BH = Cfg<BN, CK>::BH;
  if (cudaError_t e = prepare_bf16<BN, CK>()) return static_cast<int>(e);
  const int ntn = ceil_div(p.cout, BN);
  const dim3 grid(ceil_div(p.w_out, BM) * ntn, ceil_div(p.h_out, BH), p.b * p.d_out);
  igemm_bf16<BN, CK><<<grid, kThreads, Cfg<BN, CK>::bytes(), stream>>>(p);
  return end();
}

// Input channels a stage: 32, or 16 where C_in is not a multiple of 32 (the
// last chunk zero-filled past C_in).
template <int BN>
int launch_bf16(const Params& p, cudaStream_t stream) {
  return p.cin % 32 == 0 ? launch_bf16<BN, 32>(p, stream) : launch_bf16<BN, 16>(p, stream);
}

// The float32 FMA form of the conv (UP false, any stride) or the transposed conv.
template <bool UP>
int launch_f32(const Params& p, cudaStream_t stream) {
  const long long total = static_cast<long long>(p.b) * p.d_out * p.h_out * p.w_out * p.cout;
  constexpr int threads = 256;
  direct_f32<UP><<<ceil_div(total, threads), threads, 0, stream>>>(p);
  return end();
}

// The bf16 1×1×1 conv (C_out a multiple of 8) on the tensor cores.
inline int launch_k1(const Params& p, cudaStream_t stream) {
  if (p.ks != 1 || p.stride != 1 || p.cout % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p.cout <= 16) return launch_bf16<16>(p, stream);
  if (p.cout <= 32) return launch_bf16<32>(p, stream);
  if (p.cout <= 64) return launch_bf16<64>(p, stream);
  return launch_bf16<128>(p, stream);
}

}  // namespace igemm
}  // namespace dv
