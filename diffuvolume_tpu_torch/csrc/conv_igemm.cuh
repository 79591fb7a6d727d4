// The float32 FMA form of every 3-D conv (direct_f32: stride 1 and 2 and the
// transposed convs, csrc/conv3d_fold.cu and csrc/conv3d_up.cu), and what the
// bf16 kernels share: Params, the epilogue's activation, and the copy /
// ldmatrix / mma.sync helpers.  The bf16 convs are csrc/conv_hopper.cuh's
// (3×3×3 stride 1, stride 2, transposed) and csrc/conv_k1.cuh's (1×1×1,
// row 9).
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

// 16-byte global → shared copy that bypasses registers; a false `valid`
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

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

// The float32 FMA form of the conv (UP false, any stride) or the transposed conv.
template <bool UP>
int launch_f32(const Params& p, cudaStream_t stream) {
  const long long total = static_cast<long long>(p.b) * p.d_out * p.h_out * p.w_out * p.cout;
  constexpr int threads = 256;
  direct_f32<UP><<<ceil_div(total, threads), threads, 0, stream>>>(p);
  return end();
}

}  // namespace igemm
}  // namespace dv
