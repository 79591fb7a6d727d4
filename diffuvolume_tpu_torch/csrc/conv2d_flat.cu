// 3×3 dilated 2-D convolution with a fused epilogue on channels-last (NHWC)
// tensors:
//   out (B, H, W, Co) = act(conv(x (B, H, W, Ci), w (3, 3, Ci, Co); pad d, dilation d)
//                           + bias (+ res))
// with w in (kh, kw, Ci, Co) order, bias (Co,) float32 or null, res
// (B, H, W, Co) in the input's dtype or null, act one of conv_igemm.cuh's
// Act; a float32 accumulator and epilogue, one rounding to the input's
// dtype.
//   Replaces diffuvolume_tpu/ops/pallas/conv2d.py:54 conv2d_flat: every 3×3
//   conv of PCWNet's full-resolution refinement net (models/pcw.py
//   _refine_flat of the JAX package): 146 (in a 160 slot) → 128 … 32 → 1
//   channels at dilations 1 to 16, 11 a refinement, with the BatchNorm
//   folded into the weights and the Mish and the blocks' residual adds in
//   the epilogue.
//   Plain version: ops/kernels/conv2d.py conv2d_flat_plain.
//
// What bounds it on the H100: bf16 tensor-core operations for conv1 … conv6
// at 384×1248.  The 128→128 conv does 70.7 G multiply-adds (0.143 ms at 989
// TFLOP/s) and moves 245 MB (0.073 ms at 3.35 TB/s); conv1 (146 real input
// channels) 0.163 ms; one refinement's 11 convs 0.925 ms.
//
// Design: the one-plane member of conv_hopper.cuh's stride-1 kernel
// (conv_s1 with one kd tap, its (kh, kw) taps d apart).  A ring of 3
// cp.async stages overlaps each block's copies with its products.  At d 1
// and 2 a stage is (chunk of 16 input channels) with the bh + 2d input rows
// × bmw + 2d columns all nine taps read and their weights; at d 4 … 64 the
// rows a block reaches outgrow a small tile, so a stage is one kh tap (bh
// rows at offset (kh − 1)·d, bmw + 2d columns, the three kw taps' weights),
// and a tap whose rows all fall in the padding is skipped.  The host plans
// each shape once (dv_conv2d_flat_plan: the tile, the stage form from d,
// the tensor-core form) and hands the plan to every launch, with the
// shared-memory attribute set once an instantiation.  wgmma at 64 and 128
// output channels a tile (conv1 … conv4 at 128; conv5's 96 as a 128 tile, a
// quarter of it zero weights, or on mma.sync as three 32-channel tiles);
// mma.sync at 16 and 32.  C_in must be a multiple of 8 (16-byte rows; PCW's
// 146-channel input lives in a zero-filled 160-channel slot); a last chunk
// past C_in is zero-filled in shared memory.  C_out not a multiple of 8
// (conv8's single channel) runs on zero weight columns and stores only the
// real channels; a tile's positions past the W and H edges are masked like
// the padding.  The float32 form is a plain FMA kernel (no TF32) used
// where the agreement with the CPU is checked.
#include <cstring>

#include "conv_hopper.cuh"

namespace dv {
namespace conv2d {

struct Params {
  const void* x;
  const void* w;       // (3, 3, C_in, C_out)
  const float* bias;   // (C_out,) or null
  const void* res;     // (B, H, W, C_out) or null
  void* out;
  int b, h, wd, cin, cout, dil, act;
};

// The stride-1 kernel's parameters for one plane: D 1, padding d.
inline igemm::Params plane_params(const Params& q) {
  igemm::Params p;
  p.x = q.x; p.w = q.w; p.bias = q.bias; p.res = q.res; p.post_mul = nullptr; p.out = q.out;
  p.b = q.b; p.d_in = 1; p.h_in = q.h; p.w_in = q.wd; p.cin = q.cin;
  p.d_out = 1; p.h_out = q.h; p.w_out = q.wd; p.cout = q.cout;
  p.ks = 3; p.stride = 1; p.pad = q.dil; p.act = q.act;
  return p;
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
  if (p.res) acc += static_cast<const float*>(p.res)[e];
  static_cast<float*>(p.out)[e] = igemm::activate(acc, p.act);
}

}  // namespace conv2d
}  // namespace dv

// bf16 launches on `plan` (int[kPlanInts] from dv_conv2d_flat_plan for this
// shape, dilation and device); float32 takes none (null).  res may be null;
// act: igemm::Act.
DV_EXPORT int dv_conv2d_flat(const void* x, const void* w, const void* bias, const void* res,
                             void* out, const int* plan, int b, int h, int wd, int cin, int cout,
                             int dil, int act, int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  dv::conv2d::Params q;
  q.x = x; q.w = w; q.bias = static_cast<const float*>(bias); q.res = res; q.out = out;
  q.b = b; q.h = h; q.wd = wd; q.cin = cin; q.cout = cout; q.dil = dil; q.act = act;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != dv::kBF16) {
    const long long total = static_cast<long long>(b) * h * wd * cout;
    constexpr int threads = 256;
    dv::conv2d::conv2d_f32<<<dv::ceil_div(total, threads), threads, 0, s>>>(q);
    return dv::end();
  }
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dv::hopper::Plan pl;
  std::memcpy(&pl, plan, sizeof pl);
  return static_cast<int>(
      dv::hopper::s1_run<true>(dv::conv2d::plane_params(q), pl, dil, nullptr, s));
}

// The bf16 conv's plan for a shape and dilation, into plan[kPlanInts]
// (hopper::Plan's fields in order); tc: hopper::TensorCores.
DV_EXPORT int dv_conv2d_flat_plan(int b, int h, int wd, int cin, int cout, int dil, int tc,
                                  int device, int* plan) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  dv::conv2d::Params q{};
  q.b = b; q.h = h; q.wd = wd; q.cin = cin; q.cout = cout; q.dil = dil;
  dv::hopper::Plan pl;
  if (cudaError_t e = dv::hopper::s1_plan<true>(dv::conv2d::plane_params(q), dil, device, tc, pl)) {
    return static_cast<int>(e);
  }
  std::memcpy(plan, &pl, sizeof pl);
  return 0;
}
