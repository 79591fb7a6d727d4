// 3-D convolution with eval BatchNorm folded into its weights and a fused
// epilogue, on channels-last volumes:
//   out (B, Do, Ho, Wo, Co) = act(conv(x (B, D, H, W, Ci), w) + bias (+ res)) (× post_mul)
// with w (k, k, k, Ci, Co), k 3 (pad 1) or 1 (pad 0), stride 1 or 2, act
// none, ReLU, Mish or LeakyReLU (conv_igemm.cuh Act), post_mul a
// (B, Ho, Wo, Co) map broadcast over D (IGEV's feature attention).
//   Replaces diffuvolume_tpu/ops/pallas/conv3d.py:
//     conv3d_fold_p   (conv3d.py:508; 3×3×3 s1, + residual, × post_mul;
//                      C_out 1 for the classifier heads),
//     conv3d_fold_x2  (conv3d.py:1307; the same conv at C_in 64, or 40
//                      zero-filled to 48),
//     conv1x1_fold_p  (conv3d.py:1879; 1×1×1, the hourglass redir branches),
//     conv3d_fold     (conv3d.py:301; 3×3×3 s1 at C_in 8 or 16: IGEV's module
//                      path; the 8-channel chunk zero-filled in shared memory),
//     conv3d_packed   (conv3d.py:131; 3×3×3 s1 + bias at C_in 8 … 128: the
//                      routed module paths),
//   all through dv_conv3d_fold, and
//     conv3d_fold_s2  (conv3d.py:1439; 3×3×3 stride 2, C_out = 2·C_in; IGEV
//                      16→16, 16→32, 32→48) through dv_conv3d_s2.
//   Plain version: ops/kernels/conv3d_fold.py conv3d_fold_plain.
//
// Stride 1, 3×3×3 (rows 5, 6, 14, 15).  What bounds it on the H100: bf16
// tensor-core operations.  At the main path the 32→32 conv at (48, 128,
// 240) does 40.8 G multiply-adds (82 µs at 989 TFLOP/s) and moves 189 MB
// (56 µs at 3.35 TB/s); the 64→32 wide entry 165 µs, the 128→128 conv at
// (12, 32, 60) 10.2 G multiply-adds on 12 MB (21 µs); PCW's 128→128 at
// (6, 12, 39) 2.5 µs.  Design: conv_hopper.cuh's conv_s1 — a ring of 3
// cp.async stages of (kd plane, 16 input channels), each the plane's bh + 2
// input rows × bmw + 2 columns that all nine (kh, kw) taps read, copied once
// a plane, with the nine taps' weights, so a block overlaps its own copies
// with its products; a tile of bh × bmw outputs planned per shape so a
// narrow W (39, 60, 78) fills it with whole rows; where the grid is small
// (PCW 1/16 and 1/32, ACV's quarter) a model of the card picks the half-size
// tile or K split over (kd, chunk) stages, with a float32 reduction that
// runs the epilogue (residual, post_mul) and rounds once; wgmma at 64 and
// 128 output channels a tile, mma.sync at 16 and 32.  The plan is made once
// a shape (dv_conv3d_s1_plan) and handed to every launch.  The TPU kernels
// pack D-phases into 128 lanes, carry halo rows and fold the taps into
// banded weights; none of that is needed here: activations are plain NDHWC
// bf16 and the folded BN bias, the residual, the activation and post_mul
// ride the epilogue.  C_in 8 runs on a zero-filled half chunk, C_out below
// 8 (the heads) on zero weight columns with element stores.
//
// 1×1×1 (row 9).  What bounds it on the H100: bytes (ACV's 32→32 at (48,
// 128, 240) moves 189 MB, 56 µs at 3.35 TB/s, for 5 µs of bf16 tensor-core
// work).  Design: conv_k1.cuh's conv_k1 — the positions as one flat GEMM
// dimension, tiles of 128 or 256 contiguous positions × every input channel
// copied by 16-byte cp.async into a ring of 2–3 stages (the x tile
// swizzled for conflict-free ldmatrix reads), the residual's tile in the
// same stage, persistent blocks walking their tiles, the weights staged
// once a block, and 16-byte coalesced stores from a staging buffer while
// the next tiles' copies are in flight.
//
// Stride 2 (row 7).  What bounds it on the H100, at the ACV shapes: bytes
// for 32→64 (48, 128, 240) → (24, 64, 120), 94 MB in and 24 MB out, 35.2 µs
// at 3.35 TB/s (10.2 G multiply-adds, 20.6 µs); operations for 64→128 →
// (12, 32, 60), 5.1 G multiply-adds, 10.3 µs at 989 TFLOP/s.  Design: see
// conv_hopper.cuh — a ring of 3 cp.async stages of (kd, kh, 32 input
// channels) so a block overlaps its own copies, parity-major strips that
// ldmatrix reads without bank conflicts, tiles chosen per shape so narrow W
// fills them (W 39, 78, 156), a half-size tile and split-K over the stages
// where the output is too small for two waves on 132 SMs; wgmma at 64
// output channels a tile, mma.sync below.  The plan is made once a shape
// (dv_conv3d_s2_plan) and handed to every launch.
#include <cstring>

#include "conv_hopper.cuh"
#include "conv_k1.cuh"

namespace {

dv::igemm::Params fold_params(const void* x, const void* w, const void* bias, const void* res,
                              const void* post_mul, void* out, int b, int d, int h, int wd,
                              int cin, int cout, int ks, int stride, int act) {
  dv::igemm::Params p;
  p.x = x; p.w = w; p.bias = static_cast<const float*>(bias); p.res = res;
  p.post_mul = post_mul; p.out = out;
  p.b = b; p.d_in = d; p.h_in = h; p.w_in = wd; p.cin = cin; p.cout = cout;
  p.ks = ks; p.stride = stride; p.pad = (ks - 1) / 2; p.act = act;
  p.d_out = (d + 2 * p.pad - ks) / stride + 1;
  p.h_out = (h + 2 * p.pad - ks) / stride + 1;
  p.w_out = (wd + 2 * p.pad - ks) / stride + 1;
  return p;
}

}  // namespace

// Stride 1, k 3 or 1.  bf16 k 3 launches on `plan` (int[kPlanInts] from
// dv_conv3d_s1_plan for this shape and device); `ws` is float32 scratch of
// splits × outputs, or null where the plan has one split.  k 1 and float32
// take no plan (null).
DV_EXPORT int dv_conv3d_fold(const void* x, const void* w, const void* bias, const void* res,
                             const void* post_mul, void* out, void* ws, const int* plan, int b,
                             int d, int h, int wd, int cin, int cout, int ks, int act, int dtype,
                             int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  const dv::igemm::Params p =
      fold_params(x, w, bias, res, post_mul, out, b, d, h, wd, cin, cout, ks, 1, act);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != dv::kBF16) return dv::igemm::launch_f32<false>(p, s);
  if (ks == 1) {
    dv::k1::Plan pl;
    return static_cast<int>(dv::k1::k1(true, p, device, pl, s));
  }
  if (ks != 3 || plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dv::hopper::Plan pl;
  std::memcpy(&pl, plan, sizeof pl);
  return static_cast<int>(dv::hopper::s1_run<false>(p, pl, 1, static_cast<float*>(ws), s));
}

// The bf16 1×1×1 conv's plan for a shape (with a residual or not), into
// plan[k1::kPlanInts] (k1::Plan's fields in order).
DV_EXPORT int dv_conv1x1_plan(int b, int d, int h, int wd, int cin, int cout, int residual,
                              int device, int* plan) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  static const char dummy = 0;
  const dv::igemm::Params p = fold_params(nullptr, nullptr, nullptr, residual ? &dummy : nullptr,
                                          nullptr, nullptr, b, d, h, wd, cin, cout, 1, 1, 0);
  dv::k1::Plan pl;
  if (cudaError_t e = dv::k1::k1(false, p, device, pl, nullptr)) return static_cast<int>(e);
  std::memcpy(plan, &pl, sizeof pl);
  return 0;
}

// The bf16 stride-1 3×3×3 conv's plan for a shape, into plan[kPlanInts]
// (hopper::Plan's fields in order); tc: hopper::TensorCores.
DV_EXPORT int dv_conv3d_s1_plan(int b, int d, int h, int wd, int cin, int cout, int tc,
                                int device, int* plan) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  const dv::igemm::Params p =
      fold_params(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, b, d, h, wd, cin, cout,
                  3, 1, 0);
  dv::hopper::Plan pl;
  if (cudaError_t e = dv::hopper::s1_plan<false>(p, 1, device, tc, pl)) return static_cast<int>(e);
  std::memcpy(plan, &pl, sizeof pl);
  return 0;
}

// 3×3×3 stride 2.  bf16 launches on `plan` (int[kPlanInts] from
// dv_conv3d_s2_plan for this shape and device; null for float32); `ws` is
// float32 scratch of splits × outputs, or null where the plan has one split.
DV_EXPORT int dv_conv3d_s2(const void* x, const void* w, const void* bias, void* out, void* ws,
                           const int* plan, int b, int d, int h, int wd, int cin, int cout,
                           int act, int dtype, int device, void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  const dv::igemm::Params p =
      fold_params(x, w, bias, nullptr, nullptr, out, b, d, h, wd, cin, cout, 3, 2, act);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != dv::kBF16) return dv::igemm::launch_f32<false>(p, s);
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dv::hopper::Plan pl;
  std::memcpy(&pl, plan, sizeof pl);
  return static_cast<int>(dv::hopper::run<false, 3>(p, pl, static_cast<float*>(ws), s));
}

// The bf16 stride-2 conv's plan for a shape, into plan[kPlanInts]
// (hopper::Plan's fields in order); tc: hopper::TensorCores.
DV_EXPORT int dv_conv3d_s2_plan(int b, int d, int h, int wd, int cin, int cout, int tc,
                                int device, int* plan) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  const dv::igemm::Params p =
      fold_params(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, b, d, h, wd, cin, cout,
                  3, 2, 0);
  dv::hopper::Plan pl;
  if (cudaError_t e = dv::hopper::plan<false, 3>(p, device, tc, pl)) return static_cast<int>(e);
  std::memcpy(plan, &pl, sizeof pl);
  return 0;
}
