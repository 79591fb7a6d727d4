// ConvTranspose3d s2 p1 with eval BatchNorm folded into its weights, on
// channels-last volumes, k3 (output padding 1) or k4 (output padding 0):
//   out (B, 2D, 2H, 2W, Co) = act(deconv(x (B, D, H, W, Ci), w) + bias (+ res)) (× post_mul)
// with w (k, k, k, Ci, Co) in the transposed conv's own tap order
// (out[2i - 1 + k] += x[i]·w[k]; PyTorch's (Ci, Co, k, k, k) weight
// permuted, not flipped), act none, ReLU, Mish or LeakyReLU (conv_igemm.cuh
// Act).  The ACV/PCW hourglasses add their redir branch as the residual
// before the activation: conv5 = act(deconv(c4) + redir2(c2)); IGEV's GEV
// hourglass runs k4 with LeakyReLU.
//   Replaces diffuvolume_tpu/ops/pallas/conv3d.py:1641 conv3d_fold_up (both
//   forms; the kernel size is the weight's).
//   Plain version: ops/kernels/conv3d_up.py conv3d_up_plain.
//
// What bounds it on the H100: bytes at the ACV shapes.  k3 with the
// residual: 128→64 (12, 32, 60) → (24, 64, 120) reads 3 MB and 24 MB of
// residual and writes 24 MB, 16.0 µs at 3.35 TB/s (3.4 G multiply-adds,
// 6.9 µs at 989 TFLOP/s); 64→32 → (48, 128, 240) reads 24 MB and 94 MB of
// residual and writes 94 MB, 63.4 µs (20.4 G multiply-adds, 41 µs).  k4: 8
// taps an output; IGEV's 16→8 to (48, 96, 312) does 1.5 G multiply-adds on
// 21 MB (bytes).
//
// Design: see conv_hopper.cuh.  Gather form, no multiply by an inserted
// zero: a block computes one H parity and both W parities of its tile of
// half-resolution positions from one staged input strip a (kd, kh) tap (the
// TPU kernel's interleave of four parity sub-tiles through lane concats
// becomes the epilogue's row order), a ring of 3 cp.async stages of (kd,
// kh, 16 or 32 input channels) overlaps the copies, and the epilogue moves
// the residual and the output as whole rows, both W parities together;
// wgmma at 64 output channels a tile, mma.sync below.  The plan is made
// once a shape (dv_conv3d_up_plan) and handed to every launch.  The
// float32 form is conv_igemm.cuh's FMA kernel.
#include <cstring>

#include "conv_hopper.cuh"

namespace {

dv::igemm::Params up_params(const void* x, const void* w, const void* bias, const void* res,
                            const void* post_mul, void* out, int b, int d, int h, int wd,
                            int cin, int cout, int ks, int act) {
  dv::igemm::Params p;
  p.x = x; p.w = w; p.bias = static_cast<const float*>(bias); p.res = res;
  p.post_mul = post_mul; p.out = out;
  p.b = b; p.d_in = d; p.h_in = h; p.w_in = wd; p.cin = cin; p.cout = cout;
  p.ks = ks; p.stride = 2; p.pad = 1; p.act = act;
  p.d_out = 2 * d; p.h_out = 2 * h; p.w_out = 2 * wd;
  return p;
}

}  // namespace

// bf16 launches on `plan` (int[kPlanInts] from dv_conv3d_up_plan for this
// shape, kernel size and device; null for float32).
DV_EXPORT int dv_conv3d_up(const void* x, const void* w, const void* bias, const void* res,
                           const void* post_mul, void* out, const int* plan, int b, int d, int h,
                           int wd, int cin, int cout, int ks, int act, int dtype, int device,
                           void* stream) {
  if (ks != 3 && ks != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  const dv::igemm::Params p =
      up_params(x, w, bias, res, post_mul, out, b, d, h, wd, cin, cout, ks, act);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != dv::kBF16) return dv::igemm::launch_f32<true>(p, s);
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dv::hopper::Plan pl;
  std::memcpy(&pl, plan, sizeof pl);
  return static_cast<int>(ks == 4 ? dv::hopper::run<true, 4>(p, pl, nullptr, s)
                                  : dv::hopper::run<true, 3>(p, pl, nullptr, s));
}

// The bf16 transposed conv's plan for a shape, into plan[kPlanInts] (as
// dv_conv3d_s2_plan).
DV_EXPORT int dv_conv3d_up_plan(int b, int d, int h, int wd, int cin, int cout, int ks, int tc,
                                int device, int* plan) {
  if (ks != 3 && ks != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  const dv::igemm::Params p = up_params(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, b,
                                        d, h, wd, cin, cout, ks, 0);
  dv::hopper::Plan pl;
  const cudaError_t e = ks == 4 ? dv::hopper::plan<true, 4>(p, device, tc, pl)
                                : dv::hopper::plan<true, 3>(p, device, tc, pl);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::memcpy(plan, &pl, sizeof pl);
  return 0;
}
