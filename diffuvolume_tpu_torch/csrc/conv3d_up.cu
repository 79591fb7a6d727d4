// ConvTranspose3d s2 p1 with eval BatchNorm folded into its weights, on
// channels-last volumes, k3 (output padding 1) or k4 (output padding 0):
//   out (B, 2D, 2H, 2W, Co) = act(deconv(x (B, D, H, W, Ci), w) + bias (+ res)) (× post_mul)
// with w (k, k, k, Ci, Co) in the transposed conv's own tap order
// (out[2i - 1 + k] += x[i]·w[k]; PyTorch's (Ci, Co, k, k, k) weight
// permuted, not flipped), act none, ReLU, Mish or LeakyReLU (conv_igemm.cuh
// Act).  The ACV/PCW hourglasses add their redir branch as the residual
// before the activation: conv5 = act(deconv(c4) + redir2(c2)); IGEV's GEV
// hourglass runs k4 with LeakyReLU.
//   Replaces diffuvolume_tpu/ops/pallas/conv3d.py:conv3d_fold_up (both
//   forms; the kernel size is the weight's).
//   Plain version: ops/kernels/conv3d_up.py conv3d_up_plain.
//
// What bounds it on the H100: bf16 tensor-core operations or bytes.  k3:
// each output takes 1 or 2 taps per axis, 3.375 on average, so the 64→32
// deconv to (48, 128, 240) does 20.4 G multiply-adds (41 µs at 989
// TFLOP/s) and moves 113 MB (34 µs at 3.35 TB/s).  k4: 8 taps an output;
// IGEV's 16→8 to (48, 96, 312) does 1.5 G multiply-adds on 21 MB (bytes).
//
// Design: see conv_igemm.cuh.  The gather form splits the output by parity
// on each axis; a block holds one parity per axis, so its taps are fixed and
// the input positions it reads are dense, and no multiply by an inserted
// zero is ever made.  The TPU kernel's interleave of four parity sub-tiles
// through lane concats becomes a stride-2 store along W.
#include "conv_igemm.cuh"

DV_EXPORT int dv_conv3d_up(const void* x, const void* w, const void* bias, const void* res,
                           const void* post_mul, void* out, int b, int d, int h, int wd, int cin,
                           int cout, int ks, int act, int dtype, int device, void* stream) {
  if (ks != 3 && ks != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  dv::igemm::Params p;
  p.x = x; p.w = w; p.bias = static_cast<const float*>(bias); p.res = res;
  p.post_mul = post_mul; p.out = out;
  p.b = b; p.d_in = d; p.h_in = h; p.w_in = wd; p.cin = cin; p.cout = cout;
  p.ks = ks; p.stride = 2; p.pad = 1; p.act = act;
  p.d_out = 2 * d; p.h_out = 2 * h; p.w_out = 2 * wd;
  return dv::igemm::launch<true>(p, dtype, static_cast<cudaStream_t>(stream));
}
