// 3-D convolution with eval BatchNorm folded into its weights and a fused
// epilogue, on channels-last volumes:
//   out (B, Do, Ho, Wo, Co) = act(conv(x (B, D, H, W, Ci), w) + bias (+ res)) (× post_mul)
// with w (k, k, k, Ci, Co), k 3 (pad 1) or 1 (pad 0), stride 1 or 2, act
// none, ReLU, Mish or LeakyReLU (conv_igemm.cuh Act), post_mul a
// (B, Ho, Wo, Co) map broadcast over D (IGEV's feature attention).
//   Replaces diffuvolume_tpu/ops/pallas/conv3d.py:
//     conv3d_fold_p   (3×3×3 s1, + residual; C_out 1 for the classifier heads),
//     conv3d_fold_x2  (the same conv at C_in 64, or 40 zero-filled to 48),
//     conv3d_fold_s2  (3×3×3 stride 2, C_out = 2·C_in),
//     conv1x1_fold_p  (1×1×1, the hourglass redir branches),
//     conv3d_fold     (3×3×3 s1 at C_in 8 or 16: IGEV's module path; the 8-
//                      channel chunk zero-filled in shared memory).
//   Plain version: ops/kernels/conv3d_fold.py conv3d_fold_plain.
//
// What bounds it on the H100: bf16 tensor-core operations.  At the main path
// the 32→32 conv at (48, 128, 240) does 40.8 G multiply-adds (82 µs at 989
// TFLOP/s) and moves 189 MB (56 µs at 3.35 TB/s); the 128→128 conv at
// (12, 32, 60) does 10.2 G multiply-adds on 12 MB.
//
// Design: see conv_igemm.cuh.  The TPU kernels pack D-phases into 128 lanes,
// carry halo rows and fold the taps into banded weights; none of that is
// needed here: activations are plain NDHWC bf16, the conv is an implicit GEMM
// on the tensor cores with W-strips staged per kd plane, and the folded BN
// bias, the residual and the activation ride the epilogue.  Weights stream by
// kd plane and input-channel chunk (884 KB at 128→128 do not fit a block's
// shared memory).  The PCW path's 1/32 level (6, 12, 39) has an odd W and
// fewer rows than a block: the edges are masked, as at any other W.  C_out below 16 (the heads) pads N with zero weights in
// shared memory and stores only the real channels.  Inside a block the
// copies do not overlap the products (two blocks an SM overlap each other);
// TMA and wgmma are not used yet.
#include "conv_igemm.cuh"

DV_EXPORT int dv_conv3d_fold(const void* x, const void* w, const void* bias, const void* res,
                             const void* post_mul, void* out, int b, int d, int h, int wd,
                             int cin, int cout, int ks, int stride, int act, int dtype, int device,
                             void* stream) {
  if (cudaError_t e = dv::begin(device)) return static_cast<int>(e);
  dv::igemm::Params p;
  p.x = x; p.w = w; p.bias = static_cast<const float*>(bias); p.res = res;
  p.post_mul = post_mul; p.out = out;
  p.b = b; p.d_in = d; p.h_in = h; p.w_in = wd; p.cin = cin; p.cout = cout;
  p.ks = ks; p.stride = stride; p.pad = (ks - 1) / 2; p.act = act;
  p.d_out = (d + 2 * p.pad - ks) / stride + 1;
  p.h_out = (h + 2 * p.pad - ks) / stride + 1;
  p.w_out = (wd + 2 * p.pad - ks) / stride + 1;
  return dv::igemm::launch<false>(p, dtype, static_cast<cudaStream_t>(stream));
}
