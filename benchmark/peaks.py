"""The card's published peaks and the kernel-name groups, frozen.

Copied from ``diffuvolume_tpu_torch/tools/profiling.py`` (``PEAKS``,
``GROUPS``, ``group_of``) at commit 0c541214e7bc0f7b596b9f45a2d9eed18cdd0d1b,
so that a change to the program cannot move the yardstick.  A kernel name
that matches no group is ``other``, so that a renamed kernel shows.
"""

from __future__ import annotations

import re

# device name (as torch.cuda.get_device_name gives it) → NVIDIA's H100 data
# sheet, SXM5 part, dense rates without sparsity, at the full 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "card": "NVIDIA H100 SXM5 80GB", "power_limit_w": 700.0,
        "flops": {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12,
                  "float64": 34e12},
        "hbm_bytes_per_s": 3.35e12,
    },
}

# Kernel name → group, first match wins (BatchNorm before cuDNN: cuDNN's
# own BatchNorm kernels carry its name).
GROUPS = [
    ("port: fused head", r"head_kernel<[^>]*false>"),
    ("port: uncertainty at query", r"head_kernel<[^>]*true>"),
    ("port: gwc volume", r"gwc_ncdhw_kernel"),
    ("port: gwc volume in the slot", r"gwc_slot_kernel"),
    ("port: patch stencils", r"depthwise_hw_kernel"),
    ("port: concat volume", r"concat_kernel|concat_cl_kernel"),
    ("port: dhw multiply", r"dhw_mul_kernel|dhw_mul_cl"),
    ("port: 3-D conv, folded (conv3d_fold.cu)",
     r"conv_k1<|direct_f32<false|conv_bf16<false|splitk_finish"
     r"|conv_s1(_head)?<[^>]*false>"),
    ("port: transposed conv, folded (conv3d_up.cu)", r"direct_f32<true|conv_bf16<true"),
    ("port: dilated 2-D conv (conv2d_flat.cu)", r"conv2d_f32|conv_s1(_head)?<[^>]*true>"),
    ("port: layout pack / unpack", r"transpose_vec_kernel|transpose_tile_kernel|hwdc"),
    ("batch norm", r"batch_norm|bn_fw|bn_bw"),
    ("collectives (NCCL)", r"nccl"),
    ("conv / deconv (cuDNN, CUTLASS)", r"conv|cudnn|xmma|implicit|wgrad|dgrad|fprop|winograd|sm90_"),
    ("matmul (attention, resizes)", r"gemm|cublas|cutlass"),
    ("grid sample (PCW refinement warp)", r"grid_sampler"),
    ("instance norm (IGEV trunk)", r"instance_norm|welford"),
    ("softmax", r"softmax"),
    ("optimizer (Adam, clip)", r"multi_tensor|adam|foreach"),
    ("copies / layout", r"copy|transpose|permute|cat|pad|Memcpy|Memset"),
    ("elementwise / reduce", r"elementwise|reduce|vectorized|unrolled"),
]

_COMPILED = [(g, re.compile(p, re.IGNORECASE)) for g, p in GROUPS]


def group_of(name: str) -> str:
    for group, pattern in _COMPILED:
        if pattern.search(name):
            return group
    return "other"
