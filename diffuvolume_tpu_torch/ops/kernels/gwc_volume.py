"""Group-wise correlation volume.

Kernel: ``csrc/gwc_volume.cu`` (replaces
``diffuvolume_tpu/ops/pallas/gwc_volume.py:gwc_volume_pallas``).
Plain version: ``ops/cost_volume.py:build_gwc_volume``.
"""

from __future__ import annotations

import torch

from diffuvolume_tpu_torch.ops.cost_volume import build_gwc_volume
from diffuvolume_tpu_torch.ops.kernels import _build


def gwc_volume(
    left: torch.Tensor, right: torch.Tensor, max_disp: int, num_groups: int
) -> torch.Tensor:
    """``(B, C, H, W)`` features → ``(B, G, D, H, W)`` volume,
    ``vol[b,g,d,h,w] = mean_{c∈g} left[b,c,h,w]·right[b,c,h,w-d]`` (0 for
    ``w < d``), accumulated in float32, in the features' dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if left.device.type == "cpu":
        return build_gwc_volume(left, right, max_disp, num_groups)
    if left.shape != right.shape or left.dtype != right.dtype or left.dim() != 4:
        raise ValueError("left/right must be (B, C, H, W) of one shape and dtype")
    b, c, h, w = left.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    _build.check_cuda(left, right)
    out = torch.empty((b, num_groups, max_disp, h, w), dtype=left.dtype,
                      device=left.device)
    _build.launch(
        "dv_gwc_volume", left, left.data_ptr(), right.data_ptr(), out.data_ptr(),
        b, c, h, w, num_groups, max_disp,
    )
    gwc_volume.launches += 1
    return out


gwc_volume.launches = 0
