"""Fused upsample → softmax → soft-argmin + uncertainty head.

Kernel: ``csrc/fused_head.cu`` (replaces
``diffuvolume_tpu/ops/pallas/fused_head.py:fused_upsample_softargmin``).
Plain version: ``fused_upsample_softargmin_plain``, which materialises the
``(B, D, H, W)`` probability volume through ``ops/regression.py``.
"""

from __future__ import annotations

import torch

from diffuvolume_tpu_torch.ops.kernels import _build
from diffuvolume_tpu_torch.ops.regression import (
    disparity_uncertainty,
    upsample_cost_and_regress,
)


def fused_upsample_softargmin_plain(
    cost: torch.Tensor,
    max_disp: int,
    out_hw: tuple[int, int],
    align_corners: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(disp, unc)`` via the full probability volume (f32)."""
    disp, prob = upsample_cost_and_regress(
        cost.float(), max_disp, out_hw, align_corners
    )
    return disp, disparity_uncertainty(prob, disp, max_disp)


def fused_upsample_softargmin(
    cost: torch.Tensor,
    max_disp: int,
    out_hw: tuple[int, int],
    align_corners: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Trilinear upsample of ``(B, D4, H4, W4)`` logits to ``(B, max_disp, H,
    W)``, softmax over disparity, expected disparity and uncertainty
    ``Σ|d - d̂|·p``.  Returns ``(disp, unc)``, both ``(B, H, W)`` float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if cost.device.type == "cpu":
        return fused_upsample_softargmin_plain(cost, max_disp, out_hw, align_corners)
    if cost.dim() != 4:
        raise ValueError(f"cost must be (B, D4, H4, W4), got {tuple(cost.shape)}")
    _build.check_cuda(cost)
    b, d4, h4, w4 = cost.shape
    h, w = out_hw
    disp = torch.empty((b, h, w), dtype=torch.float32, device=cost.device)
    unc = torch.empty_like(disp)
    _build.launch(
        "dv_fused_head", cost, cost.data_ptr(), disp.data_ptr(), unc.data_ptr(),
        b, d4, h4, w4, max_disp, h, w, int(align_corners),
    )
    fused_upsample_softargmin.launches += 1
    return disp, unc


fused_upsample_softargmin.launches = 0
