"""Fused upsample → softmax → soft-argmin + uncertainty heads.

Kernels: ``csrc/fused_head.cu``.  ``fused_upsample_softargmin`` replaces
``diffuvolume_tpu/ops/pallas/fused_head.py:fused_upsample_softargmin``;
``fused_uncertainty_at`` replaces ``fused_uncertainty_at`` of the same file
(the uncertainty against a given disparity, PCW's renewal score).  Plain
versions: ``fused_upsample_softargmin_plain`` and
``fused_uncertainty_at_plain``, which materialise the ``(B, D, H, W)``
probability volume through ``ops/regression.py``.  The kernels split a
pixel's bins over four threads of up to 96 bins each: ``max_disp`` up to
``MAX_BINS`` on the card.
"""

from __future__ import annotations

import torch

from diffuvolume_tpu_torch.ops.kernels import _build
from diffuvolume_tpu_torch.ops.regression import (
    disparity_uncertainty,
    upsample_cost_and_regress,
)

# The most disparity bins the kernels take (csrc/fused_head.cu: 4 threads × 96).
MAX_BINS = 384


def _check_bins(max_disp: int) -> None:
    if not 1 <= max_disp <= MAX_BINS:
        raise ValueError(f"max_disp must be in [1, {MAX_BINS}] on the card, got {max_disp}")


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
    _check_bins(max_disp)
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


def fused_uncertainty_at_plain(
    cost: torch.Tensor,
    query: torch.Tensor,
    max_disp: int,
    out_hw: tuple[int, int],
    align_corners: bool = False,
) -> torch.Tensor:
    """Plain version: ``Σ_d |d − query|·p`` over the full probability volume."""
    _, prob = upsample_cost_and_regress(cost.float(), max_disp, out_hw, align_corners)
    return disparity_uncertainty(prob, query.float(), max_disp)


def fused_uncertainty_at(
    cost: torch.Tensor,
    query: torch.Tensor,
    max_disp: int,
    out_hw: tuple[int, int],
    align_corners: bool = False,
) -> torch.Tensor:
    """The renewal uncertainty ``Σ_d p(d)·|d − q|`` of the upsampled softmax
    volume of ``(B, D4, H4, W4)`` logits, at the ``(B, H, W)`` float32 query
    ``q``; the volume is never written.  Returns ``(B, H, W)`` float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if cost.device.type == "cpu":
        return fused_uncertainty_at_plain(cost, query, max_disp, out_hw, align_corners)
    if cost.dim() != 4:
        raise ValueError(f"cost must be (B, D4, H4, W4), got {tuple(cost.shape)}")
    _check_bins(max_disp)
    b, d4, h4, w4 = cost.shape
    h, w = out_hw
    if tuple(query.shape) != (b, h, w) or query.dtype != torch.float32:
        raise ValueError(f"query must be {(b, h, w)} float32, got {tuple(query.shape)} "
                         f"{query.dtype}")
    _build.check_cuda(cost, query)
    unc = torch.empty((b, h, w), dtype=torch.float32, device=cost.device)
    _build.launch(
        "dv_fused_uncertainty_at", cost, cost.data_ptr(), query.data_ptr(), unc.data_ptr(),
        b, d4, h4, w4, max_disp, h, w, int(align_corners),
    )
    fused_uncertainty_at.launches += 1
    return unc


fused_upsample_softargmin.launches = 0
fused_uncertainty_at.launches = 0
