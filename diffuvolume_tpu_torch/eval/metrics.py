"""Stereo evaluation metrics (EPE / D1 / Thres@k), masked and per image.

Counterpart of ``diffuvolume_tpu/eval/metrics.py`` on torch tensors.  The
semantics follow SceneFlow/utils/metrics.py: per-image masked means, the D1
error is ``|e| > 3 px and |e| / |gt| > 5%``, and an image whose valid-mask
coverage (against its ``gt > 0`` pixels) is below 10% gets weight 0.  Each
metric is a weighted reduction (no boolean indexing), so it runs on the
card as one small set of kernels whatever the mask holds; the masked sums
are taken in float64 and the means rounded once to float32.
"""

from __future__ import annotations

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Summed in float64, rounded once to ``x``'s dtype: the mean then
    hardly depends on the device's summation order (an EPE of 90 px over
    half a million pixels moves by 1.5e-5 between the card's and the CPU's
    float32 sums)."""
    m = mask.double()
    mean = (x.double() * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2)).clamp_min(1.0)
    return mean.to(x.dtype)


def epe_metric(d_est: torch.Tensor, d_gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-image mean absolute disparity error over ``mask``: (B,H,W) → (B,)."""
    return _masked_mean((d_est - d_gt).abs(), mask)


def d1_metric(d_est: torch.Tensor, d_gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-image KITTI D1: the share of masked pixels with error > 3 px and
    error / |gt| > 5%."""
    e = (d_est - d_gt).abs()
    bad = (e > 3.0) & (e / d_gt.abs().clamp_min(1e-12) > 0.05)
    return _masked_mean(bad.to(d_est.dtype), mask)


def thres_metric(d_est: torch.Tensor, d_gt: torch.Tensor, mask: torch.Tensor,
                 thres: float) -> torch.Tensor:
    """Per-image share of masked pixels with error above ``thres``."""
    bad = (d_est - d_gt).abs() > thres
    return _masked_mean(bad.to(d_est.dtype), mask)


def metrics_batch(d_est: torch.Tensor, d_gt: torch.Tensor,
                  mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """Every standard metric and the per-image validity ``weight``, each
    ``(B,)``: averaging with ``weight`` reproduces the reference's skipping
    of images whose masked coverage / (gt > 0) coverage is below 10%
    (metrics.py:30-33)."""
    coverage = mask.float().mean(dim=(1, 2))
    gt_pos = (d_gt > 0).float().mean(dim=(1, 2))
    weight = (coverage / gt_pos.clamp_min(1e-12) >= 0.1).float()
    return {
        "EPE": epe_metric(d_est, d_gt, mask),
        "D1": d1_metric(d_est, d_gt, mask),
        "Thres1": thres_metric(d_est, d_gt, mask, 1.0),
        "Thres2": thres_metric(d_est, d_gt, mask, 2.0),
        "Thres3": thres_metric(d_est, d_gt, mask, 3.0),
        "weight": weight,
    }
