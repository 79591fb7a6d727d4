"""Disparity → bin-volume codec (counterpart of ``diffuvolume_tpu/diffusion/codec.py``).

The reference's scatter construction written as a hat-kernel weighting,
``w_k = relu(1 - |k - d|)``, which needs no scatter.
"""

from __future__ import annotations

import torch


def encode_disparity_volume(
    disp: torch.Tensor,
    num_bins: int = 48,
    scale: float = 1.0,
    valid_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Encode ``(B, H, W)`` disparity in bin units as a ``(B, D, H, W)`` soft
    two-hot volume in ``[-scale, scale]``.

    Bin ``⌊d⌋`` gets ``⌊d⌋ - d + 1`` and bin ``⌊d⌋+1`` the rest; pixels with
    ``⌊d⌋ == num_bins-1`` become one-hot on the last bin; pixels where
    ``valid_mask == 0`` become uniform ``1/num_bins``.
    """
    bins = torch.arange(num_bins, dtype=disp.dtype, device=disp.device)
    w = torch.relu(1.0 - (bins[None, :, None, None] - disp[:, None]).abs())
    last_bin = torch.floor(disp) == (num_bins - 1)
    one_hot_last = torch.zeros_like(w)
    one_hot_last[:, -1] = 1.0
    vol = torch.where(last_bin[:, None], one_hot_last, w)
    if valid_mask is not None:
        uniform = torch.full_like(vol, 1.0 / num_bins)
        vol = torch.where(valid_mask[:, None] == 0, uniform, vol)
    return (vol * 2.0 - 1.0) * scale
