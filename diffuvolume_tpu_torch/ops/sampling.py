"""Sampling along the scanline and by a disparity map.

Counterpart of ``diffuvolume_tpu/ops/sampling.py``: ``warp_right_to_left``
(PCW's refinement), ``linear_sample_1d``, ``hat_sample_last2`` and
``context_upsample`` (IGEV's geometry lookup and superpixel upsampling).  No
kernel: plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def warp_right_to_left(right: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Warp the right features ``(B, C, H, W)`` to the left view by the left
    disparity ``(B, H, W)``, as the reference does (KITTI12
    ``submodule.py:137-176``), quirk included: the grid is normalised by
    ``W − 1`` and ``H − 1`` (the align-corners convention) but sampled with
    ``align_corners=False``, so the source coordinate is ``c·S/(S−1) − 0.5``
    per axis and the first and last rows fall half outside.  Zero padding;
    a validity mask (the warped ones below 0.999 → 0) multiplies the result.
    """
    b, c, h, w = right.shape
    xs = torch.arange(w, dtype=disp.dtype, device=disp.device)[None, None, :] - disp
    ys = torch.arange(h, dtype=disp.dtype, device=disp.device)[None, :, None].expand(b, h, w)
    grid = torch.stack([2.0 * xs / max(w - 1, 1) - 1.0, 2.0 * ys / max(h - 1, 1) - 1.0], dim=-1)
    grid = grid.to(right.dtype)
    out = F.grid_sample(right, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    ones = torch.ones((b, 1, h, w), dtype=right.dtype, device=right.device)
    mask = F.grid_sample(ones, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    return out * (mask >= 0.999).to(out.dtype)


def linear_sample_1d(values: torch.Tensor, coords: torch.Tensor,
                     zero_pad: bool = True) -> torch.Tensor:
    """Linear interpolation of ``values (..., W, C)`` along its second-to-last
    axis at pixel coordinates ``coords (..., N)`` → ``(..., N, C)``: the
    reference's ``bilinear_sampler`` (align-corners pixel coordinates);
    out-of-range taps are zero (``zero_pad``) or clamp to the edge."""
    w = values.shape[-2]
    lo = torch.floor(coords)
    frac = coords - lo
    lo_i = lo.long()
    idx_lo = lo_i.clamp(0, w - 1)
    idx_hi = (lo_i + 1).clamp(0, w - 1)
    lead = torch.broadcast_shapes(values.shape[:-2], coords.shape[:-1])
    vals = values.expand(*lead, *values.shape[-2:])

    def take(idx):
        idx = idx.expand(*lead, idx.shape[-1])[..., None].expand(*lead, idx.shape[-1],
                                                                 values.shape[-1])
        return torch.gather(vals, -2, idx)

    if zero_pad:
        w_lo = torch.where((lo >= 0) & (lo <= w - 1), 1.0 - frac, 0.0)
        w_hi = torch.where((lo + 1 >= 0) & (lo + 1 <= w - 1), frac, 0.0)
    else:
        w_lo, w_hi = 1.0 - frac, frac
    return take(idx_lo) * w_lo[..., None] + take(idx_hi) * w_hi[..., None]


def hat_sample_last2(vol: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Linear sampling of ``vol (B, H, W, D, C)`` along D at ``x0 (B, H, W,
    J)`` as a contraction with hat weights ``max(0, 1 − |x − d|)`` →
    ``(B, H, W, J, C)``; positions out of ``[0, D − 1]`` fade to zero as
    ``linear_sample_1d``'s do.  The weights are float32, cast to a bfloat16
    volume's dtype for the product (two non-zero taps a row)."""
    d = vol.shape[-2]
    bins = torch.arange(d, dtype=x0.dtype, device=x0.device)
    w = (1.0 - (x0[..., None] - bins).abs()).clamp_min(0.0)
    if vol.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16)
    else:
        vol = vol.to(w.dtype)
    return torch.einsum("bhwjd,bhwdc->bhwjc", w, vol)


def context_upsample(disp_low: torch.Tensor, up_weights: torch.Tensor) -> torch.Tensor:
    """Superpixel upsampling (KITTI15 ``submodule.py:241-252``): the 3×3
    zero-padded neighbourhood of each quarter-resolution pixel of
    ``disp_low (B, H, W)``, nearest-upsampled ×4 and blended by the softmax
    weights ``up_weights (B, 9, 4H, 4W)`` (row-major over (dy, dx)) →
    ``(B, 4H, 4W)``."""
    b, h, w = disp_low.shape
    padded = F.pad(disp_low, (1, 1, 1, 1))
    unfold = torch.stack([padded[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                         dim=1)
    up = unfold.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)
    return (up * up_weights).sum(dim=1)
