"""Warping by a disparity map.

Counterpart of ``diffuvolume_tpu/ops/sampling.py:warp_right_to_left``.  No
kernel: ``F.grid_sample`` computes it.
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
