"""Sampling along the scanline and by a disparity map.

Counterpart of ``diffuvolume_tpu/ops/sampling.py``: ``warp_right_to_left``
(PCW's refinement), ``linear_sample_1d``, ``hat_sample_last2`` and
``context_upsample`` (IGEV's geometry lookup and superpixel upsampling),
and the functions no path calls, with the JAX module's channels-last
signatures: ``stereo_bilinear_sample``, ``grid_sample_2d``,
``coords_grid``, ``gauss_blur``, ``spatial_transformer``,
``spatial_transformer_grid`` and ``forward_interpolate`` (numpy and scipy
on the host, as in the JAX package).  No kernel: plain PyTorch.
"""

from __future__ import annotations

import numpy as np
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


def stereo_bilinear_sample(volume: torch.Tensor, x_coords: torch.Tensor) -> torch.Tensor:
    """Per-pixel vectors ``(P, D, C)`` sampled linearly at ``x_coords (P,
    N)`` → ``(P, N, C)``, zero outside ``[0, D − 1]`` (the reference's
    ``bilinear_sampler`` in ``geometry_ddim.py:33-69``)."""
    return linear_sample_1d(volume, x_coords, zero_pad=True)


def grid_sample_2d(img: torch.Tensor, x_pix: torch.Tensor, y_pix: torch.Tensor,
                   zero_pad: bool = True) -> torch.Tensor:
    """Bilinear sampling of ``img (B, H, W, C)`` at pixel coordinates
    ``x_pix, y_pix (B, Ho, Wo)`` → ``(B, Ho, Wo, C)``; a tap outside the
    image weighs 0 (``zero_pad``) or reads the edge."""
    b, h, w, c = img.shape
    x0, y0 = torch.floor(x_pix), torch.floor(y_pix)
    fx, fy = x_pix - x0, y_pix - y0
    flat = img.reshape(b, h * w, c)

    def tap(yi, xi, wgt):
        idx = (yi.long().clamp(0, h - 1) * w + xi.long().clamp(0, w - 1)).reshape(b, -1, 1)
        v = torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(*yi.shape, c)
        if zero_pad:
            inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            wgt = torch.where(inside, wgt, torch.zeros_like(wgt))
        return v * wgt[..., None]

    return (tap(y0, x0, (1 - fy) * (1 - fx)) + tap(y0, x0 + 1, (1 - fy) * fx)
            + tap(y0 + 1, x0, fy * (1 - fx)) + tap(y0 + 1, x0 + 1, fy * fx))


def coords_grid(batch: int, h: int, w: int, device=None) -> torch.Tensor:
    """``(B, H, W, 2)`` pixel coordinates in (x, y) order, float32
    (KITTI15 ``core/utils/utils.py:80-83``)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1).expand(batch, h, w, 2)


def gauss_blur(x: torch.Tensor, n: int = 5, std: float = 1.0) -> torch.Tensor:
    """Per-channel ``n × n`` Gaussian blur of ``x (B, H, W, C)``, zero
    padded (KITTI15 ``core/utils/utils.py:89-97``)."""
    g = torch.arange(n, dtype=torch.float32, device=x.device) - n // 2
    k = torch.exp(-(g[:, None] ** 2 + g[None, :] ** 2) / (2 * std ** 2))
    k = (k / k.sum().clamp_min(1e-4)).to(x.dtype)
    c = x.shape[-1]
    out = F.conv2d(x.permute(0, 3, 1, 2), k.expand(c, 1, n, n), padding=n // 2, groups=c)
    return out.permute(0, 2, 3, 1)


def spatial_transformer(left: torch.Tensor, right: torch.Tensor,
                        disparity_samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Right features ``(B, H, W, C)`` gathered at ``⌊clamp(w − d, 0, W −
    1)⌋`` for each disparity sample ``(B, S, H, W)``, zero where ``w − d``
    leaves ``[0, W − 1]`` (SceneFlow ``submodule.py:447-500``,
    ``SpatialTransformer``); returns ``(warped_right, left broadcast)``,
    both ``(B, S, H, W, C)``."""
    b, h, w, c = right.shape
    s = disparity_samples.shape[1]
    coords = (torch.arange(w, dtype=disparity_samples.dtype, device=right.device)
              - disparity_samples)
    idx = coords.clamp(0, w - 1).long()
    right_e = right[:, None].expand(b, s, h, w, c)
    warped = torch.gather(right_e, 3, idx[..., None].expand(b, s, h, w, c))
    warped = warped * ((coords >= 0) & (coords <= w - 1))[..., None].to(warped.dtype)
    return warped, left[:, None].expand(b, s, h, w, c)


def spatial_transformer_grid(left: torch.Tensor, right: torch.Tensor,
                             disp_range_samples: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``spatial_transformer`` by linear sampling at ``w − d``, zero
    outside (SceneFlow ``submodule.py:503-531``, ``SpatialTransformer_grid``:
    grid_sample with align_corners at an unchanged y)."""
    b, h, w, c = right.shape
    s = disp_range_samples.shape[1]
    coords = (torch.arange(w, dtype=disp_range_samples.dtype, device=right.device)
              - disp_range_samples)
    warped = linear_sample_1d(right[:, None], coords, zero_pad=True)
    return warped, left[:, None].expand(b, s, h, w, c)


def forward_interpolate(flow) -> np.ndarray:
    """Splat a ``(2, H, W)`` flow forward and regrid it by nearest neighbour
    (KITTI15 ``core/utils/utils.py:28-56``; RAFT's warm start, which the
    stereo recipes do not use): numpy in, numpy float32 out, scipy's
    ``griddata`` on the host."""
    from scipy import interpolate

    flow = np.asarray(flow)
    dx, dy = flow[0], flow[1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1, y1 = (x0 + dx).reshape(-1), (y0 + dy).reshape(-1)
    dxf, dyf = dx.reshape(-1), dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    x1, y1, dxf, dyf = x1[valid], y1[valid], dxf[valid], dyf[valid]
    flow_x = interpolate.griddata((x1, y1), dxf, (x0, y0), method="nearest", fill_value=0)
    flow_y = interpolate.griddata((x1, y1), dyf, (x0, y0), method="nearest", fill_value=0)
    return np.stack([flow_x, flow_y], axis=0).astype(np.float32)
