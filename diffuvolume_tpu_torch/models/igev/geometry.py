"""IGEV's combined geometry lookup: the Geometry Encoding Volume and the
all-pairs correlation, sampled in a window around the current disparity.

Counterpart of ``diffuvolume_tpu/models/igev/geometry.py``
(``build_geo_pyramid``, ``_extract_diag_band``, ``geo_lookup``) in the two
correlation representations the eval pipeline needs: ``"band"`` (the
default; only the diagonal band of the correlation that the lookup can
reach, exact for quarter-res disparities in ``[-1, band - 12]``) and
``"volume"`` (the dense correlation, exact for any disparity; the tests'
reference).  The GEV stays ``(B, H, W, D, C)`` at level 0 only: a pooled
level's sample is the level-0 bins contracted with coarsened hat weights
(linear in the pooling).  The lookup's features come concatenated in the
order ``BasicMotionEncoder.convc1`` was trained on: per level the GEV
samples tap-major then channel, then the correlation samples, levels
``[geo_0, corr_0, geo_1, corr_1]`` (162 channels at radius 4, 8 channels,
two levels).  Plain PyTorch; no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.ops.regression import at_least_f32
from diffuvolume_tpu_torch.ops.sampling import hat_sample_last2


class GeoPyramid(NamedTuple):
    geo: torch.Tensor                      # (B, H, W, D, C) level-0 GEV
    corr_levels: tuple = ()                # "volume": each (B, H, W, W >> i)
    band_levels: tuple = ()                # "band": each (B, H, W, band_i)
    band_offs: tuple = ()                  # "band": the anchor column of each band

    @property
    def num_levels(self) -> int:
        return len(self.corr_levels) or len(self.band_levels)


def _avgpool_last(x: torch.Tensor) -> torch.Tensor:
    """Average pairs along the last axis (a trailing odd element dropped)."""
    n = x.shape[-1] // 2
    return x[..., :2 * n].reshape(*x.shape[:-1], n, 2).mean(-1)


def extract_diag_band(corr: torch.Tensor, level: int, band: int, off: int) -> torch.Tensor:
    """``out[b, h, w, k] = corr[b, h, w, (w >> level) + k − off]``, zero where
    that column falls outside ``[0, V)``: the band built by pad and reshape,
    as the JAX package builds it (the anchored element ``(w, (w >> i) + c)``
    with ``w = 2ⁱ·u + r`` sits at flat index ``u·(2ⁱ·V + 1) + r·V + c``).
    ``corr`` is ``(B, H, W, V)``."""
    b, h, w, v = corr.shape
    step = 1 << level
    if w % step or band > v + 1:
        raise ValueError(f"band {band} at level {level} does not fit a ({w}, {v}) correlation")
    u = w // step
    stride = step * v + 1
    pad_r = u * stride - off - w * v
    p = F.pad(corr.reshape(b, h, w * v), (off, pad_r)).reshape(b, h, u, stride)
    out = torch.stack([p[..., r * v:r * v + band] for r in range(step)], dim=3)
    out = out.reshape(b, h, w, band)
    idx = ((torch.arange(w, device=corr.device)[:, None] >> level)
           + torch.arange(band, device=corr.device)[None, :] - off)
    return out * ((idx >= 0) & (idx < v)).to(out.dtype)


def build_geo_pyramid(match_left: torch.Tensor, match_right: torch.Tensor, geo: torch.Tensor,
                      num_levels: int = 2, corr_mode: str = "band",
                      band: int = 64) -> GeoPyramid:
    """The lookup's precomputed volumes (``geometry_ddim.py:7-31``).

    Args:
      match_left / match_right: ``(B, C, H, W)`` descriptors.
      geo: ``(B, H, W, D, C)`` Geometry Encoding Volume.
      corr_mode: ``"band"`` or ``"volume"``.
      band: the band's width at level 0 (a narrower level clamps it).
    """
    corr = torch.einsum("bchw,bchv->bhwv", match_left, match_right)
    levels = [corr]
    for _ in range(num_levels - 1):
        levels.append(_avgpool_last(levels[-1]))
    if corr_mode == "volume":
        return GeoPyramid(geo, corr_levels=tuple(levels))
    if corr_mode != "band":
        raise ValueError(f"corr_mode must be 'band' or 'volume', got {corr_mode!r}")
    bands = [min(band, c.shape[-1] + 1) for c in levels]
    offs = [bi - 7 for bi in bands]
    return GeoPyramid(
        geo, band_levels=tuple(extract_diag_band(c, i, bi, oi)
                               for i, (c, bi, oi) in enumerate(zip(levels, bands, offs))),
        band_offs=tuple(offs))


def band_exact_domain(w4: int, num_levels: int = 2, band: int = 64) -> tuple[float, float]:
    """The quarter-res disparities ``[lo, hi]`` for which ``"band"`` mode's
    lookup at radius 4 equals ``"volume"`` mode's at every pixel of a ``w4``
    wide row: level ``i``'s band of ``b_i = min(band, (w4 >> i) + 1)``
    columns reaches ``disp·2⁻ⁱ`` in ``[−1, b_i − 12]``, so ``lo = −1`` and
    ``hi = minᵢ (b_i − 12)·2ⁱ`` ([−1, 52] at W 1248, [−1, 26] at W 192,
    [−1, 2] at W 96)."""
    hi = min((min(band, (w4 >> i) + 1) - 12) * 2 ** i for i in range(num_levels))
    return -1.0, float(hi)


def premultiply(pyramid: GeoPyramid, noise: torch.Tensor) -> GeoPyramid:
    """The DiffuVolume latent's transform ``noise (B, D, H, W)`` multiplied
    into the GEV once per DDIM step (the per-lookup multiply of
    ``geometry_ddim.py:56`` hoisted out of the GRU loop), in float32
    (float64 for float64), stored in the GEV's dtype."""
    geo = at_least_f32(pyramid.geo) * at_least_f32(noise).permute(0, 2, 3, 1)[..., None]
    return pyramid._replace(geo=geo.to(pyramid.geo.dtype))


def geo_lookup(pyramid: GeoPyramid, disp: torch.Tensor, coords: torch.Tensor,
               radius: int = 4) -> torch.Tensor:
    """Sample the GEV and the correlation at ``disp·2⁻ⁱ + dx``,
    ``dx ∈ [−r, r]``, on each level (``geometry_ddim.py:33-69``).

    Args:
      disp: ``(B, H, W)`` float32 disparity in quarter-res pixels.
      coords: ``(B, H, W)`` x coordinates (the pixel index).

    Returns ``(B, H, W, L·(2r+1)·(C+1))`` in the GEV's dtype.
    """
    b, h, w = disp.shape
    nl = pyramid.num_levels
    j = 2 * radius + 1
    geo = pyramid.geo
    d, c = geo.shape[-2:]
    dev = disp.device
    disp = at_least_f32(disp)
    ft = disp.dtype
    dx = torch.arange(-radius, radius + 1, dtype=ft, device=dev)
    # All levels as one contraction over the level-0 bins: sampling the
    # 2ⁱ-pooled volume at x is contracting the level-0 bins with the hat
    # max(0, 1 − |x − ⌊d·2⁻ⁱ⌋|)·2⁻ⁱ.
    scale = (2.0 ** -torch.arange(nl, dtype=ft, device=dev)).repeat_interleave(j)
    x0 = disp[..., None] * scale + dx.repeat(nl)                         # (B, H, W, L·J)
    bins = torch.floor(torch.arange(d, dtype=ft, device=dev)[None, :]
                       * scale[:, None])                                 # (L·J, D)
    wgt = (1.0 - (x0[..., None] - bins).abs()).clamp_min(0.0) * scale[:, None]
    if geo.dtype == torch.bfloat16:
        wgt = wgt.to(torch.bfloat16)
    else:
        geo = geo.to(ft)
    geo_out = torch.einsum("bhwjd,bhwdc->bhwjc", wgt, geo)                # (B, H, W, L·J, C)

    corr_out = []
    for i in range(nl):
        s = 2.0 ** -i
        if pyramid.band_levels:
            # Positions relative to the level's anchor ⌊w·2⁻ⁱ⌋: the w term
            # collapses to the residue fraction.
            cs = coords.to(ft) * s
            p = (cs - torch.floor(cs) - disp * s)[..., None] + dx + float(
                pyramid.band_offs[i])
            vol = pyramid.band_levels[i]
        else:
            p = ((coords.to(ft) - disp) * s)[..., None] + dx
            vol = pyramid.corr_levels[i]
        corr_out.append(hat_sample_last2(vol[..., None], p)[..., 0])    # (B, H, W, J)

    out = []
    for i, cr in enumerate(corr_out):
        out.append(geo_out[..., i * j:(i + 1) * j, :].reshape(b, h, w, j * c))
        out.append(cr.to(geo_out.dtype))
    return torch.cat(out, dim=-1)
