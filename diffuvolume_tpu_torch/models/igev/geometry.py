"""IGEV's combined geometry lookup: the Geometry Encoding Volume and the
all-pairs correlation, sampled in a window around the current disparity.

Counterpart of ``diffuvolume_tpu/models/igev/geometry.py``
(``build_geo_pyramid``, ``_extract_diag_band``, ``fold_reference_noise``,
``geo_lookup``) in its four correlation representations, equal within their
stated domains:

* ``"band"`` (the eval default): only the diagonal band of the correlation
  that the lookup can reach, exact for quarter-res disparities in
  ``[-1, band - 12]``;
* ``"volume"``: the dense correlation, exact for any disparity (the
  training forward's, and the tests' reference);
* ``"lowband"``: the first ``band`` columns of the correlation, sampled at
  absolute positions; exact where every position stays below ``band - 1``,
  as in the reference-faithful eval, whose correlation positions are the
  constant ``init_disp·2⁻ⁱ + dx``;
* ``"rsamp"``: the correlation never built; the lookup samples the pooled
  right descriptors along the scanline and dots them with the left one
  (pooling the correlation over ``v`` is correlating with the pooled right
  descriptors, by linearity).

The GEV stays ``(B, H, W, D, C)`` at level 0 only: a pooled level's sample
is the level-0 bins contracted with coarsened hat weights (linear in the
pooling).  The JAX package's materialised pooled GEV (``geo_pool``,
``$DIFFU_GEO_POOL1``) equals that form by linearity and is a TPU layout
choice; it is not carried over.  The lookup's features come concatenated in
the order ``BasicMotionEncoder.convc1`` was trained on: per level the GEV
samples tap-major then channel, then the correlation samples, levels
``[geo_0, corr_0, geo_1, corr_1]`` (162 channels at radius 4, 8 channels,
two levels).  ``fold_reference_noise`` gives the reference's own noise
treatment (the reshape scramble, the noise pooled apart from the GEV) as
weights for ``geo_lookup(..., noise_eff=...)``.  Plain PyTorch; no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.ops.regression import at_least_f32
from diffuvolume_tpu_torch.ops.sampling import hat_sample_last2

CORR_MODES = ("band", "volume", "lowband", "rsamp")


class GeoPyramid(NamedTuple):
    geo: torch.Tensor                      # (B, H, W, D, C) level-0 GEV
    corr_levels: tuple = ()                # "volume": each (B, H, W, W >> i)
    band_levels: tuple = ()                # "band" / "lowband": each (B, H, W, band_i)
    band_offs: tuple = ()                  # "band": the anchor column of each band
    band_mode: str = "diag"                # "diag" (anchored at ⌊w·2⁻ⁱ⌋) | "low" (absolute)
    match_l: torch.Tensor | None = None    # "rsamp": (B, H, W, C) left descriptors
    match_r_levels: tuple = ()             # "rsamp": each (B, H, W >> i, C)

    @property
    def num_levels(self) -> int:
        return len(self.corr_levels) or len(self.band_levels) or len(self.match_r_levels)


def _avgpool_last(x: torch.Tensor) -> torch.Tensor:
    """Average pairs along the last axis (a trailing odd element dropped)."""
    n = x.shape[-1] // 2
    return x[..., :2 * n].reshape(*x.shape[:-1], n, 2).mean(-1)


def _pyramid(x: torch.Tensor, num_levels: int) -> list:
    levels = [x]
    for _ in range(num_levels - 1):
        levels.append(_avgpool_last(levels[-1]))
    return levels


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
      corr_mode: ``"band"``, ``"volume"``, ``"lowband"`` or ``"rsamp"`` (see
        the module docstring).
      band: the band's width at level 0 (``"band"``: a narrower level clamps
        it; ``"lowband"``: the columns kept, at most the image's width).
    """
    if corr_mode not in CORR_MODES:
        raise ValueError(f"corr_mode must be one of {CORR_MODES}, got {corr_mode!r}")
    if corr_mode == "rsamp":
        right = match_right.permute(0, 2, 3, 1)                       # (B, H, W, C)
        levels = [right]
        for _ in range(num_levels - 1):
            r = levels[-1]
            v = r.shape[2] // 2
            levels.append(r[:, :, :2 * v].reshape(r.shape[0], r.shape[1], v, 2,
                                                   r.shape[3]).mean(3))
        return GeoPyramid(geo, match_l=match_left.permute(0, 2, 3, 1),
                          match_r_levels=tuple(levels))
    if corr_mode == "lowband":
        # Only the first min(band, W) columns are ever sampled: a narrow
        # product instead of the W × W one.
        bw = min(band, match_right.shape[-1])
        corr = torch.einsum("bchw,bchv->bhwv", match_left, match_right[..., :bw])
        return GeoPyramid(geo, band_levels=tuple(_pyramid(corr, num_levels)),
                          band_offs=(0,) * num_levels, band_mode="low")
    levels = _pyramid(torch.einsum("bchw,bchv->bhwv", match_left, match_right), num_levels)
    if corr_mode == "volume":
        return GeoPyramid(geo, corr_levels=tuple(levels))
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


def fold_reference_noise(noise_mod: torch.Tensor, num_levels: int = 2) -> torch.Tensor:
    """The reference's noise weights (``geometry_ddim.py:37-58``) on level-0
    bins, for ``geo_lookup(..., noise_eff=...)`` with a clean GEV.

    Two behaviours of the reference that ``premultiply`` cleans up:

    1. the reshape scramble: ``noisy.reshape(batch*h1*w1, 1, 1, -1)`` of a
       C-contiguous ``(B, D, H, W)`` tensor gives pixel ``p = h·W + w`` the
       ``D`` elements ``flat[p·D:(p+1)·D]`` of the flattened ``(D, H, W)``
       block, mixing bins across pixels;
    2. pool, then multiply: level ``i`` samples ``pool_i(geo)·pool_i(noise)``,
       the noise pooled apart from the GEV.  By linearity that is the
       level-0 bins times ``pool_i(noise)[d >> i]`` under the coarsened hat.

    Args:
      noise_mod: ``(B, D, H, W)`` time-embedded noise in [0, 1].

    Returns ``(B, H, W, L, D)`` per-level weights on level-0 bins.
    """
    b, d, h, w = noise_mod.shape
    n0 = noise_mod.contiguous().reshape(b, h, w, d)  # row p of the (D·H·W)-flat block
    levels = _pyramid(n0, num_levels)
    eff = [lv.repeat_interleave(2 ** i, dim=-1)[..., :d] for i, lv in enumerate(levels)]
    return torch.stack(eff, dim=-2)


def geo_lookup(pyramid: GeoPyramid, disp: torch.Tensor, coords: torch.Tensor,
               radius: int = 4, noise_eff: torch.Tensor | None = None) -> torch.Tensor:
    """Sample the GEV and the correlation at ``disp·2⁻ⁱ + dx``,
    ``dx ∈ [−r, r]``, on each level (``geometry_ddim.py:33-69``).

    Args:
      disp: ``(B, H, W)`` float32 disparity in quarter-res pixels.
      coords: ``(B, H, W)`` x coordinates (the pixel index; the reference
        eval's carried disparity in its reference-faithful mode).
      noise_eff: ``(B, H, W, L, D)`` weights from ``fold_reference_noise``,
        multiplied into the float32 hat weights before they are cast to a
        bfloat16 GEV's dtype; the GEV must then be clean (not
        ``premultiply``'d).

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
    coords = coords.to(ft)
    dx = torch.arange(-radius, radius + 1, dtype=ft, device=dev)
    # All levels as one contraction over the level-0 bins: sampling the
    # 2ⁱ-pooled volume at x is contracting the level-0 bins with the hat
    # max(0, 1 − |x − ⌊d·2⁻ⁱ⌋|)·2⁻ⁱ.
    scale = (2.0 ** -torch.arange(nl, dtype=ft, device=dev)).repeat_interleave(j)
    x0 = disp[..., None] * scale + dx.repeat(nl)                         # (B, H, W, L·J)
    bins = torch.floor(torch.arange(d, dtype=ft, device=dev)[None, :]
                       * scale[:, None])                                 # (L·J, D)
    wgt = (1.0 - (x0[..., None] - bins).abs()).clamp_min(0.0) * scale[:, None]
    if noise_eff is not None:
        # Each level's weights over its J taps, by a broadcast.
        wgt = (wgt.view(b, h, w, nl, j, d) * noise_eff.to(ft)[..., None, :]).view(
            b, h, w, nl * j, d)
    if geo.dtype == torch.bfloat16:
        wgt = wgt.to(torch.bfloat16)
    else:
        geo = geo.to(ft)
    geo_out = torch.einsum("bhwjd,bhwdc->bhwjc", wgt, geo)                # (B, H, W, L·J, C)

    corr_out = []
    for i in range(nl):
        s = 2.0 ** -i
        if pyramid.match_r_levels:
            # rsamp: hat-sample the pooled right descriptors along the
            # scanline, then dot with the left descriptor.
            r2 = pyramid.match_r_levels[i]
            p = ((coords - disp) * s)[..., None] + dx                     # (B, H, W, J)
            bins_v = torch.arange(r2.shape[2], dtype=ft, device=dev)
            wv = (1.0 - (p[..., None] - bins_v).abs()).clamp_min(0.0)   # (B, H, W, J, V)
            if r2.dtype == torch.bfloat16:
                wv = wv.to(torch.bfloat16)
            else:
                r2 = r2.to(ft)
            rs = torch.einsum("bhwjv,bhvc->bhwjc", wv, r2)
            corr_out.append(torch.einsum("bhwjc,bhwc->bhwj", rs,
                                         pyramid.match_l.to(rs.dtype)))
            continue
        if pyramid.band_levels and pyramid.band_mode == "diag":
            # Positions relative to the level's anchor ⌊w·2⁻ⁱ⌋: the w term
            # collapses to the residue fraction.
            cs = coords * s
            p = (cs - torch.floor(cs) - disp * s)[..., None] + dx + float(
                pyramid.band_offs[i])
            vol = pyramid.band_levels[i]
        else:
            p = ((coords - disp) * s)[..., None] + dx
            vol = (pyramid.band_levels or pyramid.corr_levels)[i]
        corr_out.append(hat_sample_last2(vol[..., None], p)[..., 0])    # (B, H, W, J)

    out = []
    for i, cr in enumerate(corr_out):
        out.append(geo_out[..., i * j:(i + 1) * j, :].reshape(b, h, w, j * c))
        out.append(cr.to(geo_out.dtype))
    return torch.cat(out, dim=-1)
