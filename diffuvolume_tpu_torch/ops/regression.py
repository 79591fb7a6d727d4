"""Disparity regression, uncertainty and linear resampling.

Counterpart of ``diffuvolume_tpu/ops/regression.py``, all of it.  Linear resizes are
contractions with dense interpolation matrices (two non-zero taps per row),
the same formulation as the JAX package, so the two agree to float32
rounding.  ``upsample_cost_and_regress`` + ``disparity_uncertainty`` are the
plain version of the fused head kernel (``ops/kernels/fused_head.py``).
Under ``parallel/volume_sharding.py`` ``regress_head`` takes this rank's
band of the logits' rows and gives its band of full-resolution rows, in
both pixel conventions (``band_rows_matrix``: the global resize's rows of
the band, over the band and one row a side); ACV's eval head applies
``upsample_halo`` around the fused kernel, whose resize takes a whole
factor with half-pixel centres.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from diffuvolume_tpu_torch.parallel.volume_sharding import band_of, current_volume_spec, halo
from diffuvolume_tpu_torch.utils.spans import H2D, span


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or float64 if it is (the training tests run both
    packages in float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def disparity_regression(prob: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Soft-argmin: ``Σ_d d·prob[:, d]`` for ``(B, D, H, W)`` probabilities."""
    d = torch.arange(max_disp, dtype=prob.dtype, device=prob.device)
    return torch.einsum("bdhw,d->bhw", prob, d)


def disparity_uncertainty(
    prob: torch.Tensor, disp: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Renewal confidence ``Σ_d |d - disp|·prob[:, d]`` → ``(B, H, W)``."""
    d = torch.arange(max_disp, dtype=prob.dtype, device=prob.device)
    diff = (disp[:, None] - d[None, :, None, None]).abs()
    return (diff * prob).sum(dim=1)


def disparity_regression_nearby(similarity: torch.Tensor, disp_step: float = 1.0,
                                half_support_window: int = 2) -> torch.Tensor:
    """Soft-argmin over the ``±half_support_window`` bins around each
    pixel's most similar bin (KITTI12 ``submodule.py:40-84``): the bin
    indices clamped to ``[0, D − 1]`` (so an edge bin can count twice),
    softmax over the window, the expectation times ``disp_step``.
    ``(B, D, H, W)`` → ``(B, H, W)``."""
    idx_max = similarity.argmax(dim=1, keepdim=True)
    shifts = torch.arange(-half_support_window, half_support_window + 1,
                          device=similarity.device)[None, :, None, None]
    idx = (idx_max + shifts).clamp(0, similarity.shape[1] - 1)
    prob = torch.softmax(torch.gather(similarity, 1, idx), dim=1)
    return (prob * idx.to(similarity.dtype) * disp_step).sum(dim=1)


def disparity_variance_confidence(prob: torch.Tensor, disparity_samples: torch.Tensor,
                                  disp: torch.Tensor) -> torch.Tensor:
    """``Σ_s prob[:, s]·(disp − samples[:, s])²`` over explicit disparity
    samples ``(B, S, H, W)`` (``submodule.py:440-444``) → ``(B, H, W)``."""
    return (prob * (disp[:, None] - disparity_samples) ** 2).sum(dim=1)


def disparity_variance(prob: torch.Tensor, disp: torch.Tensor, max_disp: int) -> torch.Tensor:
    """``Σ_d prob[:, d]·(disp − d)²`` (``submodule.py:432-438``) → ``(B, H, W)``."""
    d = torch.arange(max_disp, dtype=prob.dtype, device=prob.device)
    return ((disp[:, None] - d[None, :, None, None]) ** 2 * prob).sum(dim=1)


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense 1-D linear interpolation matrix ``M`` (``y = M @ x``), float32.

    ``align_corners=False`` uses half-pixel centres (torch's default);
    ``True`` maps endpoints to endpoints.  Source coordinates are clamped to
    the input (edge replication), as torch does.
    """
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    out = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            src = np.zeros_like(out)
        else:
            src = out * (in_size - 1) / (out_size - 1)
    else:
        src = (out + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    m = np.zeros((out_size, in_size), dtype=np.float64)
    m[np.arange(out_size), lo] += 1.0 - w_hi
    m[np.arange(out_size), hi] += w_hi
    return m.astype(np.float32)


def resize_linear(
    x: torch.Tensor, out_size: int, axis: int, align_corners: bool = False
) -> torch.Tensor:
    """Linear resize along one axis by an interpolation-matrix contraction."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    with span(H2D):
        m = torch.as_tensor(
            _interp_matrix(in_size, out_size, align_corners), device=x.device
        ).to(x.dtype)
    moved = x.movedim(axis, -1)
    return torch.matmul(moved, m.t()).movedim(-1, axis)


def resize_bilinear(
    x: torch.Tensor,
    out_hw: tuple[int, int],
    h_axis: int,
    w_axis: int,
    align_corners: bool = False,
) -> torch.Tensor:
    """Bilinear resize over two axes (separable linear resizes)."""
    x = resize_linear(x, out_hw[0], h_axis, align_corners)
    return resize_linear(x, out_hw[1], w_axis, align_corners)


def resize_volume_trilinear(
    cost: torch.Tensor, out_dhw: tuple[int, int, int], align_corners: bool = False
) -> torch.Tensor:
    """Trilinear resize of a ``(B, D, H, W)`` volume to ``out_dhw``."""
    cost = resize_linear(cost, out_dhw[0], 1, align_corners)
    cost = resize_linear(cost, out_dhw[1], 2, align_corners)
    return resize_linear(cost, out_dhw[2], 3, align_corners)


def upsample_halo(cost: torch.Tensor, out_h: int,
                  align_corners: bool = False) -> tuple[torch.Tensor, int, slice]:
    """Under ``volume_sharding``: a resize of this rank's band ``[h0, h1)`` of
    ``(B, D4, H4, W4)`` logits' rows to its ``[f·h0, f·h1)`` rows of an
    ``out_h = f·H4`` output.  Returns ``(cost with one row a side, the
    resize's height for it, the output rows to keep)``: output row ``o``
    reads rows ``⌊(o + ½)/f − ½⌋`` and the next, one past the band at its
    ends, and the global resize clamps at the image's edges, which the
    halo's replicated edge rows reproduce."""
    _, n, rows = band_of(cost)
    f, rem = divmod(out_h, rows)
    if rem or align_corners:
        raise ValueError(f"the split upsample takes a whole factor from H4 to {out_h} with "
                         f"half-pixel centres")
    return halo(cost, 1, 1, "replicate"), f * (n + 2), slice(f, f * (n + 1))


@functools.lru_cache(maxsize=64)
def band_rows_matrix(first: int, n: int, rows: int, out_h: int,
                     align_corners: bool) -> np.ndarray:
    """The rows ``[f·first, f·(first + n))`` of the ``(out_h, rows)`` resize
    matrix (``out_h = f·rows``) over the input rows ``[first − 1, first + n
    + 1)``, zero columns past the image: a band's output rows read its own
    rows and at most one a side in both conventions (with
    ``align_corners``, ``o·(rows − 1)/(out_h − 1)`` lies in ``(first − 1,
    first + n)`` there)."""
    f, rem = divmod(out_h, rows)
    if rem:
        raise ValueError(f"the split resize takes a whole factor from {rows} rows to {out_h}")
    m = np.pad(_interp_matrix(rows, out_h, align_corners), ((0, 0), (1, 1)))
    band_rows = m[f * first:f * (first + n)]
    out = band_rows[:, first:first + n + 2]
    if np.abs(out).sum() != np.abs(band_rows).sum():
        raise ValueError("a band's resized rows read past one row a side")
    return out


def upsample_cost_and_regress(
    cost: torch.Tensor,
    max_disp: int,
    out_hw: tuple[int, int],
    align_corners: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Upsample ``(B, D4, H4, W4)`` logits to ``(B, max_disp, H, W)``, softmax
    over disparity, soft-argmin.  Returns ``(pred (B,H,W), prob)``."""
    up = resize_volume_trilinear(
        cost, (max_disp, out_hw[0], out_hw[1]), align_corners
    )
    prob = torch.softmax(up, dim=1)
    return disparity_regression(prob, max_disp), prob


def regress_head(cost: torch.Tensor, max_disp: int, out_hw: tuple[int, int],
                 align_corners: bool = False) -> torch.Tensor:
    """A training head's regression: ``upsample_cost_and_regress`` of the
    ``(B, D4, H4, W4)`` logits in float32 (float64 stays), autocast off (the
    JAX package casts the cost to float32 first) → ``(B, H, W)``; this
    rank's rows under ``volume_sharding``, resized over H by the global
    resize's rows of the band (``band_rows_matrix``)."""
    with torch.autocast(cost.device.type, enabled=False):
        cost = at_least_f32(cost)
        if current_volume_spec() is None:
            return upsample_cost_and_regress(cost, max_disp, out_hw, align_corners)[0]
        first, n, rows = band_of(cost)
        with span(H2D):
            m = torch.as_tensor(band_rows_matrix(first, n, rows, out_hw[0], align_corners),
                                device=cost.device).to(cost.dtype)
        up = resize_linear(halo(cost, 1, 1), max_disp, 1, align_corners)
        up = torch.matmul(up.movedim(2, -1), m.t()).movedim(-1, 2)
        prob = torch.softmax(resize_linear(up, out_hw[1], 3, align_corners), dim=1)
        return disparity_regression(prob, max_disp)
