"""Stereo cost-volume builders in the reference's layout.

Counterpart of ``diffuvolume_tpu/ops/cost_volume.py``, but in PyTorch's
layout: features ``(B, C, H, W)``, volumes ``(B, C, D, H, W)`` (the layout the
reference builds and ``F.conv3d`` takes).  Each function here is the plain
version of a kernel in ``ops/kernels/``:

* ``build_gwc_volume``          → ``ops/kernels/gwc_volume.py`` (``gwc_volume``)
* ``gwc_volume_slot``           → ``ops/kernels/gwc_volume.py`` (``gwc_volume_packed``)
* ``concat_volume_mul``         → ``ops/kernels/concat_volume.py`` (build)
* ``volume_dhw_mul``            → ``ops/kernels/concat_volume.py`` (multiply)

The last three also come channels-last (``(B, D, H, W, C)``), the layout of
the folded path's conv kernels (``gwc_volume_slot`` only so).
``build_signed_correlation_volume`` (the PCW refinement's 49-shift
correlation) has no kernel.

The multiplies are taken in float32 and rounded once to the volume's dtype,
in the order the kernels take them, so a kernel and its plain version agree
exactly on the same inputs.
"""

from __future__ import annotations

import torch


def groupwise_correlation(
    fea1: torch.Tensor, fea2: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """Per-group mean of ``fea1·fea2``: ``(B, C, H, W)`` → ``(B, G, H, W)``,
    taken in float32 (float64 for float64 features)."""
    b, c, h, w = fea1.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    cpg = c // num_groups
    ft = torch.promote_types(fea1.dtype, torch.float32)
    prod = fea1.to(ft) * fea2.to(ft)
    return prod.view(b, num_groups, cpg, h, w).mean(dim=2).to(fea1.dtype)


def build_gwc_volume(
    left: torch.Tensor, right: torch.Tensor, max_disp: int, num_groups: int
) -> torch.Tensor:
    """Group-wise correlation volume ``(B, G, D, H, W)``.

    ``vol[b, g, d, h, w] = mean_{c∈g} left[b,c,h,w]·right[b,c,h,w-d]`` for
    ``w ≥ d``, zero elsewhere.
    """
    b, c, h, w = left.shape
    vol = left.new_zeros((b, num_groups, max_disp, h, w))
    for d in range(min(max_disp, w)):
        if d == 0:
            vol[:, :, 0] = groupwise_correlation(left, right, num_groups)
        else:
            vol[:, :, d, :, d:] = groupwise_correlation(
                left[..., d:], right[..., :-d], num_groups
            )
    return vol


def build_concat_volume(
    left: torch.Tensor, right: torch.Tensor, max_disp: int, mask_ref: bool = False
) -> torch.Tensor:
    """Concatenation volume ``(B, 2C, D, H, W)``.

    ``vol[:, :C, d, h, w] = left[:, :, h, w]`` at every ``d`` (with
    ``mask_ref=True`` only where ``w ≥ d``); ``vol[:, C:, d, h, w] =
    right[:, :, h, w-d]`` where ``w ≥ d``, zero elsewhere.
    """
    b, c, h, w = left.shape
    vol = left.new_zeros((b, 2 * c, max_disp, h, w))
    if not mask_ref:
        vol[:, :c] = left[:, :, None]
    for d in range(min(max_disp, w)):
        if d == 0:
            vol[:, c:, 0] = right
            if mask_ref:
                vol[:, :c, 0] = left
        else:
            vol[:, c:, d, :, d:] = right[..., :-d]
            if mask_ref:
                vol[:, :c, d, :, d:] = left[..., d:]
    return vol


def slot_width(channels: int) -> int:
    """The smallest multiple of 16 that holds ``channels``: the conv kernels
    step over input channels 16 at a time."""
    return -(-channels // 16) * 16


def gwc_volume_slot(
    left: torch.Tensor, right: torch.Tensor, max_disp: int, num_groups: int,
    slot: int | None = None, cat_l: torch.Tensor | None = None,
    cat_r: torch.Tensor | None = None, mask_ref: bool = False,
) -> torch.Tensor:
    """``build_gwc_volume`` and, when ``cat_l``/``cat_r`` ``(B, cc, H, W)``
    are given, ``build_concat_volume(cat_l, cat_r, D, mask_ref)`` after it,
    channels-last ``(B, D, H, W, slot)`` with the channels past ``G + 2cc``
    zero; ``slot`` defaults to ``slot_width(G + 2cc)``."""
    vols = [build_gwc_volume(left, right, max_disp, num_groups)]
    if cat_l is not None:
        vols.append(build_concat_volume(cat_l, cat_r, max_disp, mask_ref))
    vol = torch.cat(vols, dim=1).permute(0, 2, 3, 4, 1)
    c = vol.shape[-1]
    slot = slot_width(c) if slot is None else slot
    if slot < c:
        raise ValueError(f"a {slot}-channel slot cannot hold {c} channels")
    return torch.nn.functional.pad(vol, (0, slot - c)).contiguous()


def build_signed_correlation_volume(
    left: torch.Tensor, right: torch.Tensor, max_offset: int
) -> torch.Tensor:
    """Single-group correlation over the signed shifts ``-max_offset ..
    max_offset``: ``(B, C, H, W)`` features → ``(B, 2·max_offset + 1, H,
    W)``, ``vol[:, k, h, w] = mean_c left[:, c, h, w]·right[:, c, h, w - d]``
    for ``d = k - max_offset`` where ``w - d`` is in range, zero elsewhere
    (the PCW refinement's volume, 49 shifts at full resolution)."""
    b, _, h, w = left.shape
    vol = left.new_zeros((b, 2 * max_offset + 1, h, w))
    for k, d in enumerate(range(-max_offset, max_offset + 1)):
        if abs(d) >= w:
            continue
        if d >= 0:
            vol[:, k, :, d:] = (left[..., d:] * right[..., :w - d]).mean(dim=1)
        else:
            vol[:, k, :, :d] = (left[..., :d] * right[..., -d:]).mean(dim=1)
    return vol


def concat_volume_mul(
    cl: torch.Tensor, cr: torch.Tensor, max_disp: int, att: torch.Tensor | None = None,
    channels_last: bool = False,
) -> torch.Tensor:
    """``build_concat_volume(cl, cr, D)`` times ``att`` (``(B, D, H, W)``)
    broadcast over channels when it is given; ``channels_last`` returns it
    as ``(B, D, H, W, 2C)``."""
    vol = build_concat_volume(cl, cr, max_disp)
    if att is not None:
        vol = (vol.float() * att.float()[:, None]).to(vol.dtype)
    return vol.permute(0, 2, 3, 4, 1).contiguous() if channels_last else vol


def volume_dhw_mul(vol: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor | None,
                   channels_last: bool = False) -> torch.Tensor:
    """``vol (B, C, D, H, W) × (m1 ⊙ m2) (B, D, H, W)`` broadcast over ``C``
    (``m1`` alone when ``m2`` is None); with ``channels_last`` the volume is
    ``(B, D, H, W, C)``."""
    m = m1.float() if m2 is None else m1.float() * m2.float()
    m = m[..., None] if channels_last else m[:, None]
    return (vol.float() * m).to(vol.dtype)
