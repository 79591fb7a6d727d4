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
correlation) has no kernel.  The rest of the JAX module's builders, which
no path of either package calls (``build_gwc_volume_norm``,
``groupwise_correlation_4d``, ``build_gwc_volume_unfold``,
``build_gwc_volume_v1``, ``build_correlation_volume_ones``,
``patch_aggregation``), keep its channels-last signatures: features ``(B,
H, W, C)``, volumes ``(B, D, H, W, G)``.

The multiplies are taken in float32 and rounded once to the volume's dtype,
in the order the kernels take them, so a kernel and its plain version agree
exactly on the same inputs.

Under ``parallel/volume_sharding.py`` ``build_gwc_volume`` and
``build_concat_volume`` (and the kernels, ``ops/kernels/``) build only this
rank's band of rows: a volume row depends only on the same feature row, so
they slice the features' rows first (the JAX package constrains the whole
volume's, ``cost_volume.py:68`` and ``:108``).
"""

from __future__ import annotations

import torch

from diffuvolume_tpu_torch.parallel.volume_sharding import constrain_volume


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
    ``w ≥ d``, zero elsewhere; this rank's rows under ``volume_sharding``.
    """
    left, right = constrain_volume(left), constrain_volume(right)
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
    right[:, :, h, w-d]`` where ``w ≥ d``, zero elsewhere; this rank's rows
    under ``volume_sharding``.
    """
    left, right = constrain_volume(left), constrain_volume(right)
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


def _gwc_cl(left: torch.Tensor, right: torch.Tensor, max_disp: int, num_groups: int,
            stride: int = 1) -> torch.Tensor:
    """``(B, H, W, C)`` features → the channels-last group-wise volume
    ``(B, D, H, W, G)``, plane ``d`` at shift ``stride·d``."""
    lf, rf = left.permute(0, 3, 1, 2), right.permute(0, 3, 1, 2)
    if stride == 1:
        return build_gwc_volume(lf, rf, max_disp, num_groups).permute(0, 2, 3, 4, 1)
    b, _, h, w = lf.shape
    vol = left.new_zeros((b, num_groups, max_disp, h, w))
    for d in range(max_disp):
        s = stride * d
        if s >= w:
            break
        vol[:, :, d, :, s:] = groupwise_correlation(lf[..., s:], rf[..., :w - s], num_groups)
    return vol.permute(0, 2, 3, 4, 1)


def build_gwc_volume_norm(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                          num_groups: int, cosine: bool = False) -> torch.Tensor:
    """The group-wise volume of L2-normalised features, channels-last:
    each group's channels divided by their norm + 1e-5
    (``groupwise_correlation_norm``, SceneFlow ``submodule.py:240-250``), or
    with ``cosine`` the whole feature vector (``build_gwc_volume_cos``,
    ``:194-206``)."""
    def norm(f):
        if cosine:
            return f / (f.pow(2).sum(-1, keepdim=True).sqrt() + 1e-5)
        g = f.reshape(*f.shape[:-1], num_groups, f.shape[-1] // num_groups)
        return (g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-5)).reshape(f.shape)

    return _gwc_cl(norm(left), norm(right), max_disp, num_groups)


def groupwise_correlation_4d(fea1: torch.Tensor, fea2: torch.Tensor,
                             num_groups: int) -> torch.Tensor:
    """Per-group mean of ``fea1·fea2`` over two channels-last volumes ``(B,
    D, H, W, C)`` → ``(B, D, H, W, G)`` (``groupwise_correlation_4D``,
    SceneFlow ``submodule.py:534-540``)."""
    *lead, c = fea1.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    prod = (fea1 * fea2).reshape(*lead, num_groups, c // num_groups)
    return prod.mean(dim=-1)


def build_gwc_volume_unfold(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                            num_groups: int) -> torch.Tensor:
    """The unfold form's group-wise volume (``Build_gwc_volume_unfold``,
    ``submodule.py:262-277``): the group's channel **sum**, ``C/G`` times
    the channels-last ``build_gwc_volume``."""
    return _gwc_cl(left, right, max_disp, num_groups) * (left.shape[-1] // num_groups)


def build_gwc_volume_v1(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                        num_groups: int) -> torch.Tensor:
    """The double-stride group-wise volume (``build_gwc_volume_v1``,
    ``submodule.py:281-293``): plane ``d`` correlates at shift ``2d``, zero
    where ``w < 2d``; channels-last."""
    return _gwc_cl(left, right, max_disp, num_groups, stride=2)


def build_correlation_volume_ones(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                                  num_groups: int) -> torch.Tensor:
    """The channels-last group-wise volume with ones where ``w < d``
    (``build_correlation_volume``, ``submodule.py:494-505``, a buffer of
    ``new_ones``)."""
    vol = _gwc_cl(left, right, max_disp, num_groups)
    w = left.shape[2]
    background = (torch.arange(w, device=left.device)[None, :]
                  < torch.arange(max_disp, device=left.device)[:, None])
    return torch.where(background[None, :, None, :, None], torch.ones_like(vol), vol)


def patch_aggregation(volume: torch.Tensor, patch_weight: torch.Tensor) -> torch.Tensor:
    """``patch_weight · boxsum₃ₓ₃(volume)`` over (H, W), zero padded, for
    channels-last ``(B, D, H, W, G)`` volumes (``patch_aggregation``,
    ``submodule.py:252-259``)."""
    h, w = volume.shape[2:4]
    padded = torch.nn.functional.pad(volume, (0, 0, 1, 1, 1, 1))
    box = sum(padded[:, :, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))
    return patch_weight * box
