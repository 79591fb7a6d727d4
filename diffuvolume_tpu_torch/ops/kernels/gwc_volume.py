"""Group-wise correlation volumes.

Kernels: ``csrc/gwc_volume.cu``.

* ``gwc_volume`` replaces ``diffuvolume_tpu/ops/pallas/gwc_volume.py:
  gwc_volume_pallas``: the NCDHW volume of the ACV and IGEV module paths.
  Plain version: ``ops/cost_volume.py:build_gwc_volume``.  ``gwc_plan``
  reports the kernel's plan on a device (W positions and disparities a
  thread's item, the 16-byte or element form, items, threads, grid, blocks
  an SM; ``csrc/gwc_volume.cu`` ``gwc_plan``), made once a shape and handed
  to every launch; ``gwc_volume_on`` forces another item or block size, for
  timing.
* ``gwc_volume_packed`` replaces ``gwc_volume_packed`` of the same file: the
  volume written straight into the channels-last slot that the folded conv
  chain reads, with the concat halves fused in where a model has them (the
  ACV attention chain's 40 channels in a 48 slot; PCW's 40 + 12 + 12 in 64,
  or its 40 alone in 48 without the concat volume).  Plain version:
  ``ops/cost_volume.py:gwc_volume_slot``.  ``slot_plan`` reports the tile
  the kernel's plan picks on a device (W positions and disparities a block,
  threads, shared memory; ``csrc/gwc_volume.cu`` ``slot_plan``), made once a
  shape and handed to every launch; ``gwc_volume_packed_on`` forces another
  tile, for timing.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import functools

import torch

from diffuvolume_tpu_torch.ops.cost_volume import build_gwc_volume, gwc_volume_slot, slot_width
from diffuvolume_tpu_torch.ops.kernels import _build
from diffuvolume_tpu_torch.parallel.volume_sharding import constrain_volume

# cpg values the row-16 kernel is compiled for (csrc/gwc_volume.cu launch_slot).
SLOT_CPG = (1, 2, 3, 4, 6, 8, 12, 16)


@functools.lru_cache(maxsize=256)
def gwc_plan(b: int, c: int, h: int, w: int, groups: int, d: int, dtype: torch.dtype,
             device: torch.device, aligned: bool = True,
             tile: tuple[int, int] = (0, 0)) -> _build.Plan:
    """The plan of ``gwc_volume`` for ``(b, c, h, w)`` features in ``groups``
    groups and ``d`` disparities on ``device`` (``_build.GWC_PLAN_KEYS``);
    ``aligned``: both features 16-byte aligned; ``tile`` (disparities an
    item, threads a block) forces those, 0 the plan's own."""
    return _build.plan("dv_gwc_plan", device, b, c, h, w, groups, d,
                       _build.DTYPE_CODES[str(dtype)], int(aligned), *tile,
                       keys=_build.GWC_PLAN_KEYS)


@functools.lru_cache(maxsize=256)
def slot_plan(b: int, c: int, cc: int, h: int, w: int, d: int, slot: int, dtype: torch.dtype,
              device: torch.device, tile: tuple[int, int] = (0, 0)) -> _build.Plan:
    """The plan of ``gwc_volume_packed`` for ``(b, c, h, w)`` features, ``cc``
    concat channels, ``d`` disparities into a ``slot``-wide volume on
    ``device`` (``_build.SLOT_PLAN_KEYS``); ``tile`` (W positions,
    disparities a block) forces a tile, 0 the plan's own."""
    return _build.plan("dv_gwc_slot_plan", device, b, c, cc, h, w, d, slot,
                       _build.DTYPE_CODES[str(dtype)], *tile, keys=_build.SLOT_PLAN_KEYS)


def gwc_volume(
    left: torch.Tensor, right: torch.Tensor, max_disp: int, num_groups: int
) -> torch.Tensor:
    """``(B, C, H, W)`` features → ``(B, G, D, H, W)`` volume,
    ``vol[b,g,d,h,w] = mean_{c∈g} left[b,c,h,w]·right[b,c,h,w-d]`` (0 for
    ``w < d``), accumulated in float32, in the features' dtype; this rank's
    rows under ``parallel/volume_sharding.py``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    return _ncdhw(left, right, max_disp, num_groups, (0, 0))


def gwc_volume_on(tile: tuple[int, int], left: torch.Tensor, right: torch.Tensor,
                  max_disp: int, num_groups: int) -> torch.Tensor:
    """``gwc_volume`` on ``tile`` (disparities an item, threads a block; 0
    the plan's own), for timing plans against each other; counted as
    ``gwc_volume``."""
    return _ncdhw(left, right, max_disp, num_groups, tuple(tile))


def _ncdhw(left, right, max_disp, num_groups, tile):
    if left.device.type == "cpu":
        return build_gwc_volume(left, right, max_disp, num_groups)
    left, right = constrain_volume(left), constrain_volume(right)
    if left.shape != right.shape or left.dtype != right.dtype or left.dim() != 4:
        raise ValueError("left/right must be (B, C, H, W) of one shape and dtype")
    b, c, h, w = left.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    _build.check_cuda(left, right)
    aligned = left.data_ptr() % 16 == 0 and right.data_ptr() % 16 == 0
    p = gwc_plan(b, c, h, w, num_groups, max_disp, left.dtype, left.device, aligned, tile)
    out = torch.empty((b, num_groups, max_disp, h, w), dtype=left.dtype,
                      device=left.device)
    _build.launch(
        "dv_gwc_volume", left, left.data_ptr(), right.data_ptr(), out.data_ptr(), p.ptr,
        b, c, h, w, num_groups, max_disp,
    )
    gwc_volume.launches += 1
    return out


def gwc_volume_packed(
    left: torch.Tensor, right: torch.Tensor, max_disp: int, num_groups: int,
    slot: int | None = None, cat_l: torch.Tensor | None = None,
    cat_r: torch.Tensor | None = None, mask_ref: bool = False,
) -> torch.Tensor:
    """``(B, C, H, W)`` features (and ``(B, cc, H, W)`` concat features) →
    ``(B, D, H, W, slot)``: per ``(d, h, w)`` the ``G`` group means of
    ``left·right(w − d)`` (0 for ``w < d``), then ``cat_l`` (0 for ``w < d``
    when ``mask_ref``), then ``cat_r(w − d)`` (0 for ``w < d``), then zeros.
    ``slot`` defaults to the smallest multiple of 16 that holds ``G + 2cc``.
    This rank's rows under ``parallel/volume_sharding.py`` (at the
    features' level: PCW's four scales each take their scale's band).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    return _slot(left, right, max_disp, num_groups, slot, cat_l, cat_r, mask_ref, (0, 0))


def gwc_volume_packed_on(
    tile: tuple[int, int], left: torch.Tensor, right: torch.Tensor, max_disp: int,
    num_groups: int, slot: int | None = None, cat_l: torch.Tensor | None = None,
    cat_r: torch.Tensor | None = None, mask_ref: bool = False,
) -> torch.Tensor:
    """``gwc_volume_packed`` on ``tile`` (W positions, disparities a block;
    0 the plan's own), for timing tiles against each other; counted as
    ``gwc_volume_packed``."""
    return _slot(left, right, max_disp, num_groups, slot, cat_l, cat_r, mask_ref, tuple(tile))


def _slot(left, right, max_disp, num_groups, slot, cat_l, cat_r, mask_ref, tile):
    if (cat_l is None) != (cat_r is None):
        raise ValueError("give both concat halves or neither")
    cc = 0 if cat_l is None else cat_l.shape[1]
    slot = slot_width(num_groups + 2 * cc) if slot is None else slot
    if left.device.type == "cpu":
        return gwc_volume_slot(left, right, max_disp, num_groups, slot, cat_l, cat_r, mask_ref)
    left, right = constrain_volume(left), constrain_volume(right)
    if cc:
        cat_l, cat_r = constrain_volume(cat_l), constrain_volume(cat_r)
    if left.shape != right.shape or left.dtype != right.dtype or left.dim() != 4:
        raise ValueError("left/right must be (B, C, H, W) of one shape and dtype")
    b, c, h, w = left.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if c // num_groups not in SLOT_CPG:
        raise ValueError(f"the kernel is compiled for {SLOT_CPG} channels a group, "
                         f"got {c // num_groups}")
    if slot % 16 or slot < num_groups + 2 * cc:
        raise ValueError(f"slot must be a multiple of 16 holding {num_groups + 2 * cc} "
                         f"channels, got {slot}")
    cats = []
    if cc:
        for t in (cat_l, cat_r):
            if tuple(t.shape) != (b, cc, h, w) or t.dtype != left.dtype:
                raise ValueError(f"concat features must be {(b, cc, h, w)} {left.dtype}, "
                                 f"got {tuple(t.shape)} {t.dtype}")
        cats = [cat_l, cat_r]
    _build.check_cuda(left, right, *cats)
    p = slot_plan(b, c, cc, h, w, max_disp, slot, left.dtype, left.device, tile)
    out = torch.empty((b, max_disp, h, w, slot), dtype=left.dtype, device=left.device)
    _build.launch(
        "dv_gwc_volume_slot", left, left.data_ptr(), right.data_ptr(),
        cat_l.data_ptr() if cc else None, cat_r.data_ptr() if cc else None, out.data_ptr(),
        p.ptr, b, c, cc, h, w, num_groups, max_disp, slot, int(mask_ref),
    )
    gwc_volume_packed.launches += 1
    return out


gwc_volume.launches = 0
gwc_volume_packed.launches = 0
