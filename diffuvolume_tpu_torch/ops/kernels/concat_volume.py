"""Concat cost volume and the per-step attention × noise multiply.

Kernels: ``csrc/concat_volume.cu``.  ``concat_volume`` replaces
``diffuvolume_tpu/ops/pallas/conv3d.py:pack_concat_k`` (plain version
``ops/cost_volume.py:concat_volume_mul``); ``dhw_mul`` replaces
``diffuvolume_tpu/ops/pallas/conv3d.py:packed_dhw_mul_k`` (plain version
``ops/cost_volume.py:volume_dhw_mul``), with one map or two.

The inference pipeline builds the scan-invariant volume once with
``att=None`` and each DDIM step pays only ``dhw_mul(volume, att, noise)``.
Both take ``channels_last=True`` on the folded path (``(B, D, H, W, C)``
volumes for the conv kernels) and write NCDHW on the module path.  The
channels-last concat runs on a plan made in its source (``concat_plan``:
W tile, D range, grid; ``csrc/concat_volume.cu``
``concat_plan_t``), made once a shape and handed to every launch;
``concat_volume_cl_on`` forces another, for timing.
"""

from __future__ import annotations

import functools

import torch

from diffuvolume_tpu_torch.ops.cost_volume import concat_volume_mul, volume_dhw_mul
from diffuvolume_tpu_torch.ops.kernels import _build
from diffuvolume_tpu_torch.parallel.volume_sharding import constrain_volume


def _check_map(m: torch.Tensor, like: torch.Tensor, shape) -> None:
    if tuple(m.shape) != tuple(shape) or m.dtype != like.dtype:
        raise ValueError(
            f"map must be {tuple(shape)} {like.dtype}, got {tuple(m.shape)} {m.dtype}"
        )


def _check_vectors(c: int, t: torch.Tensor, what: str) -> None:
    """The channels-last kernels move 16 bytes of channels a thread."""
    if c * t.element_size() % 16:
        raise ValueError(f"channels-last {what} needs C in whole 16-byte vectors "
                         f"({16 // t.element_size()} channels of {t.dtype}), got {c}")


@functools.lru_cache(maxsize=256)
def concat_plan(b: int, c: int, h: int, w: int, d: int, att: bool, dtype: torch.dtype,
                device: torch.device, force: tuple = (0, 0, 0)) -> _build.Plan:
    """The plan of the channels-last ``concat_volume`` for ``(b, c, h, w)``
    features and ``d`` disparities, with ``att`` or without, on ``device``
    (``_build.CONCAT_PLAN_KEYS``); ``force`` (W tile, D range, blocks) takes
    those, 0 the plan's own."""
    return _build.plan("dv_concat_plan", device, b, c, h, w, d, int(att),
                       _build.DTYPE_CODES[str(dtype)], *force, keys=_build.CONCAT_PLAN_KEYS)


def concat_volume(
    cl: torch.Tensor, cr: torch.Tensor, max_disp: int, att: torch.Tensor | None = None,
    channels_last: bool = False,
) -> torch.Tensor:
    """``(B, C, H, W)`` features → ``(B, 2C, D, H, W)`` concat volume: the left
    features at every ``d``, the right shifted by ``d`` (0 for ``w < d``),
    times ``att`` (``(B, D, H, W)`` in the features' dtype) when it is given.
    Under ``parallel/volume_sharding.py`` this rank's rows: the features
    whole, ``att`` this rank's band.
    ``channels_last`` writes it as ``(B, D, H, W, 2C)``, the folded path's
    layout; on a CUDA tensor it takes C in whole 16-byte vectors (8 bf16 or
    4 float32 channels).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    return _concat(cl, cr, max_disp, att, channels_last, (0, 0, 0))


def concat_volume_cl_on(force: tuple, cl: torch.Tensor, cr: torch.Tensor, max_disp: int,
                        att: torch.Tensor | None = None) -> torch.Tensor:
    """The channels-last ``concat_volume`` on the plan ``force`` gives (see
    ``concat_plan``), for timing plans against each other; counted as
    ``concat_volume``."""
    return _concat(cl, cr, max_disp, att, True, tuple(force))


def _concat(cl, cr, max_disp, att, channels_last, force):
    if cl.device.type == "cpu":
        return concat_volume_mul(cl, cr, max_disp, att, channels_last)
    cl, cr = constrain_volume(cl), constrain_volume(cr)
    if cl.shape != cr.shape or cl.dtype != cr.dtype or cl.dim() != 4:
        raise ValueError("cl/cr must be (B, C, H, W) of one shape and dtype")
    b, c, h, w = cl.shape
    if att is not None:
        _check_map(att, cl, (b, max_disp, h, w))
    _build.check_cuda(cl, cr, *([] if att is None else [att]))
    shape = (b, max_disp, h, w, 2 * c) if channels_last else (b, 2 * c, max_disp, h, w)
    out = torch.empty(shape, dtype=cl.dtype, device=cl.device)
    if out.numel() == 0:
        return out
    args = (cl.data_ptr(), cr.data_ptr(), None if att is None else att.data_ptr(),
            out.data_ptr())
    if channels_last:
        _check_vectors(c, cl, "concat_volume")
        p = concat_plan(b, c, h, w, max_disp, att is not None, cl.dtype, cl.device, force)
        _build.launch("dv_concat_volume_cl", cl, *args, p.ptr, b, c, max_disp, h, w)
    else:
        _build.launch("dv_concat_volume", cl, *args, b, c, max_disp, h, w)
    concat_volume.launches += 1
    return out


def dhw_mul(vol: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor | None,
            channels_last: bool = False) -> torch.Tensor:
    """``vol (B, C, D, H, W) × (m1 ⊙ m2)`` with the ``(B, D, H, W)`` maps
    broadcast over channels, into a new volume (``vol`` is left as it is, so
    the scan-invariant volume serves every step).  ``m2`` may be None: the
    map is then ``m1`` alone (PCW's noise).  With ``channels_last`` the
    volume is ``(B, D, H, W, C)``, C in whole 16-byte vectors on a CUDA
    tensor.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if vol.device.type == "cpu":
        return volume_dhw_mul(vol, m1, m2, channels_last)
    if vol.dim() != 5:
        raise ValueError(f"vol must be 5-D, got {tuple(vol.shape)}")
    if channels_last:
        b, d, h, w, c = vol.shape
    else:
        b, c, d, h, w = vol.shape
    maps = [m1] if m2 is None else [m1, m2]
    for m in maps:
        _check_map(m, vol, (b, d, h, w))
    _build.check_cuda(vol, *maps)
    if channels_last:
        _check_vectors(c, vol, "dhw_mul")
        if vol.data_ptr() % 16:
            raise ValueError("the channels-last volume must be 16-byte aligned")
    out = torch.empty_like(vol)
    _build.launch(
        "dv_dhw_mul_cl" if channels_last else "dv_dhw_mul", vol, vol.data_ptr(),
        m1.data_ptr(), None if m2 is None else m2.data_ptr(), out.data_ptr(), b, c, d * h * w,
    )
    dhw_mul.launches += 1
    return out


concat_volume.launches = 0
dhw_mul.launches = 0
