"""Layout steps between the NCDHW modules and the channels-last conv kernels.

Kernels: ``csrc/layout.cu``.  ``pack`` replaces
``diffuvolume_tpu/ops/pallas/conv3d.py:pack_padded_k`` (NCDHW → NDHWC,
channels zero-filled up to a slot width); ``unpack`` replaces
``unpack_padded_k`` (NDHWC → NCDHW); ``unpack_hwdc`` replaces
``unpack_hwdc_k`` (NDHWC slot → ``(B, H, W, D·co)``, the first ``co``
channels: IGEV's GEV in the geometry pyramid's layout and the classifier's
cost with D minor).  Plain versions: ``pack_plain``, ``unpack_plain``,
``unpack_hwdc_plain``.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.

``pack`` and ``unpack`` run one transposer (``csrc/layout.cu``), a
``(B, M, N)`` matrix into ``(B, N, ldo)`` with columns ``M..ldo`` zero: pack
``M = C, N = S, ldo = c_slot``, unpack ``M = S, N = C, ldo = S`` (S = D·H·W).
``transpose_plan`` reports the plan its source makes for a shape (the
16-byte form where N, ldo and both pointers allow it, else element tiles;
lanes a tile column; grid), made once a shape and handed to every launch;
``pack_on`` / ``unpack_on`` force another, for timing.  ``unpack_hwdc`` of
a one-channel slot (IGEV's cost) runs on the same transposer.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.ops.kernels import _build


def pack_plain(x: torch.Tensor, c_slot: int | None = None) -> torch.Tensor:
    """``(B, C, D, H, W)`` → ``(B, D, H, W, c_slot)``, channels ≥ C zero."""
    y = x.permute(0, 2, 3, 4, 1)
    c = x.shape[1]
    if c_slot is not None and c_slot > c:
        y = F.pad(y, (0, c_slot - c))
    return y.contiguous()


def unpack_plain(x: torch.Tensor) -> torch.Tensor:
    """``(B, D, H, W, C)`` → ``(B, C, D, H, W)``."""
    return x.permute(0, 4, 1, 2, 3).contiguous()


@functools.lru_cache(maxsize=256)
def transpose_plan(b: int, m: int, n: int, ldo: int, dtype: torch.dtype,
                   device: torch.device, aligned: bool = True,
                   force: tuple = (0, 0)) -> _build.Plan:
    """The plan of pack / unpack's transpose of ``(b, m, n)`` into ``(b, n,
    ldo)`` on ``device``, both pointers 16-byte ``aligned`` or not
    (``_build.TRANSPOSE_PLAN_KEYS``); ``force`` (lanes a tile column: 1 the
    element form, 2, 4 or 8 the 16-byte form; blocks) takes those, 0 the
    plan's own."""
    return _build.plan("dv_transpose_plan", device, b, m, n, ldo,
                       _build.DTYPE_CODES[str(dtype)], int(aligned), *force,
                       keys=_build.TRANSPOSE_PLAN_KEYS)


def pack(x: torch.Tensor, c_slot: int | None = None) -> torch.Tensor:
    """NCDHW → NDHWC with ``c_slot ≥ C`` channels (the extra ones zero)."""
    return _pack(x, c_slot, (0, 0))


def pack_on(force: tuple, x: torch.Tensor, c_slot: int | None = None) -> torch.Tensor:
    """``pack`` on the plan ``force`` gives (see ``transpose_plan``), for
    timing; counted as ``pack``."""
    return _pack(x, c_slot, tuple(force))


def _pack(x, c_slot, force):
    c_slot = x.shape[1] if c_slot is None else c_slot
    if x.dim() != 5 or c_slot < x.shape[1]:
        raise ValueError(f"pack takes (B, C, D, H, W) and c_slot ≥ C, got {tuple(x.shape)}, "
                         f"{c_slot}")
    if x.device.type == "cpu":
        return pack_plain(x, c_slot)
    _build.check_cuda(x)
    b, c, d, h, w = x.shape
    out = torch.empty((b, d, h, w, c_slot), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    p = _plan(x, out, b, c, d * h * w, c_slot, force)
    _build.launch("dv_pack", x, x.data_ptr(), out.data_ptr(), p.ptr, b, c, d * h * w, c_slot)
    pack.launches += 1
    return out


def unpack(x: torch.Tensor) -> torch.Tensor:
    """NDHWC → NCDHW."""
    return _unpack(x, (0, 0))


def unpack_on(force: tuple, x: torch.Tensor) -> torch.Tensor:
    """``unpack`` on the plan ``force`` gives (see ``transpose_plan``), for
    timing; counted as ``unpack``."""
    return _unpack(x, tuple(force))


def _unpack(x, force):
    if x.dim() != 5:
        raise ValueError(f"unpack takes (B, D, H, W, C), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return unpack_plain(x)
    _build.check_cuda(x)
    b, d, h, w, c = x.shape
    out = torch.empty((b, c, d, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    s = d * h * w
    p = _plan(x, out, b, s, c, s, force)
    _build.launch("dv_unpack", x, x.data_ptr(), out.data_ptr(), p.ptr, b, c, s)
    unpack.launches += 1
    return out


def _plan(x, out, b, m, n, ldo, force):
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return transpose_plan(b, m, n, ldo, x.dtype, x.device, aligned, force)


def unpack_hwdc_plain(x: torch.Tensor, co: int) -> torch.Tensor:
    """``(B, D, H, W, C_slot)`` → ``(B, H, W, D·co)``, channels ``< co``."""
    b, d, h, w, _ = x.shape
    return x[..., :co].permute(0, 2, 3, 1, 4).reshape(b, h, w, d * co).contiguous()


def unpack_hwdc(x: torch.Tensor, co: int) -> torch.Tensor:
    """Channels-last slot → ``(B, H, W, D·co)`` with its first ``co``
    channels."""
    if x.dim() != 5 or not 0 < co <= x.shape[4]:
        raise ValueError(f"unpack_hwdc takes (B, D, H, W, C) and 0 < co ≤ C, got "
                         f"{tuple(x.shape)}, {co}")
    if x.device.type == "cpu":
        return unpack_hwdc_plain(x, co)
    _build.check_cuda(x)
    b, d, h, w, c_slot = x.shape
    out = torch.empty((b, h, w, d * co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # A one-channel slot is the transposer's (B, D, S) → (B, S, D).
    p = _plan(x, out, b, d, h * w, d, (0, 0)).ptr if c_slot == 1 else None
    _build.launch("dv_unpack_hwdc", x, x.data_ptr(), out.data_ptr(), p, b, d, h * w, c_slot,
                  co)
    unpack_hwdc.launches += 1
    return out


pack.launches = 0
unpack.launches = 0
unpack_hwdc.launches = 0
