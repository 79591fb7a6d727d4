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
"""

from __future__ import annotations

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


def pack(x: torch.Tensor, c_slot: int | None = None) -> torch.Tensor:
    """NCDHW → NDHWC with ``c_slot ≥ C`` channels (the extra ones zero)."""
    c_slot = x.shape[1] if c_slot is None else c_slot
    if x.dim() != 5 or c_slot < x.shape[1]:
        raise ValueError(f"pack takes (B, C, D, H, W) and c_slot ≥ C, got {tuple(x.shape)}, "
                         f"{c_slot}")
    if x.device.type == "cpu":
        return pack_plain(x, c_slot)
    _build.check_cuda(x)
    b, c, d, h, w = x.shape
    out = torch.empty((b, d, h, w, c_slot), dtype=x.dtype, device=x.device)
    _build.launch("dv_pack", x, x.data_ptr(), out.data_ptr(), b, c, d * h * w, c_slot)
    pack.launches += 1
    return out


def unpack(x: torch.Tensor) -> torch.Tensor:
    """NDHWC → NCDHW."""
    if x.dim() != 5:
        raise ValueError(f"unpack takes (B, D, H, W, C), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return unpack_plain(x)
    _build.check_cuda(x)
    b, d, h, w, c = x.shape
    out = torch.empty((b, c, d, h, w), dtype=x.dtype, device=x.device)
    _build.launch("dv_unpack", x, x.data_ptr(), out.data_ptr(), b, c, d * h * w)
    unpack.launches += 1
    return out


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
    _build.launch("dv_unpack_hwdc", x, x.data_ptr(), out.data_ptr(), b, d, h * w, c_slot, co)
    unpack_hwdc.launches += 1
    return out


pack.launches = 0
unpack.launches = 0
unpack_hwdc.launches = 0
