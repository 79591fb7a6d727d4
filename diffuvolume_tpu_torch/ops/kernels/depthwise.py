"""Per-channel dilated (1, 3, 3) stencils on a channels-last volume: the ACV
attention chain's patch convs.

Kernel: ``csrc/depthwise_hw.cu`` (replaces
``diffuvolume_tpu/ops/pallas/conv3d.py:depthwise_hw_p``).  Plain version:
``depthwise_hw_plain`` (``F.conv3d`` with ``groups=C``).  ``depthwise_hw_p2``
applies two stencils in one launch (the attention chain's ``patch`` then
``patch_l123``), the intermediate rounded to the volume's dtype as two
launches round it; plain version ``depthwise_hw_plain2``.
``depthwise_plan`` reports the plan the kernel picks on a device (its W
tile, persistent grid and warps; ``csrc/depthwise_hw.cu`` ``plan``), made
once a shape and handed to every launch; ``depthwise_hw_p_on`` and
``depthwise_hw_p2_on`` force another, for timing.  Layouts: the volume
``(B, D, H, W, C)``, the weights ``(3, 3, C)`` float32, and the dilations a
tuple of C ints, one per channel (checked on the host; the device keeps one
copy per tuple).  The kernel moves 16 bytes of channels a thread, so on a
CUDA tensor C comes in whole 16-byte vectors and each vector has one
dilation.  Zero padding in H and W; no tap reaches across D.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.ops.kernels import _build
from diffuvolume_tpu_torch.utils.spans import H2D, span


def depthwise_hw_plain(x: torch.Tensor, wt: torch.Tensor, dil: tuple[int, ...]) -> torch.Tensor:
    """The stencils in float32 through ``F.conv3d(groups=C)`` on the
    permuted volume, one call per dilation, rounded once to ``x``'s dtype."""
    xf = x.float().permute(0, 4, 1, 2, 3)
    out = torch.zeros_like(xf)
    for d in sorted(set(dil)):
        idx = torch.tensor([c for c, v in enumerate(dil) if v == d], device=x.device)
        k = wt.float()[:, :, idx].permute(2, 0, 1)[:, None, None]  # (n, 1, 1, 3, 3)
        out[:, idx] = F.conv3d(xf[:, idx], k, padding=(0, d, d), dilation=(1, d, d),
                               groups=len(idx))
    return out.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def depthwise_hw_plain2(x: torch.Tensor, wt1: torch.Tensor, dil1: tuple[int, ...],
                        wt2: torch.Tensor, dil2: tuple[int, ...]) -> torch.Tensor:
    """Two ``depthwise_hw_plain`` calls, the first's result in ``x``'s
    dtype."""
    return depthwise_hw_plain(depthwise_hw_plain(x, wt1, dil1), wt2, dil2)


@functools.lru_cache(maxsize=64)
def depthwise_plan(planes: int, h: int, w: int, c: int, dtype: torch.dtype, dm1: int, dm2: int,
                   device: torch.device, tile: tuple[int, int, int] = (0, 0, 0)) -> _build.Plan:
    """The plan of the stencil kernel for ``planes`` (B·D) planes of ``(H, W,
    C)`` on ``device`` (``_build.DW_PLAN_KEYS``): one stencil of largest
    dilation ``dm1`` (``dm2`` 0) or the fused pair (``dm2`` the second's).
    ``tile`` (W positions, warps a channel vector, blocks) forces a plan, 0
    the kernel's own choice of each."""
    return _build.plan("dv_depthwise_plan", device, planes, h, w, c, dm1, dm2,
                       _build.DTYPE_CODES[str(dtype)], *tile, keys=_build.DW_PLAN_KEYS)


@functools.lru_cache(maxsize=32)
def _device_dil(dil: tuple[int, ...], device: torch.device) -> torch.Tensor:
    with span(H2D):
        return torch.tensor(dil, dtype=torch.int32, device=device)


def _check(x: torch.Tensor, wt: torch.Tensor, dil) -> tuple[int, ...]:
    dil = tuple(int(v) for v in dil)
    if x.dim() != 5 or tuple(wt.shape) != (3, 3, x.shape[4]) or len(dil) != x.shape[4]:
        raise ValueError(f"x (B, D, H, W, C), wt (3, 3, C) and C dilations must agree, got "
                         f"{tuple(x.shape)}, {tuple(wt.shape)}, {len(dil)}")
    if min(dil) < 1:
        raise ValueError(f"dilations must be positive, got {dil}")
    return dil


def _check_cuda(x: torch.Tensor, *pairs) -> None:
    for wt, dil in pairs:
        if wt.dtype != torch.float32:
            raise TypeError(f"wt must be float32, got {wt.dtype}")
        _build.check_cuda(x, wt)
    c = x.shape[4]
    vec = 16 // x.element_size()
    for _, dil in pairs:
        if c % vec or any(len(set(dil[i:i + vec])) > 1 for i in range(0, c, vec)):
            raise ValueError(f"C must be whole 16-byte vectors ({vec} channels of {x.dtype}) "
                             f"with one dilation each, got C={c}, dil={dil}")
    if x.data_ptr() % 16 or any(wt.data_ptr() % 16 for wt, _ in pairs):
        raise ValueError("the volume and the weights must be 16-byte aligned")


def depthwise_hw_p(x: torch.Tensor, wt: torch.Tensor, dil: tuple[int, ...]) -> torch.Tensor:
    """``out[..., h, w, c] = Σ_{i,j} wt[i, j, c] · x[..., h + (i−1)·dil[c],
    w + (j−1)·dil[c], c]``, zero outside the H×W plane; ``(B, D, H, W, C)``
    in and out."""
    return _one(x, wt, dil, (0, 0, 0))


def depthwise_hw_p_on(tile: tuple[int, int, int], x: torch.Tensor, wt: torch.Tensor,
                      dil: tuple[int, ...]) -> torch.Tensor:
    """``depthwise_hw_p`` on ``tile`` (W positions, warps a channel vector,
    blocks; 0 the plan's own), for timing plans against each other; counted
    as ``depthwise_hw_p``."""
    return _one(x, wt, dil, tuple(tile))


def _one(x, wt, dil, tile):
    dil = _check(x, wt, dil)
    if x.device.type == "cpu":
        return depthwise_hw_plain(x, wt, dil)
    _check_cuda(x, (wt, dil))
    b, d, h, w, c = x.shape
    p = depthwise_plan(b * d, h, w, c, x.dtype, max(dil), 0, x.device, tile)
    out = torch.empty_like(x)
    _build.launch("dv_depthwise_hw", x, x.data_ptr(), wt.data_ptr(),
                  _device_dil(dil, x.device).data_ptr(), out.data_ptr(), p.ptr, b, d, h, w, c,
                  max(dil))
    depthwise_hw_p.launches += 1
    return out


def depthwise_hw_p2(x: torch.Tensor, wt1: torch.Tensor, dil1: tuple[int, ...],
                    wt2: torch.Tensor, dil2: tuple[int, ...]) -> torch.Tensor:
    """``depthwise_hw_p(depthwise_hw_p(x, wt1, dil1), wt2, dil2)`` in one
    launch: the same arithmetic, the intermediate rounded to ``x``'s dtype."""
    return _pair(x, wt1, dil1, wt2, dil2, (0, 0, 0))


def depthwise_hw_p2_on(tile: tuple[int, int, int], x: torch.Tensor, wt1: torch.Tensor,
                       dil1: tuple[int, ...], wt2: torch.Tensor,
                       dil2: tuple[int, ...]) -> torch.Tensor:
    """``depthwise_hw_p2`` on ``tile``, as ``depthwise_hw_p_on``; counted as
    ``depthwise_hw_p2``."""
    return _pair(x, wt1, dil1, wt2, dil2, tuple(tile))


def _pair(x, wt1, dil1, wt2, dil2, tile):
    dil1, dil2 = _check(x, wt1, dil1), _check(x, wt2, dil2)
    if x.device.type == "cpu":
        return depthwise_hw_plain2(x, wt1, dil1, wt2, dil2)
    _check_cuda(x, (wt1, dil1), (wt2, dil2))
    b, d, h, w, c = x.shape
    p = depthwise_plan(b * d, h, w, c, x.dtype, max(dil1), max(dil2), x.device, tile)
    out = torch.empty_like(x)
    _build.launch("dv_depthwise_hw2", x, x.data_ptr(), wt1.data_ptr(),
                  _device_dil(dil1, x.device).data_ptr(), wt2.data_ptr(),
                  _device_dil(dil2, x.device).data_ptr(), out.data_ptr(), p.ptr, b, d, h, w, c,
                  max(dil1), max(dil2))
    depthwise_hw_p2.launches += 1
    return out


depthwise_hw_p.launches = 0
depthwise_hw_p2.launches = 0
