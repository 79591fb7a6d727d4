"""Per-channel dilated (1, 3, 3) stencils on a channels-last volume: the ACV
attention chain's patch convs.

Kernel: ``csrc/depthwise_hw.cu`` (replaces
``diffuvolume_tpu/ops/pallas/conv3d.py:depthwise_hw_p``).  Plain version:
``depthwise_hw_plain`` (``F.conv3d`` with ``groups=C``).  Layouts: the volume
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


@functools.lru_cache(maxsize=32)
def _device_dil(dil: tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(dil, dtype=torch.int32, device=device)


def depthwise_hw_p(x: torch.Tensor, wt: torch.Tensor, dil: tuple[int, ...]) -> torch.Tensor:
    """``out[..., h, w, c] = Σ_{i,j} wt[i, j, c] · x[..., h + (i−1)·dil[c],
    w + (j−1)·dil[c], c]``, zero outside the H×W plane; ``(B, D, H, W, C)``
    in and out."""
    dil = tuple(int(v) for v in dil)
    if x.dim() != 5 or tuple(wt.shape) != (3, 3, x.shape[4]) or len(dil) != x.shape[4]:
        raise ValueError(f"x (B, D, H, W, C), wt (3, 3, C) and C dilations must agree, got "
                         f"{tuple(x.shape)}, {tuple(wt.shape)}, {len(dil)}")
    if min(dil) < 1:
        raise ValueError(f"dilations must be positive, got {dil}")
    if x.device.type == "cpu":
        return depthwise_hw_plain(x, wt, dil)
    if wt.dtype != torch.float32:
        raise TypeError(f"wt must be float32, got {wt.dtype}")
    _build.check_cuda(x, wt)
    b, d, h, w, c = x.shape
    vec = 16 // x.element_size()
    if c % vec or any(len(set(dil[i:i + vec])) > 1 for i in range(0, c, vec)):
        raise ValueError(f"C must be whole 16-byte vectors ({vec} channels of {x.dtype}) with "
                         f"one dilation each, got C={c}, dil={dil}")
    if x.data_ptr() % 16:
        raise ValueError("the volume must be 16-byte aligned")
    out = torch.empty_like(x)
    _build.launch("dv_depthwise_hw", x, x.data_ptr(), wt.data_ptr(),
                  _device_dil(dil, x.device).data_ptr(), out.data_ptr(), b, d, h, w, c)
    depthwise_hw_p.launches += 1
    return out


depthwise_hw_p.launches = 0
