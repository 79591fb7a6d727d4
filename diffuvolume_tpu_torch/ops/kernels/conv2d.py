"""3×3 dilated 2-D convolution with a fused epilogue, channels-last.

Kernel: ``csrc/conv2d_flat.cu`` (bf16: the one-plane member of
``csrc/conv_hopper.cuh``'s stride-1 kernel, the 3×3×3 convs' own, on a tile
plan made once a shape; a plain FMA kernel in float32), replacing
``diffuvolume_tpu/ops/pallas/conv2d.py:conv2d_flat``.  It runs every 3×3
conv of PCWNet's refinement net on the folded path of a bfloat16 model
(``fold_pcw``, ``models/pcw_fold.py``).

Layouts: ``x (B, H, W, C_in)``, ``w (3, 3, C_in, C_out)`` in ``x``'s dtype,
``bias (C_out,)`` float32 or None, ``residual (B, H, W, C_out)`` in ``x``'s
dtype or None; stride 1, padding = dilation.  The result ``(B, H, W,
C_out)`` is ``act(conv + bias + residual)`` in ``x``'s dtype: a float32
accumulator and epilogue (``conv3d_fold``'s: ``act`` None, ``"relu"``,
``"mish"`` or ``"leaky"``), one rounding.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  bf16 input channels
must be a multiple of 8 (16-byte rows): a 146-channel input goes in a
zero-filled 160-channel slot, with zero weights on the fill.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.ops.kernels import _build
from diffuvolume_tpu_torch.ops.kernels.conv3d_fold import TC_AUTO, act_code, finish_plain

# The largest dilation whose staged strip (one kh tap's rows, the tile's
# columns + 2d) fits a block's shared memory at every N tile.
MAX_DILATION = 64


def conv2d_flat_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                      dilation: int = 1, residual: torch.Tensor | None = None,
                      act: str | None = None) -> torch.Tensor:
    """``act(conv(x, w) + bias + residual)`` in float32 through ``F.conv2d``,
    rounded once to ``x``'s dtype; padding and dilation ``dilation``."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 None if bias is None else bias.float(), padding=dilation, dilation=dilation)
    return finish_plain(y.permute(0, 2, 3, 1), residual, act, None, x.dtype)


def _check(x, w, bias, dilation, residual, act) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"conv2d_flat: x (B, H, W, C) and w (3, 3, C, Co) must agree, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not (isinstance(dilation, int) and 1 <= dilation <= MAX_DILATION):
        raise ValueError(f"conv2d_flat: dilation must be an int in [1, {MAX_DILATION}], "
                         f"got {dilation!r}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (w.shape[3],)):
        raise ValueError(f"conv2d_flat: bias must be ({w.shape[3]},) float32")
    out_shape = (*x.shape[:3], w.shape[3])
    if residual is not None and (tuple(residual.shape) != out_shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"conv2d_flat: residual must be {out_shape} {x.dtype}, got "
                         f"{tuple(residual.shape)} {residual.dtype}")
    act_code(act)


def conv2d_flat(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                dilation: int = 1, residual: torch.Tensor | None = None,
                act: str | None = None) -> torch.Tensor:
    """3×3 stride-1 conv with padding and dilation ``dilation``, + bias, +
    residual, ``act``, ``(B, H, W, C) → (B, H, W, Co)``."""
    return _flat(x, w, bias, dilation, residual, act, TC_AUTO)


def conv2d_flat_on(tc: int, x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None, dilation: int = 1,
                   residual: torch.Tensor | None = None,
                   act: str | None = None) -> torch.Tensor:
    """``conv2d_flat`` on tensor-core form ``tc`` (``conv3d_fold.TC_MMA``,
    ``TC_WGMMA``; a bf16 plan without a wgmma form takes mma.sync), for
    timing the forms against each other; counted as ``conv2d_flat``."""
    return _flat(x, w, bias, dilation, residual, act, tc)


def _flat(x, w, bias, dilation, residual, act, tc):
    _check(x, w, bias, dilation, residual, act)
    if x.device.type == "cpu":
        return conv2d_flat_plain(x, w, bias, dilation, residual, act)
    if w.dtype != x.dtype:
        raise TypeError(f"conv2d_flat: w is {w.dtype}, x is {x.dtype}")
    if x.dtype == torch.bfloat16 and x.shape[3] % 8:
        raise ValueError(f"conv2d_flat: bf16 input channels must be a multiple of 8 "
                         f"(zero-fill a slot), got {x.shape[3]}")
    tensors = [t for t in (x, w, bias, residual) if t is not None]
    _build.check_cuda(*tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("conv2d_flat: operands must be 16-byte aligned")
    b, h, wd, cin = x.shape
    plan = flat_plan(x.shape, w.shape[3], dilation, x.device, tc) \
        if x.dtype == torch.bfloat16 else None
    out = torch.empty((b, h, wd, w.shape[3]), dtype=x.dtype, device=x.device)
    _build.launch("dv_conv2d_flat", x, x.data_ptr(), w.data_ptr(),
                  None if bias is None else bias.data_ptr(),
                  None if residual is None else residual.data_ptr(), out.data_ptr(),
                  None if plan is None else plan.ptr, b, h, wd, cin, w.shape[3], dilation,
                  act_code(act))
    conv2d_flat.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def flat_plan(x_shape: tuple, cout: int, dilation: int, device: torch.device,
              tc: int = TC_AUTO) -> _build.Plan:
    """The tile plan the bf16 kernel takes for ``x (B, H, W, C) → C_out`` at
    ``dilation`` on ``device`` (``_build.PLAN_KEYS``; ``kh_a_stage`` 3: a
    stage holds every row the taps read, 1: one kh tap), made once a shape
    and handed to every launch."""
    b, h, w, cin = x_shape
    return _build.plan("dv_conv2d_flat_plan", device, b, h, w, cin, cout, dilation, tc)


conv2d_flat.launches = 0
