"""ConvTranspose3d stride 2, padding 1 with eval BatchNorm folded in,
channels-last: k3 with output padding 1 (the ACV / PCW hourglasses) or k4
with output padding 0 (IGEV's GEV hourglass); the kernel size is the
weight's.

Kernel: ``csrc/conv3d_up.cu`` over ``csrc/conv_hopper.cuh`` (replaces
``diffuvolume_tpu/ops/pallas/conv3d.py:conv3d_fold_up``, both forms).
Plain version: ``conv3d_up_plain``.  Layouts: ``x (B, D, H, W, C)``, weight
``(k, k, k, C, Co)`` in the transposed conv's own tap order (PyTorch's
``(C, Co, k, k, k)`` permuted, not flipped), bias ``(Co,)`` float32,
``post_mul`` ``(B, 2H, 2W, Co)``; the output is ``(B, 2D, 2H, 2W, Co)``.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.ops.kernels import _build
from diffuvolume_tpu_torch.ops.kernels.conv3d_fold import (TC_AUTO, act_code, check_operands,
                                                            finish_plain)


def conv3d_up_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                    residual: torch.Tensor | None = None, act: str | None = None,
                    post_mul: torch.Tensor | None = None) -> torch.Tensor:
    """``act(deconv(x, w) + bias + residual) · post_mul`` in float32 through
    ``F.conv_transpose3d`` (k3: output padding 1; k4: 0), rounded once to
    ``x``'s dtype."""
    y = F.conv_transpose3d(x.float().permute(0, 4, 1, 2, 3), w.float().permute(3, 4, 0, 1, 2),
                           None if bias is None else bias.float(), stride=2, padding=1,
                           output_padding=1 if w.shape[0] == 3 else 0)
    return finish_plain(y.permute(0, 2, 3, 4, 1), residual, act, post_mul, x.dtype)


def conv3d_fold_up(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                   residual: torch.Tensor | None = None, act: str | None = None,
                   post_mul: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-2 transposed conv to double resolution, + bias, + residual
    (the hourglass's redir branch), then ``act`` (None, "relu", "mish",
    "leaky"), then × post_mul; a 3×3×3 or 4×4×4 weight."""
    return _up(x, w, bias, residual, act, post_mul, TC_AUTO)


def conv3d_fold_up_on(tc: int, x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None, residual: torch.Tensor | None = None,
                      act: str | None = None,
                      post_mul: torch.Tensor | None = None) -> torch.Tensor:
    """``conv3d_fold_up`` on tensor-core form ``tc`` (``conv3d_fold.TC_MMA``,
    ``TC_WGMMA``), for timing the forms against each other; counted as
    ``conv3d_fold_up``."""
    return _up(x, w, bias, residual, act, post_mul, tc)


def _up(x, w, bias, residual, act, post_mul, tc):
    ks = w.shape[0]
    if ks not in (3, 4) or w.shape[:3] != (ks, ks, ks):
        raise ValueError(f"conv3d_fold_up takes a 3×3×3 or 4×4×4 kernel, got "
                         f"{tuple(w.shape[:3])}")
    code = act_code(act)
    if x.device.type == "cpu":
        return conv3d_up_plain(x, w, bias, residual, act, post_mul)
    b, d, h, wd, cin = x.shape
    out_shape = (b, 2 * d, 2 * h, 2 * wd, w.shape[4])
    check_operands(x, w, bias, residual, out_shape, "conv3d_fold_up", post_mul)
    if x.dtype == torch.bfloat16 and w.shape[4] % 8:
        raise ValueError(f"conv3d_fold_up: bf16 C_out must be a multiple of 8, got {w.shape[4]}")
    plan = up_plan(x.shape, w.shape[4], ks, x.device, tc) if x.dtype == torch.bfloat16 else None
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    _build.launch("dv_conv3d_up", x, x.data_ptr(), w.data_ptr(),
                  *(None if t is None else t.data_ptr() for t in (bias, residual, post_mul)),
                  out.data_ptr(), None if plan is None else plan.ptr, b, d, h, wd, cin,
                  w.shape[4], ks, code)
    conv3d_fold_up.launches += 1
    return out


conv3d_fold_up.launches = 0


@functools.lru_cache(maxsize=256)
def up_plan(x_shape: tuple, cout: int, ks: int, device: torch.device,
            tc: int = TC_AUTO) -> _build.Plan:
    """The tile plan the bf16 transposed-conv kernel takes for ``x (B, D, H,
    W, C) → C_out`` with a ``ks``-wide kernel on ``device``
    (``_build.PLAN_KEYS``), made once a shape and handed to every launch."""
    b, d, h, w, cin = x_shape
    return _build.plan("dv_conv3d_up_plan", device, b, d, h, w, cin, cout, ks, tc)
