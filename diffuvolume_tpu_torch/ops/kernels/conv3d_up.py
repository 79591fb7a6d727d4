"""ConvTranspose3d k3 s2 p1 op1 with eval BatchNorm folded in, channels-last.

Kernel: ``csrc/conv3d_up.cu`` (replaces
``diffuvolume_tpu/ops/pallas/conv3d.py:conv3d_fold_up``, its k3 form).
Plain version: ``conv3d_up_plain``.  Layouts: ``x (B, D, H, W, C)``, weight
``(3, 3, 3, C, Co)`` in the transposed conv's own tap order (PyTorch's
``(C, Co, 3, 3, 3)`` permuted, not flipped), bias ``(Co,)`` float32; the
output is ``(B, 2D, 2H, 2W, Co)``.  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.ops.kernels import _build
from diffuvolume_tpu_torch.ops.kernels.conv3d_fold import act_code, apply_act, check_operands


def conv3d_up_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                    residual: torch.Tensor | None = None, act: str | None = None) -> torch.Tensor:
    """``act(deconv(x, w) + bias + residual)`` in float32 through
    ``F.conv_transpose3d``, rounded once to ``x``'s dtype."""
    y = F.conv_transpose3d(x.float().permute(0, 4, 1, 2, 3), w.float().permute(3, 4, 0, 1, 2),
                           None if bias is None else bias.float(), stride=2, padding=1,
                           output_padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if residual is not None:
        y = y + residual.float()
    return apply_act(y, act).to(x.dtype).contiguous()


def conv3d_fold_up(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                   residual: torch.Tensor | None = None, act: str | None = None) -> torch.Tensor:
    """Stride-2 transposed conv to double resolution, + bias, + residual
    (the hourglass's redir branch), then ``act`` (None, "relu", "mish")."""
    if w.shape[:3] != (3, 3, 3):
        raise ValueError(f"conv3d_fold_up takes a 3×3×3 kernel, got {tuple(w.shape[:3])}")
    code = act_code(act)
    if x.device.type == "cpu":
        return conv3d_up_plain(x, w, bias, residual, act)
    b, d, h, wd, cin = x.shape
    out_shape = (b, 2 * d, 2 * h, 2 * wd, w.shape[4])
    check_operands(x, w, bias, residual, out_shape, "conv3d_fold_up")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    _build.launch("dv_conv3d_up", x, x.data_ptr(), w.data_ptr(),
                  None if bias is None else bias.data_ptr(),
                  None if residual is None else residual.data_ptr(), out.data_ptr(),
                  b, d, h, wd, cin, w.shape[4], code)
    conv3d_fold_up.launches += 1
    return out


conv3d_fold_up.launches = 0
