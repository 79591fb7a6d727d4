"""3-D convolution with eval BatchNorm folded into its weights, channels-last.

Kernel: ``csrc/conv3d_fold.cu`` (implicit GEMM on the bf16 tensor cores; a
plain FMA kernel in float32).  One kernel serves four TPU kernels of
``diffuvolume_tpu/ops/pallas/conv3d.py``; each has its own wrapper here and
its own launch count:

* ``conv3d_fold_p``  ← ``conv3d_fold_p`` (3×3×3, stride 1, + residual)
* ``conv3d_fold_x2`` ← ``conv3d_fold_x2`` (the same conv at the wide entries:
  C_in 64, or the 40-channel patch volume in a 48-channel slot)
* ``conv3d_fold_s2`` ← ``conv3d_fold_s2`` (3×3×3, stride 2)
* ``conv1x1_fold_p`` ← ``conv1x1_fold_p`` (1×1×1)

Plain version: ``conv3d_fold_plain``.  Layouts: activations ``(B, D, H, W,
C)``, weights ``(k, k, k, C_in, C_out)`` in the model's dtype, bias
``(C_out,)`` float32.  The epilogue's activation ``act`` is ``None``,
``"relu"`` (ACVNet) or ``"mish"`` (PCWNet), taken in float32 before the one
rounding.  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.ops.kernels import _build


# The kernels' activation codes (csrc/conv_igemm.cuh Act).
ACT_CODES = {None: 0, "relu": 1, "mish": 2}


def apply_act(y: torch.Tensor, act: str | None) -> torch.Tensor:
    """The epilogue's activation on a float32 tensor.  Mish is taken as the
    kernels take it: ``x·((1+eˣ)² − 1)/((1+eˣ)² + 1)``, ``x`` itself above
    20."""
    if act is None:
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "mish":
        t = (1.0 + torch.exp(y.clamp(max=20.0))) ** 2
        return torch.where(y > 20.0, y, y * (t - 1.0) / (t + 1.0))
    raise ValueError(f"act must be one of {list(ACT_CODES)}, got {act!r}")


def conv3d_fold_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                      stride: int = 1, residual: torch.Tensor | None = None,
                      act: str | None = None) -> torch.Tensor:
    """``act(conv(x, w) + bias + residual)`` in float32 through ``F.conv3d``,
    rounded once to ``x``'s dtype; zero padding ``(k - 1) / 2``."""
    k = w.shape[0]
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2),
                 None if bias is None else bias.float(), stride=stride, padding=(k - 1) // 2)
    y = y.permute(0, 2, 3, 4, 1)
    if residual is not None:
        y = y + residual.float()
    return apply_act(y, act).to(x.dtype).contiguous()


def check_operands(x, w, bias, residual, out_shape, what: str) -> None:
    """Shapes, dtypes, devices, contiguity and alignment of a folded conv's
    operands; raise on anything the kernels do not take."""
    if x.dim() != 5 or w.dim() != 5 or w.shape[3] != x.shape[4]:
        raise ValueError(f"{what}: x (B, D, H, W, C) and w (k, k, k, C, Co) must agree, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"{what}: w is {w.dtype}, x is {x.dtype}")
    if x.dtype == torch.bfloat16 and x.shape[4] % 16:
        raise ValueError(f"{what}: bf16 input channels must be a multiple of 16 (zero-fill the "
                         f"slot), got {x.shape[4]}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (w.shape[4],)):
        raise ValueError(f"{what}: bias must be ({w.shape[4]},) float32")
    if residual is not None and (tuple(residual.shape) != tuple(out_shape)
                                 or residual.dtype != x.dtype):
        raise ValueError(f"{what}: residual must be {tuple(out_shape)} {x.dtype}, got "
                         f"{tuple(residual.shape)} {residual.dtype}")
    tensors = [t for t in (x, w, bias, residual) if t is not None]
    _build.check_cuda(*tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: operands must be 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def act_code(act: str | None) -> int:
    if act not in ACT_CODES:
        raise ValueError(f"act must be one of {list(ACT_CODES)}, got {act!r}")
    return ACT_CODES[act]


def _fold(x, w, bias, stride, residual, act, ks, wrapper):
    if w.shape[:3] != (ks, ks, ks):
        raise ValueError(f"{wrapper.__name__} takes a {ks}×{ks}×{ks} kernel, got "
                         f"{tuple(w.shape[:3])}")
    code = act_code(act)
    if x.device.type == "cpu":
        return conv3d_fold_plain(x, w, bias, stride, residual, act)
    b, d, h, wd, cin = x.shape
    pad = (ks - 1) // 2
    osz = [(n + 2 * pad - ks) // stride + 1 for n in (d, h, wd)]
    out_shape = (b, *osz, w.shape[4])
    check_operands(x, w, bias, residual, out_shape, wrapper.__name__)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    _build.launch("dv_conv3d_fold", x, x.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(residual),
                  out.data_ptr(), b, d, h, wd, cin, w.shape[4], ks, stride, code)
    wrapper.launches += 1
    return out


def conv3d_fold_p(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                  residual: torch.Tensor | None = None, act: str | None = None) -> torch.Tensor:
    """3×3×3 stride-1 conv, ``(B, D, H, W, C) → (B, D, H, W, Co)``."""
    return _fold(x, w, bias, 1, residual, act, 3, conv3d_fold_p)


def conv3d_fold_x2(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                   act: str | None = None) -> torch.Tensor:
    """The wide entry conv (C_in 64, or 48 with zero-filled slots → 32);
    the same kernel as ``conv3d_fold_p``, counted apart."""
    return _fold(x, w, bias, 1, None, act, 3, conv3d_fold_x2)


def conv3d_fold_s2(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                   act: str | None = None) -> torch.Tensor:
    """3×3×3 stride-2 conv, ``(B, D, H, W, C) → (B, ⌈D/2⌉, ⌈H/2⌉, ⌈W/2⌉, Co)``."""
    return _fold(x, w, bias, 2, None, act, 3, conv3d_fold_s2)


def conv1x1_fold_p(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                   act: str | None = None) -> torch.Tensor:
    """1×1×1 conv, ``(B, D, H, W, C) → (B, D, H, W, Co)``."""
    return _fold(x, w, bias, 1, None, act, 1, conv1x1_fold_p)


conv3d_fold_p.launches = 0
conv3d_fold_x2.launches = 0
conv3d_fold_s2.launches = 0
conv1x1_fold_p.launches = 0
