"""The reference in a lower precision than the configuration states: the
control that the benchmark's comparison has to fail.

``lower_precision(net, "float8")`` rounds every convolution's (2-D or
3-D, transposed or not) and linear layer's weight once, and its input at
every call, to float8 e4m3 with one scale a tensor (the largest magnitude
to 448), as a float8 GEMM takes its operands; the products and sums
stay float32.  ``"bfloat16"`` rounds the same operands to bfloat16: the
rounding that the evaluation's dtype brings, against which the program's
gap to the float32 reference is measured.  Everything else (the volumes'
construction, the softmax heads, the sampler) is unchanged.
"""

from __future__ import annotations

import torch
import torch.nn as nn

FP8_MAX = 448.0


def round_to(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    if kind != "float8":
        raise ValueError(f"no lower precision named {kind!r}")
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


@torch.no_grad()
def lower_precision(net: nn.Module, kind: str) -> nn.Module:
    """Round ``net``'s conv and linear operands to ``kind``, in place."""
    layers = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d, nn.Linear)
    for m in net.modules():
        if isinstance(m, layers):
            m.weight.copy_(round_to(m.weight, kind))
            m.register_forward_pre_hook(lambda _m, args: (round_to(args[0], kind), *args[1:]))
    return net
