"""The work of a pair or a step, counted over the frozen reference.

The counts come from the reference at the cell's shapes on PyTorch's
``meta`` device (shapes only, no data, no memory), so they do not depend on
what implements a layer in the measured program:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total, matmuls
  and convolutions (with their backward when the call runs one), a
  multiply-add counted as 2;
* ``conv3d``: every dense 3-D convolution and transposed convolution
  (groups 1; the grouped patch stencils are another kernel's work) as
  ``(operations, bytes)``: operations 2·MACs, bytes the input, the weight
  and the output each once in the configuration's dtype.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

_CONV = torch.ops.aten.convolution.default


class _Conv3dWork(TorchDispatchMode):
    def __init__(self, itemsize: int):
        super().__init__()
        self.itemsize = itemsize
        self.calls: list[tuple[float, float]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is _CONV:
            x, w, transposed, groups = args[0], args[1], args[6], args[8]
            if x.dim() == 5 and groups == 1:
                k = math.prod(w.shape[2:])
                macs = (x.numel() * w.shape[1] if transposed else out.numel() * w.shape[1]) * k
                nbytes = (x.numel() + w.numel() + out.numel()) * self.itemsize
                self.calls.append((2.0 * macs, float(nbytes)))
        return out


def count(fn, itemsize: int) -> dict:
    """``fn()`` run once (on meta tensors) under both counters:
    ``{"flops": total, "conv3d": [(ops, bytes), ...]}``."""
    flops = FlopCounterMode(display=False)
    convs = _Conv3dWork(itemsize)
    with flops, convs:
        fn()
    return {"flops": float(flops.get_total_flops()), "conv3d": convs.calls}


def least_seconds(calls, peak_flops: float, peak_bytes: float) -> float:
    """``Σ max(ops / peak FLOP/s, bytes / peak bytes/s)`` over the calls."""
    return sum(max(ops / peak_flops, nbytes / peak_bytes) for ops, nbytes in calls)
