"""Parameter and FLOP accounting.

Counterpart of ``diffuvolume_tpu/tools/flops.py`` (the reference's thop and
parameter prints, SceneFlow/test_sceneflow_ddim.py:27-28,52-59):
``count_params`` and ``trainable_param_report`` over a module's
parameters, and ``flop_count`` in place of ``xla_cost``:
``torch.utils.flop_counter.FlopCounterMode`` over a call on CPU tensors, so
that every kernel wrapper takes its plain PyTorch version, which the
counter sees.  The counter knows PyTorch's matmuls, convolutions and
attention (the same family thop counts) and nothing elementwise; the
result names it.  A CUDA input raises, and a kernel launch during the
count raises too: the kernels' ``ctypes`` launches are invisible to the
counter, and a count that skipped them would be silently short.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

# What FlopCounterMode counts (torch.utils.flop_counter's registry): the
# result says so beside its numbers.
COUNTED = "matmuls, convolutions (and their transposes), attention; not elementwise ops"


def count_params(params) -> int:
    """Elements of ``params``: a module's parameters, or any iterable of
    tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return sum(int(p.numel()) for p in params)


def trainable_param_report(model: torch.nn.Module) -> dict:
    """Parameter counts in millions per top-level child, with the total
    (``TOTAL_M``), as the JAX package's report per top-level module."""
    report = {name: count_params(child) / 1e6 for name, child in model.named_children()
              if count_params(child)}
    report["TOTAL_M"] = count_params(model) / 1e6
    return report


def _kernel_wrappers() -> dict:
    """Every kernel wrapper with a launch counter, by name."""
    from diffuvolume_tpu_torch.ops.kernels import (
        concat_volume,
        conv2d,
        conv3d_fold,
        conv3d_up,
        depthwise,
        fused_head,
        gwc_volume,
        layout,
    )

    out = {}
    for mod in (concat_volume, conv2d, conv3d_fold, conv3d_up, depthwise, fused_head,
                gwc_volume, layout):
        for name, fn in vars(mod).items():
            if callable(fn) and hasattr(fn, "launches"):
                out[name] = fn
    return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def flop_count(fn: Callable, *args, **kwargs) -> dict:
    """The FLOPs of ``fn(*args, **kwargs)`` on CPU tensors (a model on the
    CPU): ``{"flops", "gflops", "by_op" (GFLOPs by ATen op), "counted"}``, where a
    multiply-add is 2 FLOPs.  Raises on a CUDA input or on any launch of
    the port's kernels during the call."""
    if any(t.is_cuda for t in _tensors((args, kwargs))):
        raise ValueError("count FLOPs on CPU tensors: the kernels' launches are invisible "
                         "to the counter")
    wrappers = _kernel_wrappers()
    before = {k: f.launches for k, f in wrappers.items()}
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    launched = {k: f.launches - before[k] for k, f in wrappers.items()
                if f.launches != before[k]}
    if launched:
        raise RuntimeError(f"kernels launched during the count, not counted: {launched}")
    by_op = {str(op): n / 1e9 for op, n in counter.get_flop_counts()["Global"].items()}
    total = counter.get_total_flops()
    return {"flops": total, "gflops": total / 1e9, "by_op": by_op, "counted": COUNTED}
