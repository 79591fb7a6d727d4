"""Running-average meters (SceneFlow/utils/experiment.py:112-151).

The port's own copy of ``diffuvolume_tpu/utils/meters.py``; values may be
Python numbers, numpy scalars or one-element torch tensors.
"""

from __future__ import annotations


def to_float(x):
    """``tensor2float``: one-element tensors and arrays, and numbers, to
    Python floats, through dicts, lists and tuples."""
    if isinstance(x, dict):
        return {k: to_float(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_float(v) for v in x]
    if hasattr(x, "item"):
        return float(x.item())
    return float(x)


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.sum += to_float(value) * n
        self.count += n

    def mean(self) -> float:
        return self.sum / max(self.count, 1)


class AverageMeterDict:
    """Mean of dicts of numbers or lists of numbers (experiment.py:127-151)."""

    def __init__(self):
        self.data = None
        self.count = 0

    def update(self, values: dict, n: int = 1):
        values = to_float(values)
        self.count += n
        if self.data is None:
            self.data = {k: _scale(v, n) for k, v in values.items()}
        else:
            for k, v in values.items():
                self.data[k] = _add(self.data[k], _scale(v, n))

    def mean(self) -> dict:
        return {k: _scale(v, 1.0 / max(self.count, 1)) for k, v in (self.data or {}).items()}


def _scale(v, s):
    if isinstance(v, list):
        return [x * s for x in v]
    return v * s


def _add(a, b):
    if isinstance(a, list):
        return [x + y for x, y in zip(a, b)]
    return a + b
