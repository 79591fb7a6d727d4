"""Learning-rate schedules as plain functions of the step.

Counterpart of ``diffuvolume_tpu/train/lr.py``, with optax's values at
every step: the epoch-milestone decay ``"16,24,32,40,48:2"``
(SceneFlow/utils/experiment.py:91-109; ``optax.piecewise_constant_schedule``
scales at ``step >= boundary``) and KITTI15's one-cycle policy
(train_stereo.py:126-128; ``optax.linear_onecycle_schedule``, which is not
``torch.optim.lr_scheduler.OneCycleLR``).  The optimiser takes
``schedule(step)`` with ``step`` the updates made so far, as optax's does.
"""

from __future__ import annotations

from typing import Callable

Schedule = Callable[[int], float]


def milestone_lr_schedule(base_lr: float, lrepochs: str, steps_per_epoch: int) -> Schedule:
    """Parse ``"e1,e2,...:gamma"``: the rate is divided by ``gamma`` at each
    epoch milestone."""
    splits = lrepochs.split(":")
    if len(splits) != 2:
        raise ValueError(f"lrepochs must be 'e1,e2,...:gamma', got {lrepochs!r}")
    boundaries = sorted(int(e) * steps_per_epoch for e in splits[0].split(","))
    gamma = float(splits[1])

    def schedule(step: int) -> float:
        lr = base_lr
        for b in boundaries:
            if step >= b:
                lr *= 1.0 / gamma
        return lr
    return schedule


def piecewise_linear_schedule(init_value: float, boundaries_and_scales: dict[int, float]
                              ) -> Schedule:
    """``optax.piecewise_interpolate_schedule("linear", ...)``: the value is
    multiplied by each boundary's scale in turn, and runs linearly from one
    boundary's accumulated value to the next's; past the last boundary it
    stays at the last value."""
    bounds = [0] + sorted(boundaries_and_scales)
    values = [init_value]
    for b in bounds[1:]:
        values.append(values[-1] * boundaries_and_scales[b])

    def schedule(step: int) -> float:
        for lo, hi, v0, v1 in zip(bounds, bounds[1:], values, values[1:]):
            if lo <= step < hi:
                return v0 + (v1 - v0) * (step - lo) / (hi - lo)
        return values[-1]
    return schedule


def one_cycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.01) -> Schedule:
    """KITTI15's OneCycle (linear anneal, ``pct_start`` 0.01, the JAX
    package's settings): ``optax.linear_onecycle_schedule(total_steps + 100,
    max_lr, pct_start, pct_final 1, div_factor 25, final_div_factor
    1e4/25)``.  With ``pct_final`` 1 the second and third phases end on one
    step, and the third phase's scale is the one optax keeps: the rate
    rises from ``max_lr/25`` to ``max_lr`` and falls linearly to
    ``max_lr·25/1e4``."""
    transition = total_steps + 100
    div_factor, final_div_factor = 25.0, 1e4 / 25.0
    scales = {int(pct_start * transition): div_factor, transition: 1.0 / final_div_factor}
    return piecewise_linear_schedule(max_lr / div_factor, scales)
