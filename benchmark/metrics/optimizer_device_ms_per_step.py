"""Device ms a training step launched under the program's
``dv.train.optimizer`` span (``train/loop.py``: ``apply_gradients``, Adam)."""

from benchmark import spans


def read(ctx):
    red = spans.of(ctx, "train", spans.TRAIN_OPTIMIZER)
    return None if red is None else spans.device_s(red, spans.TRAIN_OPTIMIZER) * 1e3 / ctx["steps"]
