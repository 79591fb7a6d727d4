"""Device ms a training step launched under the program's
``dv.train.backward`` span (``train/loop.py``: ``zero_grad`` and
``loss.backward()``, autograd's launches from its own thread included)."""

from benchmark import spans


def read(ctx):
    red = spans.of(ctx, "train", spans.TRAIN_BACKWARD)
    return None if red is None else spans.device_s(red, spans.TRAIN_BACKWARD) * 1e3 / ctx["steps"]
