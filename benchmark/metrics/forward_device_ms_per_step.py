"""Device ms a training step launched under the program's
``dv.train.forward`` span (``train/loop.py``: the ground truth's ↓4, the
draws, ``train_forward`` and the loss)."""

from benchmark import spans


def read(ctx):
    red = spans.of(ctx, "train", spans.TRAIN_FORWARD)
    return None if red is None else spans.device_s(red, spans.TRAIN_FORWARD) * 1e3 / ctx["steps"]
