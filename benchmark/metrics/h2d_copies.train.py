"""Host-built arrays copied to the card a training step: the program's
``dv.h2d`` spans over the steps."""

from benchmark import spans


def read(ctx):
    red = spans.of(ctx, "train", spans.TRAIN_FORWARD)
    return None if red is None else spans.count(red, spans.H2D) / ctx["steps"]
