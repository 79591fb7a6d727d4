"""Idle ms of the card a training step put down to the program's
``dv.h2d`` spans (the innermost span open at the launch that ends a
gap)."""

from benchmark import spans


def read(ctx):
    red = spans.of(ctx, "train", spans.TRAIN_FORWARD)
    return None if red is None else red["idle"].get(spans.H2D, 0.0) * 1e3 / ctx["steps"]
