"""Idle ms of the card a pair put down to the program's ``dv.h2d`` spans:
the gaps ended by an operation launched while a ``dv.h2d`` span was the
innermost one open (a copy from pageable host memory waits for the
stream)."""

from benchmark import spans


def read(ctx):
    red = spans.of(ctx, "eval", spans.INFER)
    return None if red is None else red["idle"].get(spans.H2D, 0.0) * 1e3 / ctx["pairs"]
