"""Host ms a pair in the program's ``dv.infer`` spans (the entry's whole
call, launching its work) less the ``dv.h2d`` spans inside them (building
host arrays and copying them to the card)."""

from benchmark import spans


def read(ctx):
    red = spans.of(ctx, "eval", spans.INFER)
    if red is None:
        return None
    s = spans.host_s(red, spans.INFER) - spans.host_s(red, spans.H2D, inside=spans.INFER)
    return s * 1e3 / ctx["pairs"]
