"""Device ms a pair launched under the program's ``dv.features`` (the
folded paths' 2-D feature trunks, both passes) or ``dv.refine`` (PCW's 2-D
refinement, pass 1 and every step) spans."""

from benchmark import spans


def read(ctx):
    red = spans.of(ctx, "eval", spans.FEATURES)
    if red is None:
        return None
    return spans.device_s(red, spans.FEATURES, spans.REFINE) * 1e3 / ctx["pairs"]
