"""The whole pair's share of the card's peak (%): the FLOPs of the traced
calls (matmuls and convolutions, counted by FlopCounterMode over the
reference at the cell's shapes) over the slice's wall seconds and the peak
of the configuration's arithmetic."""


def read(ctx):
    if ctx["phase"] != "eval" or ctx["work"]["flops"] <= 0:
        return None
    rate = ctx["work"]["flops"] * ctx["calls"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"]["flops"][ctx["peak_dtype"]]
