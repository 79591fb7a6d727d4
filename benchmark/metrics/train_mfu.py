"""The whole training step's share of the card's peak (%): the FLOPs of
the traced steps (matmuls and convolutions, forward and backward, counted
by FlopCounterMode over the reference at the cell's shapes) over the
slice's wall seconds and the peak of the step's arithmetic (TF32: cuDNN's
convolutions may take it under the training CLI's settings)."""


def read(ctx):
    if ctx["phase"] != "train" or ctx["work"]["flops"] <= 0:
        return None
    rate = ctx["work"]["flops"] * ctx["calls"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"]["flops"][ctx["peak_dtype"]]
