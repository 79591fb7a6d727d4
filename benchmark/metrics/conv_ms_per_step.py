"""Device ms a training step of cuDNN's convolutions (forward and
backward, 2-D and 3-D: training reaches none of the port's kernels)."""

GROUPS = ("conv / deconv (cuDNN, CUTLASS)",)


def read(ctx):
    if ctx["phase"] != "train":
        return None
    ms = sum(dur for name, _, dur in ctx["ops"] if ctx["group_of"](name) in GROUPS) * 1e3
    return ms / ctx["steps"] if ms > 0 else None
