"""Device ms a training step of BatchNorm (forward and
backward, 2-D and 3-D, the models' training BatchNorm)."""

GROUPS = ("batch norm",)


def read(ctx):
    if ctx["phase"] != "train":
        return None
    ms = sum(dur for name, _, dur in ctx["ops"] if ctx["group_of"](name) in GROUPS) * 1e3
    return ms / ctx["steps"] if ms > 0 else None
