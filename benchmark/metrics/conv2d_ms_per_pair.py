"""Device ms a pair of the 2-D parts (feature trunks, PCW's refinement):
the cuDNN conv, BatchNorm, grid-sample and elementwise kernel groups."""

GROUPS = ("conv / deconv (cuDNN, CUTLASS)", "batch norm", "grid sample (PCW refinement warp)",
          "elementwise / reduce")


def read(ctx):
    if ctx["phase"] != "eval":
        return None
    ms = sum(dur for name, _, dur in ctx["ops"] if ctx["group_of"](name) in GROUPS) * 1e3
    return ms / ctx["pairs"] if ms > 0 else None
