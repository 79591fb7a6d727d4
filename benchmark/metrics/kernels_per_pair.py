"""Device kernels a pair in the traced slice (a count): the host's launch
work that ``eval/pipeline.py`` and ``diffusion/ddim.py`` issue."""


def read(ctx):
    if ctx["phase"] != "eval" or not ctx["kernels"]:
        return None
    return ctx["kernels"] / ctx["pairs"]
