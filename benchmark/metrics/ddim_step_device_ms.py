"""Device ms of one DDIM step of one pair: the device time launched under
the program's ``dv.ddim.step`` spans (``diffusion/ddim.py``: denoise,
re-encode, noise prediction, renewal, draws, update) over the pairs and the
steps a call."""

from benchmark import spans


def read(ctx):
    red = spans.of(ctx, "eval", spans.DDIM_STEP)
    if red is None:
        return None
    per_call = spans.count(red, spans.DDIM_STEP) / ctx["calls"]
    return spans.device_s(red, spans.DDIM_STEP) * 1e3 / (ctx["pairs"] * per_call)
