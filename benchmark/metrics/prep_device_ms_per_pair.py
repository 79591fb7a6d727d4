"""Device ms a pair launched under the program's ``dv.prep`` spans: pass 1,
the DDIM model's volume and the conditioning latent
(``eval/pipeline.py`` ``*_prep``)."""

from benchmark import spans


def read(ctx):
    red = spans.of(ctx, "eval", spans.PREP)
    return None if red is None else spans.device_s(red, spans.PREP) * 1e3 / ctx["pairs"]
