"""Host-built arrays copied to the card a pair: the program's ``dv.h2d``
spans (``ops/regression.py``'s resize matrices, ``diffusion/schedule.py``'s
buffers, ``diffusion/ddim.py``'s ensemble weights) over the pairs."""

from benchmark import spans


def read(ctx):
    red = spans.of(ctx, "eval", spans.INFER)
    return None if red is None else spans.count(red, spans.H2D) / ctx["pairs"]
