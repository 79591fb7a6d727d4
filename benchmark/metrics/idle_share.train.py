"""The card's idle share of the traced slice of an training cell (%):
1 − the seconds in which any device operation ran / the slice's wall."""


def read(ctx):
    if ctx["phase"] != "train" or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
