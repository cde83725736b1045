"""Primary samples (pixels x samples accumulated) of the window's presented
units over the window's seconds, / 1e6."""


def read(ctx):
    units = [u for u in ctx["units"] if u["index"] >= 0]
    return sum(u["samples"] for u in units) / ctx["window_s"] / 1e6
