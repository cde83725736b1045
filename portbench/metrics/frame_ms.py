"""The window's milliseconds over the frames presented in it."""


def read(ctx):
    frames = sum(u["frames"] for u in ctx["units"] if u["index"] >= 0)
    return ctx["window_s"] * 1e3 / frames
