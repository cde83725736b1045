"""Host ms per frame of a dispatch's enqueue (update, render, denoise; no
synchronise), over the window's frames outside the profiled slice."""

from portbench import readers


def read(ctx):
    return readers.host_ms(ctx, ("update", "render", "denoise"), "frames")
