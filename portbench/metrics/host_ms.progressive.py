"""Host ms per dispatch around update + render (no synchronise), over the
window's dispatches outside the profiled slice."""

from portbench import readers


def read(ctx):
    return readers.host_ms(ctx, ("update", "render"), "dispatches")
