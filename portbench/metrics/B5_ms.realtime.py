"""B5's profiled device ms per realtime frame."""

from portbench import readers


def read(ctx):
    return readers.device_ms_per(ctx, readers.ops(ctx, "B5"), "frames")
