"""B6a's profiled device ms per progressive dispatch."""

from portbench import readers


def read(ctx):
    return readers.device_ms_per(ctx, readers.ops(ctx, "B6a"), "dispatches")
