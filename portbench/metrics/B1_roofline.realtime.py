"""B1's bound over its mean profiled device ms a realtime launch of K
frames, in %."""

from portbench import readers


def read(ctx):
    return readers.b1_roofline(ctx, realtime=True)
