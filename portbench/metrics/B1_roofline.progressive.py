"""B1's bound (roofline.b1_bound on the reference's census of live rays)
over its mean profiled device ms a progressive launch, in %."""

from portbench import readers


def read(ctx):
    return readers.b1_roofline(ctx, realtime=False)
