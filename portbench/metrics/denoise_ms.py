"""Device ms per frame of what the denoise span launched: the B2 passes and
the composite's kernels."""

from portbench import readers


def read(ctx):
    return readers.device_ms_per(ctx, readers.ops(ctx, span="denoise"), "frames")
