"""Host ms around set_instance_transforms, ended by a synchronise (in the
traced run only), over the window's dispatches outside the profiled
slice."""

from portbench import readers


def read(ctx):
    return readers.host_ms(ctx, ("refit",), "dispatches")
