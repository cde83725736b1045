"""Profiled device ms per progressive dispatch of every operation other than
B6a that the update and render spans launched: the wavefront integrator's
glue (the refit's operations are refit_ms's)."""

from portbench import readers


def read(ctx):
    glue = [o for o in readers.ops(ctx) if o["id"] != "B6a" and o["span"] in ("update", "render")]
    return readers.device_ms_per(ctx, glue, "dispatches")
