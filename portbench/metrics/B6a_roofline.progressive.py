"""B6a's bound (roofline_b6a.b6a_bound on the reference's census of a
dispatch's live rays) over its profiled device ms a progressive dispatch,
in %."""

from portbench import readers, roofline_b6a


def read(ctx):
    ms = readers.device_ms_per(ctx, readers.ops(ctx, "B6a"), "dispatches")
    if ms is None:
        return None
    spec = ctx["spec"]
    rays = ctx["b1_rays"](readers.slice_units(ctx))
    launches = roofline_b6a.LAUNCHES_PER_SAMPLE * int(ctx["traffic"]["samples_per_dispatch"])
    bound_ms, _ = roofline_b6a.b6a_bound(rays, len(spec["instances"]),
                                         roofline_b6a.blas_tris(spec), launches)
    return 100.0 * bound_ms / ms
