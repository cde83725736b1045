"""B2's bound (roofline.b2_bound: closed form from the image and the
radius) over its mean profiled device ms a pass, in %."""

from portbench import readers


def read(ctx):
    passes = readers.ops(ctx, "B2")
    if not passes:
        return None
    tr = ctx["traffic"]
    bound_ms, _ = ctx["roofline"].b2_bound(tr["width"], tr["height"],
                                           float(tr["denoise"]["max_kernel_size"]))
    return 100.0 * bound_ms / (sum(o["seconds"] for o in passes) * 1e3 / len(passes))
