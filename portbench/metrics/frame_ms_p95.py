"""The 95th percentile over all of the window's frames of a frame's
latency: from the start of its update to its display synchronised. Only
where a dispatch is one frame."""

import numpy as np


def read(ctx):
    units = [u for u in ctx["units"] if u["index"] >= 0]
    if any(u["frames"] != 1 for u in units):
        return None
    return float(np.percentile([(u["t1"] - u["t0"]) * 1e3 for u in units], 95))
