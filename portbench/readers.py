"""What the metric readers under ``metrics/`` share: the window's units and
spans, and the profiled slice's units and device operations."""

from __future__ import annotations


def window_units(ctx) -> list[dict]:
    return [u for u in ctx["units"] if u["index"] >= 0]


def slice_units(ctx) -> list[dict]:
    sl = ctx["slice"]
    if sl is None or sl.last is None:
        return []
    return [u for u in window_units(ctx) if sl.first <= u["index"] <= sl.last]


def unsliced(ctx) -> set[int]:
    """Indices of the window's units that ran without the profiler (its
    records and the slice's marker launches touch the host's pace)."""
    sl = ctx["slice"]
    return {u["index"] for u in window_units(ctx)} - (sl.profiled if sl is not None else set())


def host_ms(ctx, names: tuple, per: str) -> float | None:
    """Host ms of the spans ``names`` per dispatch or frame (``per``), over
    the window's units outside the profiled slice."""
    keep = unsliced(ctx)
    units = [u for u in window_units(ctx) if u["index"] in keep]
    count = sum(u[per] for u in units)
    if not count:
        return None
    total = sum(t1 - t0 for name, t0, t1, unit in ctx["spans"] if name in names and unit in keep)
    return total * 1e3 / count


def ops(ctx, bid: str | None = None, span: str | None = None) -> list[dict]:
    red = ctx["trace"]
    if red is None:
        return []
    return [o for o in red["ops"] if (bid is None or o["id"] == bid)
            and (span is None or o["span"] == span)]


def slice_count(ctx, per: str) -> int:
    return sum(u[per] for u in slice_units(ctx))


def device_ms_per(ctx, selected: list[dict], per: str) -> float | None:
    """Device ms of the ``selected`` operations per dispatch or frame of the
    slice; None where the slice has none of them."""
    count = slice_count(ctx, per)
    if not selected or not count:
        return None
    return sum(o["seconds"] for o in selected) * 1e3 / count


def idle_pct(ctx) -> float | None:
    red = ctx["trace"]
    if red is None or red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])


def num_tris(spec: dict) -> int:
    return sum(len(spec["meshes"][i["mesh"]]["indices"]) for i in spec["instances"])


def b1_roofline(ctx, realtime: bool) -> float | None:
    """B1's bound over its mean device ms a launch, in %."""
    launches = ops(ctx, "B1")
    if not launches:
        return None
    tr = ctx["traffic"]
    frames = int(tr.get("frames_per_dispatch", 1)) if realtime else 1
    rays = ctx["b1_rays"](slice_units(ctx))
    bound_ms, _ = ctx["roofline"].b1_bound(rays, num_tris(ctx["spec"]),
                                           tr["width"] * tr["height"] * frames, realtime)
    mean_ms = sum(o["seconds"] for o in launches) * 1e3 / len(launches)
    return 100.0 * bound_ms / mean_ms
