"""The traced slice: ``torch.profiler`` with CUDA activity alone (kernels,
copies, sets and the runtime calls that launched them; no CPU operators,
whose recording slows the host's enqueue) over a steady run of units inside
the window, kept in memory and reduced here to what the per-layer readers
and the result line's ``breakdown`` read. Nothing is written to disk.

Each device operation is named by its B-id where the table under
``kernels/`` knows it, else by its own name, and attributed to the
benchmark span (``drive.Spans``, the benchmark's own host clock) that holds
its launch. A marker kernel launched at each end of the slice ties the
host clock to the profiler's.
"""

from __future__ import annotations

import bisect
import glob
import json
import math
import os
import re
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def kernel_table(root: str = HERE) -> list[dict]:
    """Every ``kernels/*.json``: {"id", "patterns" (regexes over the
    profiler's kernel name), "required_when" (a list of conditions, each a
    dict of facts that must all hold)}."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, "kernels", "*.json"))):
        with open(path) as f:
            entry = json.load(f)
        entry["regex"] = [re.compile(p) for p in entry["patterns"]]
        out.append(entry)
    return out


def kernel_id(name: str, table: list[dict]) -> str | None:
    for entry in table:
        if any(r.search(name) for r in entry["regex"]):
            return entry["id"]
    return None


def required(table: list[dict], facts: dict) -> list[str]:
    """B-ids a cell's route must launch: those with a condition that the
    cell's facts (route, pipeline, accel, denoise) all meet."""
    return [e["id"] for e in table
            if any(all(facts.get(k) == v for k, v in c.items()) for c in e["required_when"])]


MARKER = re.compile(r"spin_kernel")  # torch.cuda._sleep's kernel
MARK_CLEAR_S = 0.002  # a marker this far from the profiler's start and stop is kept


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def warm_profiler() -> None:
    """Start and stop the profiler once around a small operation on the
    card, so that its first start (seconds, to set CUPTI up) falls in set-up
    and not in the window."""
    with profiler():
        torch.ones(8, device="cuda").add_(1)
        torch.cuda.synchronize()


def mark() -> float:
    """Launch a marker kernel on an idle card, a moment clear of the
    profiler's start and stop; returns the host clock just before the
    launch."""
    torch.cuda.synchronize()
    time.sleep(MARK_CLEAR_S)
    t = time.perf_counter()
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    time.sleep(MARK_CLEAR_S)
    return t


def pace(inside: list[dict], outside: list[dict]) -> dict:
    """Host ms a unit inside a profiled slice and outside it."""
    mean_ms = lambda us: 1e3 * sum(u["t1"] - u["t0"] for u in us) / max(len(us), 1)  # noqa: E731
    return {"slice_ms": mean_ms(inside), "window_ms": mean_ms(outside)}


def off_pace(p: dict, limit: float) -> bool:
    return p["window_ms"] > 0 and abs(p["slice_ms"] / p["window_ms"] - 1.0) > limit


class Slice:
    """Starts and stops the profiler at unit boundaries: from the first unit
    that begins at or after ``start_s`` into the window, for at least
    ``min_units`` units and ``span_s`` seconds of them. A slice whose host ms a
    unit is off the window's so far by more than ``limit`` (the host's pace
    drifts from unit to unit) is profiled again on the next units,
    ``tries`` times in all. The window runs on until the slice is ``done``.
    ``profiled`` holds every unit that ran under the profiler."""

    def __init__(self, spans, units: list[dict], start_s: float, span_s: float,
                 min_units: int, limit: float, tries: int):
        self.spans, self.units = spans, units
        self.start_s, self.span_s, self.min_units = start_s, span_s, min_units
        self.limit, self.tries = limit, tries
        self.prof = None
        self.first = self.last = None
        self.marks: list[float] = []
        self.profiled: set[int] = set()
        self.attempts: list[dict] = []  # each slice profiled: its units and pace
        self.done = False

    def _start(self, i: int) -> None:
        torch.cuda.synchronize()
        self.prof = profiler()
        self.prof.start()
        self.marks = [mark()]
        self.spans.profiling = True
        self.first = i

    def __call__(self, i: int, elapsed):
        if self.done:
            return
        if self.prof is None:
            if elapsed is not None and elapsed >= self.start_s:
                self._start(i)
            return
        if elapsed is None or (i - self.first >= self.min_units and self.units[i - 1]["t1"]
                               - self.units[self.first]["t0"] >= self.span_s):
            self.spans.profiling = False
            self.marks.append(mark())
            self.prof.stop()
            self.last = i - 1
            self.tries -= 1
            before = [u for u in self.units[:self.first] if u["index"] not in self.profiled]
            self.profiled.update(range(self.first, i))
            p = dict(pace(self.units[self.first:i], before), units=[self.first, i - 1])
            self.attempts.append(p)
            if elapsed is not None and self.tries > 0 and off_pace(p, self.limit):
                self._start(i)
                return
            self.done = True


def reduce(prof, table: list[dict], marks: list[float], units: list[dict],
           spans: list[tuple]) -> dict:
    """Reduce a stopped profile: the slice's length (from the start of its
    first unit to the end of its last, ``units``), the device's busy
    seconds (the union of every device operation's interval inside it), the
    device operations with their B-id or name, seconds and launching span
    (``spans``: name, host start, host end, unit), and the idle gaps with the
    span the host was in. ``marks`` are the host clock at the marker
    launches before and after the slice; a marker the profile lost leaves
    the other to tie the clocks."""
    events = list(prof.events())
    dev_type = torch.autograd.DeviceType.CUDA
    runtime = {e.id: e for e in events if e.device_type != dev_type
               and re.search(r"(cuda|cu)(Launch|Memcpy|Memset)", e.name)}
    ops, markers = [], []
    for e in events:
        if e.device_type != dev_type:
            continue
        launch = runtime.get(e.id)
        op = {"name": e.name, "id": kernel_id(e.name, table), "start": e.time_range.start,
              "end": e.time_range.end, "launched": launch is not None,
              "t_host": launch.time_range.start if launch is not None else e.time_range.start}
        (markers if MARKER.search(e.name) else ops).append(op)
    first_op = min((o["start"] for o in ops), default=math.inf)
    found = [(m["t_host"], marks[0 if m["start"] < first_op else 1]) for m in markers]
    if not found:
        raise RuntimeError("the profile holds no marker kernel")
    found.sort()
    (p0, h0), (p1, h1) = found[0], found[-1]
    scale = (p1 - p0) / ((h1 - h0) * 1e6) if len(found) > 1 else 1.0
    to_prof = lambda t: p0 + (t - h0) * 1e6 * scale  # noqa: E731
    lo, hi = to_prof(units[0]["t0"]), to_prof(units[-1]["t1"])
    ranges = _Ranges([(n, to_prof(t0), to_prof(t1)) for n, t0, t1, _ in spans])
    for o in ops:
        o["span"] = _span_at(ranges, o.pop("t_host"))
    ops.sort(key=lambda o: o["start"])
    busy, gaps, cur_lo, cur_hi = 0.0, [], None, None
    for o in ops:
        a, b = max(o["start"], lo), min(o["end"], hi)
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
                gaps.append((cur_hi, a))
            elif a > lo:
                gaps.append((lo, a))
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
        if hi > cur_hi:
            gaps.append((cur_hi, hi))
    us = 1e-6
    inside = [o for o in ops if lo <= o["start"] < hi]
    return {
        "window_s": (hi - lo) * us,
        "busy_s": busy * us,
        "launched_share": sum(o["launched"] for o in inside) / max(len(inside), 1),
        "ops": [dict(o, seconds=(o["end"] - o["start"]) * us) for o in ops],
        "gaps": [{"seconds": (b - a) * us, "span": _span_at(ranges, 0.5 * (a + b))}
                 for a, b in gaps],
    }


def _span_at(spans, t) -> str:
    """The benchmark span holding host time ``t``, or "host" (the spans are
    siblings: none holds another)."""
    i = bisect.bisect_right(spans.starts, t) - 1
    if i >= 0 and t <= spans.ends[i]:
        return spans.names[i]
    return "host"


class _Ranges:
    def __init__(self, spans):
        spans = sorted(spans, key=lambda s: s[1])
        self.names = [s[0] for s in spans]
        self.starts = [s[1] for s in spans]
        self.ends = [s[2] for s in spans]


def breakdown(red: dict, top: int = 10) -> dict:
    """The device operations that took most time (by B-id or name) and the
    idle time summed by the host span it fell in, at most ``top`` each."""
    by_op: dict[str, float] = {}
    for o in red["ops"]:
        key = o["id"] or o["name"][:96]
        by_op[key] = by_op.get(key, 0.0) + o["seconds"]
    by_gap: dict[str, float] = {}
    for g in red["gaps"]:
        by_gap[g["span"]] = by_gap.get(g["span"], 0.0) + g["seconds"]
    order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa
    return {"device_ops": order(by_op), "idle_gaps": order(by_gap)}
