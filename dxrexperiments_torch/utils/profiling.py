"""Tracing and profiling helpers (``dxrexperiments_tpu.utils.profiling``).

``annotate(name, n)`` is the program's span: a context manager around one
step of a layer, named ``<layer>.<step>`` (``progressive.render``,
``B1.wrapper``, ``B1.pack``, ``denoise.dispatch``, ``scene.bvh``, ...),
``n`` the work it covers (cameras built, frames launched, B2 passes).
Spans cost one flag check while nothing listens. ``enable()`` turns the
in-memory recorder on, from an empty list: each span then appends
``Span(name, t0, t1, id, parent, n)`` (``time.perf_counter`` seconds; the
parent from a per-thread stack), up to ``MAX_SPANS`` records, counting
those it drops (``dropped()``); ``spans()`` copies the list, ``disable()``
stops recording. A span never synchronises and never reads a device
tensor.

``device_trace`` records a block with ``torch.profiler`` (on a card its
CUDA activity alone by default: every kernel and copy with its device
time) and writes a Chrome trace under ``log_dir``; while it records CPU
operators, each span also enters a ``record_function`` of its name, so
spans appear in the trace's timeline. ``FrameTimer`` times host phases,
each fenced by a synchronise of the card when it is given a CUDA tensor.
The fps and rays/s stats are ``utils/stats.py``'s.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch

MAX_SPANS = 2_000_000  # records the recorder keeps; later ones are counted as dropped


class Span(NamedTuple):
    """One recorded span: host seconds on ``time.perf_counter``'s clock,
    its id, its parent's id (-1 for a span opened outside any other on its
    thread) and the work it covers (None where the caller gave none)."""

    name: str
    t0: float
    t1: float
    id: int
    parent: int
    n: int | None


_on = False  # the one flag a span checks: the recorder or a CPU-operator trace listens
_recording = False
_cpu_traces = 0  # device_trace blocks recording CPU operators, open now
_records: list[tuple] = []
_dropped = 0
_ids = itertools.count()
_stacks = threading.local()


class _NoSpan:
    """The span while nothing listens: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "n", "t0", "id", "parent", "stack", "rf")

    def __init__(self, name: str, n):
        self.name, self.n = name, n

    def __enter__(self):
        self.rf = None
        if _cpu_traces:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        stack = getattr(_stacks, "ids", None)
        if stack is None:
            stack = _stacks.ids = []
        self.stack = stack
        self.parent = stack[-1] if stack else -1
        self.id = next(_ids)
        stack.append(self.id)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = time.perf_counter()
        self.stack.pop()
        if _recording:
            if len(_records) < MAX_SPANS:
                _records.append((self.name, self.t0, t1, self.id, self.parent, self.n))
            else:
                _dropped += 1
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def annotate(name: str, n: int | None = None):
    """The span of one step of a layer (module docstring): a shared no-op
    while neither the recorder nor a CPU-operator ``device_trace`` listens."""
    if not _on:
        return _NO_SPAN
    return _Span(name, n)


def _set_on() -> None:
    global _on
    _on = _recording or _cpu_traces > 0


def enable() -> None:
    """Start recording spans, from an empty list."""
    global _recording, _dropped
    _records.clear()
    _dropped, _recording = 0, True
    _set_on()


def disable() -> None:
    """Stop recording; the records stay for ``spans()``."""
    global _recording
    _recording = False
    _set_on()


def spans() -> list[Span]:
    """The recorded spans in the order they ended (a parent after its
    children)."""
    return [Span(*r) for r in _records]


def dropped() -> int:
    """Spans not recorded since ``enable`` because the list was full."""
    return _dropped


@contextlib.contextmanager
def device_trace(log_dir: str, cpu_ops: bool | None = None):
    """Record the block with ``torch.profiler`` and write
    ``log_dir/trace.json`` (Chrome trace format: Perfetto or
    chrome://tracing). Yields the profiler, whose ``key_averages()`` and
    ``events()`` list each kernel by name after the block:

        with device_trace("rt-trace") as prof:
            pipeline.render()

    With a card the profiler records its CUDA activity alone unless
    ``cpu_ops`` is True: recording CPU operators slowed the host's enqueue
    2.3-fold on an H100 (6.2 against 2.66 ms a 16-sample 512² progressive
    dispatch), so the card then waits on the profiler. Without a card it
    records the CPU's operators. While CPU operators are recorded, spans
    (``annotate``) are named ranges of the trace. With a card, the profiler
    waits for the card before and after the block, so the trace holds the
    block's device work and no earlier work's."""
    global _cpu_traces
    cuda = torch.cuda.is_available()
    cpu_ops = not cuda if cpu_ops is None else bool(cpu_ops)
    activities = [torch.profiler.ProfilerActivity.CPU] if cpu_ops else []
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        _cpu_traces += cpu_ops
        _set_on()
        try:
            if cuda:
                torch.cuda.synchronize()
            yield prof
            if cuda:
                torch.cuda.synchronize()
        finally:
            _cpu_traces -= cpu_ops
            _set_on()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class FrameTimer:
    """Host-side phase times. A phase given ``fence`` (a tensor, or a
    callable returning one) ends after a ``torch.cuda.synchronize`` of that
    tensor's card when it lies on one, so the phase includes the device work
    it queued; a CPU tensor needs no fence."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        t0 = time.perf_counter()
        yield
        if fence is not None:
            t = fence() if callable(fence) else fence
            if isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.synchronize(t.device)
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values())
        parts = [f"{k}: {v * 1000:.2f}ms" for k, v in self.phases.items()]
        return f"total {total * 1000:.2f}ms | " + " | ".join(parts)
