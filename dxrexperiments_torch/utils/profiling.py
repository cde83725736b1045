"""Tracing and profiling helpers (``dxrexperiments_tpu.utils.profiling``).

``device_trace`` records a block with ``torch.profiler`` (CPU and, where a
card is present, CUDA activities: every kernel launch with its device
time) and writes a Chrome trace under ``log_dir``; ``annotate`` names a
range of the trace; ``FrameTimer`` times host phases, each fenced by a
synchronise of the card when it is given a CUDA tensor. The fps and rays/s
stats are ``utils/stats.py``'s.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record the block with ``torch.profiler`` and write
    ``log_dir/trace.json`` (Chrome trace format: Perfetto or
    chrome://tracing). Yields the profiler, whose ``key_averages()`` and
    ``events()`` list each kernel by name after the block:

        with device_trace("rt-trace") as prof:
            pipeline.render()

    With a card, the profiler waits for the card before and after the
    block, so the trace holds the block's device work and no earlier
    work's."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# Named range: frames and phases appear by name in the trace's timeline.
annotate = torch.profiler.record_function


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
