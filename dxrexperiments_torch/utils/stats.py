"""Frame statistics: fps and million primary rays per second (copied from
``dxrexperiments_tpu.utils.stats``). Host clock; a caller that wants device
time synchronises before ``frame()``."""

from __future__ import annotations

import time


class FrameStats:
    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self._frames = 0
        self._t0 = time.perf_counter()
        self.fps = 0.0
        self.mrays_per_sec = 0.0

    def resize(self, width: int, height: int) -> None:
        self.width, self.height = width, height

    def frame(self) -> bool:
        """Count one frame; returns True when the stats refreshed (1 Hz)."""
        self._frames += 1
        now = time.perf_counter()
        dt = now - self._t0
        if dt >= 1.0:
            self.fps = self._frames / dt
            self.mrays_per_sec = self.width * self.height * self.fps / 1e6
            self._frames = 0
            self._t0 = now
            return True
        return False

    def title(self, name: str = "dxrexperiments-torch") -> str:
        return f"{name}: {self.fps:.1f}fps, ~{self.mrays_per_sec:.1f} Million Primary Rays/s"
