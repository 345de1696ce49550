"""Terminal progress and throughput meters: the port's own copy of
``taming_event_flow_tpu/utils/progress.py`` (a dependency-free
``progress.bar.Bar`` with a Hz suffix, and the training loop's step meter).
"""

from __future__ import annotations

import sys
import time
from typing import Optional


class ProgressBar:
    """Minimal ``progress.bar.Bar`` stand-in with a Hz suffix."""

    def __init__(self, message: str = "", max: int = 100, width: int = 24,
                 stream=None):
        self.message = message
        self.max = max
        self.width = width
        self.index = 0
        self._t0 = time.perf_counter()
        self.stream = stream if stream is not None else sys.stderr

    @property
    def frequency(self) -> float:
        dt = time.perf_counter() - self._t0
        return self.index / dt if dt > 0 else 0.0

    def next(self, n: int = 1):
        self.index += n
        self._draw()

    def _draw(self):
        frac = min(self.index / self.max, 1.0) if self.max else 0.0
        filled = int(self.width * frac)
        bar = "#" * filled + "-" * (self.width - filled)
        self.stream.write(
            f"\r{self.message} |{bar}| {self.index}/{self.max} "
            f"({self.frequency:.1f} Hz)"
        )
        self.stream.flush()

    def finish(self):
        self._draw()
        self.stream.write("\n")
        self.stream.flush()


class StepMeter:
    """Sliding-average step timer: step/s + derived Mevents/s. Host clock:
    on the card it measures the loop's pace, not the device."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def steps_per_s(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    def mevents_per_s(self, events_per_step: float) -> float:
        return self.steps_per_s * events_per_step / 1e6
