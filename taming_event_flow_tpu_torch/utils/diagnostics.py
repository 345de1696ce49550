"""Wall-clock attribution of host loops (counterpart of
``taming_event_flow_tpu/utils/diagnostics.py:SectionTimer``)."""

from __future__ import annotations

import contextlib
import time

_SENTINEL = object()


class SectionTimer:
    """Accumulating wall-clock breakdown of a host loop::

        tm = SectionTimer()
        with tm("wait_batch"):
            batch = next(stream)
        print(tm.report())

    Times are host times: a section that launches CUDA work without a
    synchronise measures the enqueue, not the device.
    """

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def wrap(self, iterable, name: str):
        """Yield from ``iterable``, attributing each ``next()`` wait to
        ``name``."""
        it = iter(iterable)
        while True:
            with self(name):
                item = next(it, _SENTINEL)
            if item is _SENTINEL:
                return
            yield item

    def report(self) -> str:
        total = sum(self.totals.values())
        lines = [f"section breakdown ({total:.2f}s timed):"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"  {name:24s} {t:9.2f}s  ({t / max(n, 1) * 1e3:8.2f} ms "
                f"x {n})"
            )
        return "\n".join(lines)
