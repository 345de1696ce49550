"""Observability (counterpart of
``taming_event_flow_tpu/utils/diagnostics.py``): the run's git-diff
snapshot, device profiling with ``torch.profiler`` (a trace TensorBoard's
profiler plugin or Perfetto reads) and the wall-clock attribution of a
loop's sections."""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import time
from typing import Optional

import torch

from ..tracking.store import default_store

_SENTINEL = object()


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """Profile the region with ``torch.profiler``: CPU activity, and the
    card's kernels where one is present. On exit the trace is written
    under ``logdir`` by ``torch.profiler.tensorboard_trace_handler``
    (``<worker>.<time>.pt.trace.json``). A falsy ``logdir`` does
    nothing."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """A named range inside a :func:`profile_trace` region
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def save_diff(fname: str = "git_diff.txt", run_id: Optional[str] = None):
    """Snapshot the working tree's ``git diff`` into the active run's
    artifacts (reference ``utils/utils.py:99-105``); an empty file where
    git is missing or the directory is no repository."""
    try:
        diff = subprocess.run(
            ["git", "diff"], capture_output=True, text=True, timeout=30,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        diff = ""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, fname)
        with open(path, "w") as f:
            f.write(diff)
        try:
            default_store().log_artifact(path, run_id=run_id)
        except (RuntimeError, KeyError):
            pass


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
