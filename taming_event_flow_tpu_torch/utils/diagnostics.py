"""Observability (counterpart of
``taming_event_flow_tpu/utils/diagnostics.py``): the run's git-diff
snapshot, device profiling with ``torch.profiler`` (a trace TensorBoard's
profiler plugin or Perfetto reads), the program's own spans and counters,
and the wall-clock attribution of a loop's sections.

Spans (:func:`annotate`) and counters (:func:`count`) record exactly while
a ``torch.profiler`` profile is active (:func:`profile_trace`, or any
caller's): each span is a named range in the profiler's trace and an
:class:`Entry` in a bounded in-memory record (:func:`recorded`),
timed on the clock of the profiler's own events (the Unix clock,
``time.time_ns``), so that a reader can put it against the device's
timeline. With the profiler off a span costs one flag check, a counter
one more thread-local read (:func:`taped_counts` keeps a CUDA graph's
counters for its replays)."""

from __future__ import annotations

import collections
import contextlib
import os
import subprocess
import tempfile
import threading
import time
from typing import List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from ..tracking.store import default_store

_SENTINEL = object()

RECORD_LEN = 1 << 16  # entries kept; the oldest drop first


class Entry(NamedTuple):
    """One span or counter of the record. ``parent``: the innermost span
    open on the same thread when it opened; ``rid``: the request (a
    training step, a GT window) it belongs to, inherited from the parent
    when not given; times in ns on the profiler's clock. A counter is a
    zero-length entry carrying its ``value`` (``None`` on a span)."""

    name: str
    parent: Optional[str]
    rid: object
    thread: int
    start_ns: int
    end_ns: int
    value: Optional[float] = None


# the profiler's range: ``record_function``'s C++ core without its
# operator-dispatched enter and exit (about 1 us a span against 20, and its
# times within a few us of the span's own)
_ProfilerRange = torch._C._profiler._RecordFunctionFast

_record: collections.deque = collections.deque(maxlen=RECORD_LEN)


class _Local(threading.local):
    def __init__(self):
        self.open = []  # this thread's open spans, innermost last
        self.tape = None  # this thread's counters while taped


_local = _Local()


def tracing() -> bool:
    """Is a ``torch.profiler`` profile active (do spans and counters
    record)? A caller skips computing a counter's value when not."""
    return _autograd_profiler._is_profiler_enabled


def recorded() -> List[Entry]:
    """A snapshot of the record, oldest first by end (a span is appended
    when it closes)."""
    return list(_record)


class _Off:
    """What :func:`annotate` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rid", "parent", "start_ns", "_range")

    def __init__(self, name: str, rid):
        self.name, self.rid = name, rid

    def __enter__(self):
        stack = _local.open
        top = stack[-1] if stack else None
        self.parent = top.name if top is not None else None
        if self.rid is None and top is not None:
            self.rid = top.rid
        self._range = _ProfilerRange(self.name)
        self._range.__enter__()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _local.open.pop()
        self._range.__exit__(*exc)
        _record.append(Entry(self.name, self.parent, self.rid,
                             threading.get_ident(), self.start_ns, end_ns))
        return False


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


def annotate(name: str, rid=None):
    """A named span: while a profile is active, a range of the profiler's
    trace and an :class:`Entry` of the record (``rid`` inherited from the
    enclosing span when ``None``); otherwise a shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, rid)


def count(name: str, n) -> None:
    """Record the counter ``name`` at ``n`` inside the innermost open span
    (its parent and rid) while a profile is active; inside
    :func:`taped_counts`, append ``(name, n)`` to its tape instead."""
    tape = _local.tape
    if tape is not None:
        tape.append((name, n))
        return
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _local.open
    top = stack[-1] if stack else None
    t = time.time_ns()
    _record.append(Entry(name, top.name if top is not None else None,
                         top.rid if top is not None else None,
                         threading.get_ident(), t, t, n))


@contextlib.contextmanager
def taped_counts():
    """Collect this thread's counters as ``(name, n)`` in the list it
    yields, profiled or not, instead of recording them: the counters of
    work that runs later, as a CUDA graph's capture, which each replay
    records again (:func:`count`)."""
    outer, _local.tape = _local.tape, []
    try:
        yield _local.tape
    finally:
        _local.tape = outer


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
    synchronise measures the enqueue, not the device. Each section is also
    an :func:`annotate` span (with ``rid``, when given).
    """

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str, rid=None):
        t0 = time.perf_counter()
        try:
            with annotate(name, rid):
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
