"""The program's own spans and counters over a traced stretch, against the
device's timeline.

The port records a span or counter (``utils/diagnostics.py: Entry``:
name, parent, rid, thread, start and end in ns, a counter's value) while a
``torch.profiler`` profile is active, on the clock of the profiler's own
events, the clock :class:`harness.trace.Trace` holds its device intervals
on. The readers keep the entries that started inside the stretch
(``[t0_ns, t1_ns]``) and divide by the traced steps or GT windows
(``len(ctx["trace_counts"])``). Every function returns ``None`` where the
program recorded nothing: no trace, or a program without the record.
"""

from __future__ import annotations

from typing import Iterable, List, Optional


def entries(ctx) -> Optional[List]:
    """The program's entries that started inside the traced stretch."""
    tr = ctx.get("trace")
    if tr is None or not ctx.get("trace_counts"):
        return None
    try:
        from taming_event_flow_tpu_torch.utils.diagnostics import recorded
    except ImportError:  # a program that keeps no record
        return None
    rows = [e for e in recorded() if tr.t0_ns <= e.start_ns <= tr.t1_ns]
    return rows or None


def idle_ns(tr, start: int, end: int) -> int:
    """Device idle inside ``[start, end]``: its length less its overlap
    with the union of the device's operations (``tr.merged``, sorted)."""
    busy = 0
    for s, e in tr.merged:
        if s >= end:
            break
        if e > start:
            busy += min(e, end) - max(s, start)
    return (end - start) - busy


def span_ms(ctx, names: Iterable[str], idle: bool = False):
    """The mean per traced step or window of the host milliseconds inside
    the spans named ``names`` (with ``idle``, of the device's idle
    milliseconds inside them); ``None`` where no such span was recorded."""
    rows = entries(ctx)
    if rows is None:
        return None
    names = set(names)
    spans = [e for e in rows if e.name in names and e.value is None]
    if not spans:
        return None
    tr = ctx["trace"]
    if idle:
        total = sum(idle_ns(tr, e.start_ns, e.end_ns) for e in spans)
    else:
        total = sum(e.end_ns - e.start_ns for e in spans)
    return total * 1e-6 / len(ctx["trace_counts"])


def counter_sum(ctx, name: str):
    """The sum of the counter ``name`` over the traced stretch; ``None``
    where it was not counted."""
    rows = entries(ctx)
    if rows is None:
        return None
    values = [e.value for e in rows if e.name == name and e.value is not None]
    return sum(values) if values else None
