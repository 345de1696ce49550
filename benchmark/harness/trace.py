"""The device trace of a short steady stretch, and the benchmark's spans.

:func:`traced` runs a callable under ``torch.profiler`` (CPU and CUDA
activities) and reduces the trace to what the per-layer readers and the
result line need: every device operation (kernel, copy, fill) with its
interval, the union of those intervals (``busy_s``), the length of the
stretch (``window_s``), the device time of each kernel group of
:data:`KERNEL_MAP`, and the breakdown (the device operations that took the
most time, and the longest idle gaps by the benchmark span the host was
in).

:func:`span` marks a host span of the benchmark's own loop (placing a
window, dispatching a step, reading a loss back, ingesting a batch); it is
a no-op outside a traced stretch.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Callable, List, Optional, Tuple

import torch

# which device kernels belong to which layer: a kernel whose name matches
# the pattern is filed under the key (the port's csrc/warp_kernels.cu)
KERNEL_MAP = {
    "warp": re.compile(r"\b(splat_scan_kernel|splat_kernel|"
                       r"splat_finish_kernel|gather_kernel|"
                       r"gather_fused_kernel|row_gather_kernel)\b"),
}

SPAN_PREFIX = "bench."
# what ran on the device; the trace also mirrors host annotations there
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")

_ACTIVE = []  # set while a stretch is traced


@contextlib.contextmanager
def span(name: str):
    """A named host span of the benchmark's loop, recorded while traced."""
    if not _ACTIVE:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, list]:
    """Total covered length of ``(start, end)`` intervals and the merged
    intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


class Trace:
    """What a traced stretch gives the readers (times in seconds)."""

    def __init__(self, window_s: float, ops: List[Tuple[str, int, int]],
                 spans: List[Tuple[str, int, int]], t0_ns: int, t1_ns: int):
        self.window_s = window_s
        self.ops = ops
        busy_ns, merged = _union([(s, e) for _, s, e in ops])
        self.busy_s = busy_ns * 1e-9
        self.merged = merged
        self.spans = spans
        self.t0_ns, self.t1_ns = t0_ns, t1_ns

    def kernel_s(self, group: str) -> float:
        """Device seconds of the kernels :data:`KERNEL_MAP` files under
        ``group`` (their own intervals, summed)."""
        pat = KERNEL_MAP[group]
        return sum(e - s for n, s, e in self.ops if pat.search(n)) * 1e-9

    def device_ops(self, top: int = 10):
        by = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0) + (e - s)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], v * 1e-9] for n, v in rows]

    def idle_gaps(self, top: int = 10):
        """Idle device time between the first and the last operation of the
        stretch, and before the first, filed under the innermost benchmark
        span the host was in at the middle of each gap."""
        gaps, prev = [], self.t0_ns
        for s, e in self.merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1_ns > prev:
            gaps.append((prev, self.t1_ns))
        by = {}
        for s, e in gaps:
            mid = (s + e) // 2
            name = "outside_spans"
            best = None
            for n, a, b in self.spans:
                if a <= mid <= b and (best is None or b - a < best):
                    name, best = n[len(SPAN_PREFIX):], b - a
            by[name] = by.get(name, 0) + (e - s)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, v * 1e-9] for n, v in rows]


def _annotation(e) -> bool:
    """A host span (``record_function``), whose mirror the trace also files
    on the device."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() == "user_annotation"
    return e.is_user_annotation()


def _device_op(e, annotations) -> bool:
    """An operation that ran on the device: a kernel, a copy or a fill, not
    the device-side mirror of a host span."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_OPS
    return not e.is_user_annotation() and e.name() not in annotations


def traced(fn: Callable[[], None], device) -> Optional[Trace]:
    """Run ``fn`` (a short steady stretch of the cell's loop, which must end
    with the device idle) under the profiler and reduce its trace; ``None``
    when the trace holds no device operation (the profiler saw no card)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        _ACTIVE.append(True)
        try:
            w0 = time.perf_counter()
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - w0
        finally:
            _ACTIVE.clear()
    ops, spans, annotations = [], [], set()
    first = None
    events = prof.profiler.kineto_results.events()
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            if _annotation(e):
                annotations.add(e.name())
            if e.name().startswith(SPAN_PREFIX):
                s = e.start_ns()
                spans.append((e.name(), s, s + e.duration_ns()))
                first = s if first is None else min(first, s)
    for e in events:
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and _device_op(e, annotations)):
            s = e.start_ns()
            ops.append((e.name(), s, s + e.duration_ns()))
    if not ops:
        return None
    start = min(first if first is not None else ops[0][1],
                min(s for _, s, _ in ops))
    return Trace(window_s, ops, spans, start, start + int(window_s * 1e9))
