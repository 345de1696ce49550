"""The program's spans and counters against a synthetic trace: device idle
inside a span, entries outside the traced stretch dropped, each reader's
arithmetic, and ``None`` where the program recorded nothing (an empty
record, no trace, or a program that keeps no record)."""

import pytest

from harness import program_spans
from harness.spec import Spec
from harness.trace import Trace
from taming_event_flow_tpu_torch.utils import diagnostics
from taming_event_flow_tpu_torch.utils.diagnostics import Entry

import tiny

NEW = ["forward_host_ms.train", "loss_host_ms.train", "backward_host_ms.train",
       "optimizer_host_ms.train", "forward_idle_ms.train",
       "loss_idle_ms.train", "backward_idle_ms.train",
       "optimizer_idle_ms.train", "assemble_idle_ms.dsec",
       "dispatch_idle_ms.eval", "window_call_ms.dsec",
       "h2d_mb_per_window.dsec", "slot_fill.eval"]
MS = 1_000_000  # ns


def _read(name, ctx):
    return Spec(tiny.ROOT, tiny.BENCH_DIR).reader(name).read(ctx)


def _span(name, parent, rid, start, end):
    return Entry(name, parent, rid, 1, start * MS, end * MS)


def _count(name, rid, at, value):
    return Entry(name, None, rid, 1, at * MS, at * MS, value)


def _trace(busy, t0, t1):
    """A stretch ``[t0, t1]`` ms whose device ran ``busy`` ms intervals."""
    ops = [("kernel", s * MS, e * MS) for s, e in busy]
    return Trace((t1 - t0) * 1e-3, ops, [], t0 * MS, t1 * MS)


@pytest.fixture
def record(monkeypatch):
    rows = []
    monkeypatch.setattr(diagnostics, "recorded", lambda: list(rows))
    return rows


def test_idle_inside_a_span():
    tr = _trace([(10, 20), (15, 25), (30, 40)], 0, 100)

    def idle_ms(a, b):
        return program_spans.idle_ns(tr, a * MS, b * MS) / MS

    assert idle_ms(0, 100) == 75
    assert idle_ms(12, 35) == 5  # 25..30
    assert idle_ms(40, 60) == 20
    assert idle_ms(31, 39) == 0


def test_train_readers(record):
    # two traced steps, each [a, a + 40]: forward 10, loss 12, backward 8,
    # optimizer 6 ms; the device busy over each step's loss and backward
    for rid, a in ((5, 100), (6, 150)):
        record.append(_span("train.step", None, rid, a, a + 40))
        t = a + 1
        for name, d in (("train.forward", 10), ("train.loss", 12),
                        ("train.backward", 8), ("train.optimizer", 6)):
            record.append(_span(name, "train.step", rid, t, t + d))
            t += d
    # a step before the stretch: dropped
    record.append(_span("train.forward", "train.step", 4, 20, 90))
    busy = [(111, 131), (161, 181)]
    ctx = {"kind": "train", "trace": _trace(busy, 100, 200),
           "trace_counts": [None, None]}
    assert _read("forward_host_ms.train", ctx) == pytest.approx(10)
    assert _read("loss_host_ms.train", ctx) == pytest.approx(12)
    assert _read("backward_host_ms.train", ctx) == pytest.approx(8)
    assert _read("optimizer_host_ms.train", ctx) == pytest.approx(6)
    assert _read("forward_idle_ms.train", ctx) == pytest.approx(10)
    assert _read("loss_idle_ms.train", ctx) == pytest.approx(0)
    assert _read("backward_idle_ms.train", ctx) == pytest.approx(0)
    assert _read("optimizer_idle_ms.train", ctx) == pytest.approx(6)
    assert _read("dispatch_idle_ms.eval", ctx) is None  # not an eval cell


def test_eval_readers(record):
    # three GT windows of 30 ms in a 100 ms stretch: assemble 10 ms, the
    # window call 15 ms, the device busy over the last 10 ms of each call
    busy = []
    for rid, a in enumerate((0, 30, 60)):
        record.append(_span("window_dispatch", None, rid, a, a + 26))
        record.append(_span("window_assemble", "window_dispatch", rid, a,
                            a + 10))
        record.append(_count("h2d_bytes", rid, a + 2, 3_000_000))
        record.append(_count("h2d_bytes", rid, a + 3, 1_000_000))
        record.append(_count("slots", rid, a + 1, 1000))
        record.append(_count("events", rid, a + 1, 600))
        record.append(_span("window_call", "window_dispatch", rid, a + 11,
                            a + 26))
        busy.append((a + 16, a + 26))
    record.append(_count("h2d_bytes", 9, 150, 10**9))  # after the stretch
    ctx = {"kind": "eval", "trace": _trace(busy, 0, 100),
           "trace_counts": [None] * 3,
           "sections": {"window_call": (0.045, 3),
                        "window_assemble": (0.030, 3)}}
    assert _read("assemble_idle_ms.dsec", ctx) == pytest.approx(10)
    assert _read("dispatch_idle_ms.eval", ctx) == pytest.approx(5)
    assert _read("window_call_ms.dsec", ctx) == pytest.approx(15)
    assert _read("h2d_mb_per_window.dsec", ctx) == pytest.approx(4)
    assert _read("slot_fill.eval", ctx) == pytest.approx(60)
    # the per-pass path: its pass calls are the dispatch
    record[:] = [_span("pass_call", "pass_dispatch", 0, 1, 9),
                 _span("pass_call", "pass_dispatch", 1, 31, 39)]
    ctx["trace_counts"] = [None] * 2
    assert _read("dispatch_idle_ms.eval", ctx) == pytest.approx(8)
    assert _read("assemble_idle_ms.dsec", ctx) is None
    assert _read("slot_fill.eval", ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_none(record, monkeypatch, name):
    kind = "train" if name.endswith(".train") else "eval"
    ctx = {"kind": kind, "trace": _trace([(0, 5)], 0, 10),
           "trace_counts": [None]}
    if name == "window_call_ms.dsec":  # reads the section, not the record
        assert _read(name, ctx) is None
        ctx["sections"] = {"window_call": (0.02, 2)}
        assert _read(name, ctx) == pytest.approx(10)
        return
    assert _read(name, ctx) is None  # an empty record
    record.append(_span("train.forward", None, 0, 1, 2))
    record.append(_span("window_call", None, 0, 1, 2))
    assert _read(name, dict(ctx, trace=None)) is None
    # a program without the record (the parent commit's)
    monkeypatch.delattr(diagnostics, "recorded")
    assert _read(name, ctx) is None
