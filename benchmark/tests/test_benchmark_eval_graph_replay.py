"""``graph_replay_share.eval`` against a synthetic record: the program's
counter ``eval_graph_replays`` over the traced GT windows, in percent,
entries outside the stretch dropped, and ``None`` for a training cell,
where the program recorded no such counter (the parent commit's program,
or the per-pass path) or kept no record."""

import pytest

from harness.spec import Spec
from harness.trace import Trace
from taming_event_flow_tpu_torch.utils import diagnostics
from taming_event_flow_tpu_torch.utils.diagnostics import Entry

import tiny

NAME = "graph_replay_share.eval"
MS = 1_000_000  # ns


def _read(ctx):
    return Spec(tiny.ROOT, tiny.BENCH_DIR).reader(NAME).read(ctx)


def _span(name, parent, rid, start, end):
    return Entry(name, parent, rid, 1, start * MS, end * MS)


def _count(name, parent, rid, at, value):
    return Entry(name, parent, rid, 1, at * MS, at * MS, value)


def _ctx(windows, kind="eval"):
    ops = [("kernel", 100 * MS, 240 * MS)]
    return {"kind": kind, "trace": Trace(0.15, ops, [], 100 * MS, 250 * MS),
            "trace_counts": [None] * windows}


@pytest.fixture
def record(monkeypatch):
    rows = []
    monkeypatch.setattr(diagnostics, "recorded", lambda: list(rows))
    return rows


def _windows(record, eager=0):
    """``eager`` windows that ran their step eagerly (its model spans under
    ``window_call``), then replayed ones up to three (the counter, one a
    replayed window), and one replay after the stretch."""
    for rid, a in enumerate((100, 140, 180)):
        record.append(_span("window_dispatch", None, rid, a, a + 30))
        record.append(_span("window_call", "window_dispatch", rid, a + 10,
                            a + 20))
        if rid < eager:
            record.append(_span("eraft.refine", "window_call", rid, a + 11,
                                a + 19))
        else:
            record.append(_span("eval.replay", "window_call", rid, a + 11,
                                a + 19))
            record.append(_count("eval_graph_replays", "window_call", rid,
                                 a + 19, 1))
    record.append(_count("eval_graph_replays", "window_call", 3, 260, 1))


@pytest.mark.parametrize("eager, share", [(0, 100.0), (1, 200 / 3),
                                          (2, 100 / 3)])
def test_replays_over_traced_windows(record, eager, share):
    _windows(record, eager)
    assert _read(_ctx(3)) == pytest.approx(share)


def test_not_an_eval_cell(record):
    _windows(record)
    assert _read(_ctx(3, kind="train")) is None


def test_nothing_to_read(record, monkeypatch):
    assert _read(_ctx(3)) is None  # an empty record
    # the parent's program, or a step that never replayed: the window's
    # spans and no counter
    _windows(record, eager=3)
    assert _read(_ctx(3)) is None
    assert _read(dict(_ctx(3), trace=None)) is None
    monkeypatch.delattr(diagnostics, "recorded")  # a program without it
    assert _read(_ctx(3)) is None
