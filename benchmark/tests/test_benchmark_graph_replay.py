"""``graph_replay_share.train`` against a synthetic record: the program's
counter ``train_graph_replays`` over the traced steps, in percent, entries
outside the stretch dropped, and ``None`` where the program recorded no
such counter (the parent commit's program) or kept no record."""

import pytest

from harness.spec import Spec
from harness.trace import Trace
from taming_event_flow_tpu_torch.utils import diagnostics
from taming_event_flow_tpu_torch.utils.diagnostics import Entry

import tiny

NAME = "graph_replay_share.train"
MS = 1_000_000  # ns


def _read(ctx):
    return Spec(tiny.ROOT, tiny.BENCH_DIR).reader(NAME).read(ctx)


def _span(name, parent, rid, start, end):
    return Entry(name, parent, rid, 1, start * MS, end * MS)


def _count(name, rid, at, value):
    return Entry(name, None, rid, 1, at * MS, at * MS, value)


def _ctx(steps, kind="train"):
    ops = [("kernel", 100 * MS, 240 * MS)]
    return {"kind": kind, "trace": Trace(0.15, ops, [], 100 * MS, 250 * MS),
            "trace_counts": [None] * steps}


@pytest.fixture
def record(monkeypatch):
    rows = []
    monkeypatch.setattr(diagnostics, "recorded", lambda: list(rows))
    return rows


def _steps(record):
    # a warm-up run eagerly (its phase spans), then a capture and a replay
    # (the counter, one a replayed step)
    record.append(_span("train.step", None, 7, 100, 140))
    record.append(_span("train.forward", "train.step", 7, 101, 110))
    for rid, a in ((8, 150), (9, 200)):
        record.append(_span("train.step", None, rid, a, a + 30))
        record.append(_span("train.replay", "train.step", rid, a + 1, a + 5))
        record.append(_count("train_graph_replays", rid, a + 5, 1))
    record.append(_count("train_graph_captures", 8, 151, 1))
    record.append(_count("train_graph_replays", 10, 260, 1))  # after it


@pytest.mark.parametrize("steps, share", [(3, 200 / 3), (2, 100.0)])
def test_replays_over_traced_steps(record, steps, share):
    _steps(record)
    assert _read(_ctx(steps)) == pytest.approx(share)


def test_not_a_training_cell(record):
    _steps(record)
    assert _read(_ctx(2, kind="eval")) is None


def test_nothing_to_read(record, monkeypatch):
    assert _read(_ctx(2)) is None  # an empty record
    # the parent's program: the step's spans, no counter
    record.append(_span("train.step", None, 7, 100, 140))
    record.append(_span("train.backward", "train.step", 7, 120, 130))
    assert _read(_ctx(2)) is None
    assert _read(dict(_ctx(2), trace=None)) is None
    monkeypatch.delattr(diagnostics, "recorded")  # a program without it
    assert _read(_ctx(2)) is None
