"""The port's spans and counters (``utils/diagnostics.py``): they record
exactly while a ``torch.profiler`` profile is active, carry their name,
parent, inherited rid and times on the profiler's own clock, and mark the
training step's phases and the eval pipeline's sections, uploads and
event rows. CPU only, tiny sizes; nothing here is timed."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from taming_event_flow_tpu_torch.models import build_model
from taming_event_flow_tpu_torch.objectives import LossConfig
from taming_event_flow_tpu_torch.pipeline import EvalPipeline
from taming_event_flow_tpu_torch.training import (
    build_optimizer,
    init_train_state,
    make_train_step,
)
from taming_event_flow_tpu_torch.utils.diagnostics import (
    SectionTimer,
    annotate,
    count,
    recorded,
    tracing,
)

from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RES = (16, 16)
PASSES = 2
TINY = {"name": "RecEVFlowNet", "base_channels": 8, "num_encoders": 2,
        "num_residual_blocks": 1, "min_size": 4, "final_w_scale": 0.01}
CLOCK_NS = 100_000  # a span against the profiler's event for its range


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _since(t0_ns, names=None):
    """This thread's entries that started at or after ``t0_ns``."""
    me = threading.get_ident()
    return [e for e in recorded() if e.start_ns >= t0_ns and e.thread == me
            and (names is None or e.name in names)]


def test_nothing_recorded_with_the_profiler_off():
    assert not tracing()
    n = len(recorded())
    with annotate("off.a", rid=3) as a, annotate("off.b") as b:
        count("off.c", 5)
    assert a is None and b is None
    assert annotate("off.a") is annotate("off.b")  # one shared no-op
    assert len(recorded()) == n


def _span_on_a_thread():
    with annotate("on_a_thread"):
        pass


def test_spans_carry_name_parent_rid_and_times():
    t0 = time.time_ns()
    with _profiled():
        assert tracing()
        with annotate("outer", rid=7):
            with annotate("inner"):
                count("rows", 12)
            with annotate("sibling", rid=8):
                pass
            th = threading.Thread(target=_span_on_a_thread)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
    got = {e.name: e for e in _since(t0)}
    outer, inner, rows = got["outer"], got["inner"], got["rows"]
    assert (outer.parent, outer.rid, outer.value) == (None, 7, None)
    assert (inner.parent, inner.rid) == ("outer", 7)
    assert (got["sibling"].parent, got["sibling"].rid) == ("outer", 8)
    assert (rows.parent, rows.rid, rows.value) == ("inner", 7, 12)
    assert rows.start_ns == rows.end_ns
    assert outer.start_ns <= inner.start_ns <= rows.start_ns
    assert rows.end_ns <= inner.end_ns <= got["sibling"].start_ns
    assert got["sibling"].end_ns <= outer.end_ns
    # the stack is per thread: a span opened on another thread while
    # "outer" was open on this one has no parent and no rid
    (other,) = [e for e in recorded() if e.name == "on_a_thread"
                and e.start_ns >= t0]
    assert (other.parent, other.rid) == (None, None)
    assert other.thread != threading.get_ident()


def test_spans_share_the_profilers_clock():
    """Each span's start and end lie within 100 us of the profiler's own
    event for the same range: the readers put spans against the device
    trace with no conversion."""
    t0 = time.time_ns()
    names = [f"clock.{k}" for k in range(5)]
    with _profiled() as prof:
        for name in names:
            with annotate(name):
                time.sleep(0.002)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in names}
    spans = {e.name: e for e in _since(t0, set(names))}
    assert set(events) == set(spans) == set(names)
    for name in names:
        e, s = events[name], spans[name]
        assert abs(s.start_ns - e.start_ns()) < CLOCK_NS, name
        end = e.start_ns() + e.duration_ns()
        assert abs(s.end_ns - end) < CLOCK_NS, name


def _window(rng, b=1, n=32):
    ev = np.zeros((PASSES, b, n, 4), np.float32)
    ev[..., 0] = np.sort(rng.uniform(0, 1, (PASSES, b, n)), axis=-1)
    ev[..., 1] = rng.integers(0, RES[0], (PASSES, b, n))
    ev[..., 2] = rng.integers(0, RES[1], (PASSES, b, n))
    ev[..., 3] = rng.choice([-1.0, 1.0], (PASSES, b, n))
    pol = np.stack([ev[..., 3] > 0, ev[..., 3] < 0], -1).astype(np.float32)
    return {"event_list": torch.from_numpy(ev),
            "pol_mask": torch.from_numpy(pol),
            "grad_mask": torch.ones(PASSES, b, n, 1)}


def test_train_step_records_its_phases():
    torch.manual_seed(0)
    model = build_model(TINY, num_bins=2, device="cpu")
    opt = build_optimizer({"name": "Adam", "lr": 1e-3}, model.parameters(),
                          clip_grad=100.0, device="cpu")
    step = make_train_step(model, opt, LossConfig(res=RES,
                                                  passes_loss=PASSES),
                           flow_scaling=4.0, res=RES)
    state = init_train_state(model, 1, RES[0], RES[1], device="cpu")
    rng = np.random.default_rng(0)
    state, _ = step(state, _window(rng))  # untraced: records nothing
    t0 = time.time_ns()
    with _profiled():
        state, loss = step(state, _window(rng))
    assert torch.isfinite(loss) and state.step == 2
    phases = ["train.forward", "train.loss", "train.backward",
              "train.optimizer"]
    got = sorted(_since(t0, {"train.step", *phases}),
                 key=lambda e: e.start_ns)
    assert [e.name for e in got] == ["train.step"] + phases
    top = got[0]
    assert (top.parent, top.rid) == (None, 1)
    prev = top.start_ns
    for e in got[1:]:
        assert (e.parent, e.rid) == ("train.step", 1)
        assert prev <= e.start_ns <= e.end_ns <= top.end_ns
        prev = e.end_ns


def _pipe_config(windowed):
    return {
        "data": {"mode": "gtflow", "passes_loss": PASSES, "voxel": None},
        "loader": {"resolution": list(RES), "n_events_pad": 64},
        "loss": {"flow_scaling": 8, "round_ts": False},
        "metrics": {"warping": "Iterative", "name": ["FWL", "RSAT", "AEE"]},
        # a per-pass panel keeps the per-pass path
        "vis": {"store": True,
                "show": ["flow_bw"] if windowed else ["flow_bw", "events"]},
        "runtime": {},
    }


def _batches(rng, sizes):
    """Loader-like batches of ``sizes`` real events each, not yet padded to
    the bucket; the last one carries the GT flow."""
    out = []
    for n in sizes:
        ev = np.zeros((1, n, 4), np.float32)
        ev[0, :, 0] = np.sort(rng.uniform(0, 1, n))
        ev[0, :, 1] = rng.integers(0, RES[0], n)
        ev[0, :, 2] = rng.integers(0, RES[1], n)
        ev[0, :, 3] = rng.choice([-1.0, 1.0], n)
        out.append({"event_list": ev})
    out[-1]["gtflow"] = rng.normal(size=(1,) + RES + (2,)).astype(
        np.float32)
    return out


@pytest.mark.parametrize("windowed", [True, False],
                         ids=["windowed", "per_pass"])
def test_eval_pipeline_records_sections_and_counters(windowed):
    torch.manual_seed(0)
    model = build_model(TINY, num_bins=2, device="cpu")
    pipe = EvalPipeline(_pipe_config(windowed), model, device="cpu")
    assert pipe.windowed == windowed
    handed = []
    dev = pipe._dev
    pipe._dev = lambda a: (handed.append(a.nbytes), dev(a))[1]
    rng = np.random.default_rng(1)
    sizes = [[40, 25], [52, 30]]
    t0 = time.time_ns()
    with _profiled():
        for w, window in enumerate(_batches(rng, s) for s in sizes):
            for b in window:
                pipe.ingest(pipe.ensure_bucket(b), {"ts": 0.0})
            assert pipe.window_id == w
            assert pipe.boundary_metrics(window[-1], {"ts": 0.0})
    assert pipe.window_id == len(sizes)
    got = _since(t0)
    call, outer = (("window_call", "window_dispatch") if windowed
                   else ("pass_call", "pass_dispatch"))
    per = 1 if windowed else PASSES
    for w in range(len(sizes)):
        mine = [e for e in got if e.rid == w]
        calls = [e for e in mine if e.name == call]
        assert len(calls) == per and all(e.parent == outer for e in calls)
        assert len([e for e in mine if e.name == "mets_readback"]) == 1
        if windowed:
            assert [e.parent for e in mine if e.name == "window_assemble"] \
                == ["window_dispatch"]
    for name, total in (("window_call", pipe.tm.counts.get("window_call")),
                        ("pass_call", pipe.tm.counts.get("pass_call"))):
        assert len([e for e in got if e.name == name]) == (total or 0)

    def total(name):
        return sum(e.value for e in got if e.name == name)

    assert total("h2d_bytes") == sum(handed) > 0
    assert total("events") == sum(map(sum, sizes))
    assert total("slots") == len(sizes) * PASSES * pipe.n_slots


def test_section_timer_totals_are_unchanged():
    """Sections add up their host time and calls as before, with or
    without a profile; traced, each is also a span inside its time."""
    for traced in (False, True):
        tm = SectionTimer()
        t0 = time.time_ns()
        with (_profiled() if traced else contextlib.nullcontext()):
            for _ in range(3):
                with tm("a", rid=4):
                    time.sleep(0.001)
            items = list(tm.wrap(range(2), "b"))
        assert items == [0, 1]
        assert tm.counts == {"a": 3, "b": 3}
        assert set(tm.totals) == {"a", "b"} and tm.totals["a"] >= 0.003
        spans = _since(t0, {"a", "b"})
        if not traced:
            assert spans == []
            continue
        assert len(spans) == 6
        assert all(e.rid == 4 for e in spans if e.name == "a")
        span_s = sum(e.end_ns - e.start_ns for e in spans
                     if e.name == "a") * 1e-9
        assert span_s <= tm.totals["a"]
        assert "a" in tm.report() and "b" in tm.report()
