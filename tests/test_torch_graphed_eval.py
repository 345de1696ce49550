"""The eval window step's CUDA-graph policy (``training/graphed.py``,
``training/step.py: make_eval_window_step``) through ``EvalPipeline`` on
the CPU, with the stand-in graph of ``test_torch_graphed_step.py``: on the
CPU the window step stays eager; on the card a signature's first window
runs eagerly, its second captures and replays, later ones replay; replayed
windows equal eager ones bit for bit over several windows and across a
sequence rollover, for a tiny RecEVFlowNet and a tiny E-RAFT, on the
float32 event list and on the u32 wire with the rectification lookup; the
carry, flow and metrics a reader holds keep their values across the next
replay; bucket growth drops the graphs; a step with an event mesh stays
eager; ``ops.LAUNCHES``, E-RAFT's ``corr_taps``, the spans and both
counters advance on a replay.

The windows come from the benchmark's traffic generator (a DSEC-like
rectified sequence cut to 32 x 32, P = 2). Tiny sizes; nothing timed."""

import contextlib
import gc
import os
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from taming_event_flow_tpu_torch.metrics import (
    IterativeValidation,
    ValConfig,
)
from taming_event_flow_tpu_torch.models import build_model
from taming_event_flow_tpu_torch.ops import LAUNCHES
from taming_event_flow_tpu_torch.pipeline import EvalPipeline
from taming_event_flow_tpu_torch.training import graphed, pad_batch_events
from taming_event_flow_tpu_torch.training.step import make_eval_window_step
from taming_event_flow_tpu_torch.utils.diagnostics import recorded

from .test_torch_graphed_step import FakeGraph, _flat
from .torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmark")
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

from harness import events  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")

RES = (32, 32)
PASSES = 2
SLOTS = 256
MODELS = {
    "RecEVFlowNet": {"name": "RecEVFlowNet", "base_channels": 8,
                     "num_encoders": 2, "num_residual_blocks": 1,
                     "min_size": 4},
    # every pyramid level at least 2 wide: 2 levels at 1/8 of 32 x 32
    "ERAFT": {"name": "ERAFT", "iters": 2, "corr_levels": 2,
              "corr_radius": 1, "hidden_dim": 16, "context_dim": 16,
              "fnet_dim": 32},
}
WIRES = {"f32": {"u32_wire": False}, "u32": {}}
SPLATS = 2  # launches the counted window metrics add to LAUNCHES a window


def _sequence(seed=3, pool=3):
    mix = {"kind": "eval", "resolution": list(RES), "passes": PASSES,
           "slots": SLOTS, "events_per_pass": [60, 120], "pool": pool,
           "shapes": [2, 3], "speed_px_per_pass": [0.5, 2.0],
           "noise_share": 0.1, "rectify": {"k": -0.05}}
    return events.eval_sequence(mix, seed)


def _config(wire):
    return {
        "loader": {"resolution": list(RES), "n_events_pad": SLOTS,
                   "augment": []},
        "data": {"passes_loss": PASSES, "mode": "gtflow", "voxel": None},
        "loss": {"flow_scaling": 4.0, "round_ts": False},
        "metrics": {"warping": "Iterative", "name": ["FWL", "RSAT", "AEE"]},
        "vis": {"enabled": False, "store": True, "show": ["flow_bw"]},
        "runtime": dict(WIRES[wire]),
    }


def _pipeline(name, wire, graphs, monkeypatch, seq, model=None):
    """An ``EvalPipeline`` of the tiny ``name`` on the sequence's
    rectification tables; with ``graphs`` its window step takes the card's
    path, its graphs made by :class:`FakeGraph`."""
    if model is None:
        model = build_model(MODELS[name], num_bins=2, device="cpu", seed=1)
    if graphs:
        monkeypatch.setattr(graphed, "uses_graphs", lambda params: True)
    pipe = EvalPipeline(_config(wire), model, device="cpu")
    if graphs:
        pipe._window_step.graphs.graph_cls = FakeGraph
    pipe.cur_ridx = seq.rect.remap_idx
    if pipe.u32_wire:
        pipe.cur_rect = seq.rect.rect_map
    return pipe


def _run(pipe, seq, n_windows, start=0):
    """``n_windows`` GT windows from window ``start``, as the eval CLI
    feeds them (a fresh sequence each time the pool wraps). Returns each
    window's ``(flow_fine, carry, metrics)`` as the pipeline hands them
    back."""
    meta = {"sequence": "t", "ts": seq.meta_ts}
    out = []
    n = len(seq.batches)
    with torch.inference_mode():
        for w in range(start, start + n_windows):
            for k in range(PASSES):
                pos = (w * PASSES + k) % n
                if pos == 0:
                    pipe.start_sequence()
                batch = pipe.ensure_bucket(seq.batches[pos])
                flow = pipe.ingest(batch, meta)
            mets, flow_bw = pipe.boundary_outputs(batch, meta)
            mets["flow_bw"] = flow_bw
            out.append((flow, pipe.carry, mets))
    return out


def _graphs(pipe):
    return [g for g in pipe._window_step.graphs.graphs.values()
            if g is not None]


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.int16) if t.element_size() == 2 else t.view(
        torch.int32) if t.element_size() == 4 else t


def _equal(a, b):
    ta, tb = _flat(a), _flat(b)
    return len(ta) == len(tb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(ta, tb))


@pytest.mark.parametrize("name", MODELS)
def test_the_cpu_keeps_the_eager_step(name, monkeypatch):
    seq = _sequence()
    pipe = _pipeline(name, "u32", False, monkeypatch, seq)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        _run(pipe, seq, 3)
    names = {e.name for e in recorded() if e.start_ns >= t0}
    assert "window_call" in names and "eval.replay" not in names
    assert not pipe._window_step.graphs.graphs


@pytest.mark.parametrize("name", MODELS)
def test_first_window_eager_second_captures_later_replay(name, monkeypatch):
    seq = _sequence()
    pipe = _pipeline(name, "u32", True, monkeypatch, seq)
    _run(pipe, seq, 1)
    assert not _graphs(pipe)  # the warm-up ran eagerly
    assert len(pipe._window_step.graphs.graphs) == 1
    _run(pipe, seq, 1, start=1)
    (g,) = _graphs(pipe)
    assert g.graph.replays == 1  # captured, then replayed for this window
    # a rollover and the windows after it replay the same graph
    _run(pipe, seq, 4, start=2)
    assert _graphs(pipe) == [g] and g.graph.replays == 5


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("name", MODELS)
def test_replayed_windows_equal_eager_ones(name, wire, monkeypatch):
    """Six windows over a three-window sequence (so across two
    ``start_sequence`` rollovers): every window's flow, carry, metrics and
    ``flow_bw``, and the last slot state, bit for bit."""
    seq = _sequence()
    model = build_model(MODELS[name], num_bins=2, device="cpu", seed=1)
    eager = _pipeline(name, wire, False, monkeypatch, seq, model)
    want = _run(eager, seq, 6)
    replayed = _pipeline(name, wire, True, monkeypatch, seq, model)
    got = _run(replayed, seq, 6)
    assert len(_graphs(replayed)) == 1
    assert all(torch.isfinite(m["fwl"]) for _, _, m in want)
    for w, (a, b) in enumerate(zip(got, want)):
        assert _equal(a, b), w
    assert _equal(replayed.vstate.tensors(), eager.vstate.tensors())
    assert replayed.vstate.pass_idx == eager.vstate.pass_idx == PASSES


@pytest.mark.parametrize("name", MODELS)
def test_outputs_held_across_the_next_replay_keep_their_values(
        name, monkeypatch):
    """What a reader holds (the readback thread reads a window's metrics
    after the next window is issued) aliases no graph buffer and keeps its
    values; the slot state is the graph's own."""
    seq = _sequence()
    pipe = _pipeline(name, "u32", True, monkeypatch, seq)
    _run(pipe, seq, 2)
    (held,) = _run(pipe, seq, 1, start=2)
    kept = [t.clone() for t in _flat(held)]
    (g,) = _graphs(pipe)
    buffers = {t.data_ptr() for t in _flat(g.out) + _flat(g.inputs)}
    assert not buffers & {t.data_ptr() for t in _flat(held)}
    assert {t.data_ptr() for t in pipe.vstate.tensors()} <= buffers
    replays = g.graph.replays
    (after,) = _run(pipe, seq, 1, start=3)
    assert g.graph.replays == replays + 1
    assert all(torch.equal(a, b) for a, b in zip(_flat(held), kept))
    assert not _equal(after[2], held[2])  # the next window's own


@pytest.mark.parametrize("name", MODELS)
def test_bucket_growth_drops_the_graphs(name, monkeypatch):
    seq = _sequence()
    pipe = _pipeline(name, "u32", True, monkeypatch, seq)
    _run(pipe, seq, 3)
    old = pipe._window_step.graphs
    assert len(_graphs(pipe)) == 1
    grown = [pad_batch_events(b, SLOTS + 64) for b in seq.batches]
    seq.batches[:] = grown
    with pytest.warns(UserWarning, match="bucket grew"):
        _run(pipe, seq, 1, start=3)
    assert pipe.n_slots == SLOTS + 64
    assert pipe._window_step.graphs is not old
    assert not _graphs(pipe)  # the new bucket warms up anew
    pipe._window_step.graphs.graph_cls = FakeGraph
    _run(pipe, seq, 2, start=4)
    (g,) = _graphs(pipe)
    assert g.graph.replays == 2


@pytest.mark.parametrize("name", MODELS)
def test_a_mesh_step_stays_eager(name, monkeypatch):
    """A window step with an event mesh (its shards and reducers run
    collectives) runs eagerly, every call, on the card's path too."""
    from taming_event_flow_tpu_torch.parallel import eval as par_eval

    monkeypatch.setattr(par_eval, "shard_eval_window",
                        lambda evs, pols, mesh: (evs, pols))
    monkeypatch.setattr(graphed, "uses_graphs", lambda params: True)
    model = build_model(MODELS[name], num_bins=2, device="cpu", seed=1)
    val = IterativeValidation(ValConfig(res=RES, passes=PASSES), 1, 64,
                              "cpu")
    step = make_eval_window_step(model, val, 4.0, reset_first=True,
                                 mesh=object())
    step.graphs.graph_cls = FakeGraph
    gen = torch.Generator().manual_seed(0)
    evs = torch.zeros(PASSES, 1, 64, 4)
    evs[..., 0] = torch.rand(PASSES, 1, 64, generator=gen)
    evs[..., 1:3] = torch.randint(0, RES[0], (PASSES, 1, 64, 2),
                                  generator=gen).float()
    evs[..., 3] = 1.0
    vstate = val.init()
    carry = model.init_state(1, *RES)
    for _ in range(3):
        vstate, carry, _ = step(vstate, carry, None, evs, None, None)
    assert not step.graphs.graphs


@pytest.mark.parametrize("name", MODELS)
def test_launches_counters_and_spans_advance_on_a_replay(name,
                                                          monkeypatch):
    """Per window: the launches the (counted) window metrics make, E-RAFT's
    ``corr_taps`` and the spans under ``window_call``: the warm-up's model
    spans, then ``eval.capture`` and ``eval.replay``, then ``eval.replay``
    alone; the counters at one capture and a replay a replayed window."""
    metrics = EvalPipeline.window_metrics

    def counted(self, vstate, gtflow):
        LAUNCHES["splat_bilinear"] += SPLATS
        return metrics(self, vstate, gtflow)

    monkeypatch.setattr(EvalPipeline, "window_metrics", counted)
    seq = _sequence()
    pipe = _pipeline(name, "u32", True, monkeypatch, seq)
    seen, launched = [], []
    for w in range(4):
        before = LAUNCHES["splat_bilinear"]
        t0 = time.time_ns()
        with profile(activities=[ProfilerActivity.CPU]):
            _run(pipe, seq, 1, start=w)
        launched.append(LAUNCHES["splat_bilinear"] - before)
        seen.append([e for e in recorded() if e.start_ns >= t0])
    assert launched == [SPLATS] * 4
    (g,) = _graphs(pipe)
    assert g.launches["splat_bilinear"] == SPLATS

    def counted_sum(rows, name):
        return sum(e.value for e in rows if e.name == name
                   and e.value is not None)

    def under_call(rows):
        return [e.name for e in sorted(rows, key=lambda e: e.start_ns)
                if e.parent == "window_call" and e.value is None]

    assert [counted_sum(s, "eval_graph_captures") for s in seen] == \
        [0, 1, 0, 0]
    assert [counted_sum(s, "eval_graph_replays") for s in seen] == \
        [0, 1, 1, 1]
    assert under_call(seen[1]) == ["eval.capture", "eval.replay"]
    assert under_call(seen[2]) == under_call(seen[3]) == ["eval.replay"]
    if name == "ERAFT":
        assert under_call(seen[0]) == ["eraft.encode", "eraft.corr",
                                       "eraft.refine", "eraft.upsample"] \
            * PASSES
        cfg = MODELS[name]
        taps = (RES[0] // 8) * (RES[1] // 8) * cfg["corr_levels"] * 9
        per_window = PASSES * cfg["iters"] * taps
        assert [counted_sum(s, "corr_taps") for s in seen] == \
            [per_window] * 4
        replayed = [e for e in seen[3] if e.name == "corr_taps"]
        assert {e.parent for e in replayed} == {"eval.replay"}
    else:
        assert under_call(seen[0]) == []


def test_no_garbage_collection_inside_a_capture(monkeypatch):
    """``CudaGraph.capture`` runs its work with the garbage collector off
    (a collection could free a dead graph's memory pool, which a capture
    forbids) and restores it after, also when the capture raises."""
    seen = []

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode=None):
        seen.append(capture_error_mode)
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    g = graphed.CudaGraph()
    assert gc.isenabled()
    assert g.capture(lambda: gc.isenabled()) is False
    assert gc.isenabled() and seen == ["thread_local"]

    def fails():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        g.capture(fails)
    assert gc.isenabled()
