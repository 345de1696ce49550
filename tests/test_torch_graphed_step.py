"""The train step's CUDA-graph policy (``training/graphed.py``) on the CPU,
with a stand-in for the graph: on the CPU the step stays eager; on the card
a signature's first call runs eagerly, its second captures and replays, and
later ones replay; a new signature captures anew, interleaved signatures
capture once each, and past the bound a signature runs eagerly while the
kept graphs stay; the graphs share the first one's memory pool; the loss
and carry handed back alias no graph buffer; ``p.grad`` is bound to
the graph that ran; ``ops.LAUNCHES`` and the counters advance on replay.

The stand-in runs the captured step at capture, and again at each replay,
writing the results into the tensors the capture returned, as a CUDA
graph's replay rewrites its static outputs. Tiny sizes; nothing timed."""

import copy
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from taming_event_flow_tpu_torch.models import build_model
from taming_event_flow_tpu_torch.objectives import LOSS_REGISTRY, LossConfig
from taming_event_flow_tpu_torch.ops import LAUNCHES
from taming_event_flow_tpu_torch.training import (
    build_optimizer,
    graphed,
    init_train_state,
    make_train_step,
)
from taming_event_flow_tpu_torch.utils.diagnostics import (
    recorded,
    taped_counts,
)

from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RES = (16, 16)
PASSES = 2
TINY = {"name": "RecEVFlowNet", "base_channels": 8, "num_encoders": 2,
        "num_residual_blocks": 1, "min_size": 4, "final_w_scale": 0.01}
WARPINGS = ["Iterative", "Linear"]
SPLATS = 3  # launches the counted loss adds to LAUNCHES a step
PHASES = ["train.forward", "train.loss", "train.backward", "train.optimizer"]


class FakeGraph:
    """A stand-in for ``graphed.CudaGraph``: ``capture`` runs ``fn`` and
    keeps its result; ``replay`` runs it again, its launches and counters
    unrecorded (a replay's are the capture's, which the step adds), and
    copies the new result into the kept tensors."""

    def __init__(self):
        self.replays = 0

    def capture(self, fn, pool=None):
        self.fn, self.pool_in = fn, pool
        self.out = fn()
        return self.out

    def pool(self):
        return self.pool_in or ("pool of", self)

    def replay(self):
        before = dict(LAUNCHES)
        with taped_counts():
            new = self.fn()
        LAUNCHES.update(before)
        for kept, got in zip(_flat(self.out), _flat(new)):
            kept.copy_(got)
        self.replays += 1


def _flat(out):
    """The tensors of an output tree, in order."""
    leaves = []
    graphed._flatten(out, leaves)
    return [t for t in leaves if torch.is_tensor(t)]


def _window(seed, n=32):
    rng = np.random.default_rng(seed)
    ev = np.zeros((PASSES, 1, n, 4), np.float32)
    ev[..., 0] = np.sort(rng.uniform(0, 1, (PASSES, 1, n)), axis=-1)
    ev[..., 1] = rng.integers(0, RES[0], (PASSES, 1, n))
    ev[..., 2] = rng.integers(0, RES[1], (PASSES, 1, n))
    ev[..., 3] = rng.choice([-1.0, 1.0], (PASSES, 1, n))
    pol = np.stack([ev[..., 3] > 0, ev[..., 3] < 0], -1).astype(np.float32)
    return {"event_list": torch.from_numpy(ev),
            "pol_mask": torch.from_numpy(pol),
            "grad_mask": torch.ones(PASSES, 1, n, 1)}


def _counted(warping):
    loss = LOSS_REGISTRY[warping]

    def counted(*args, **kwargs):
        LAUNCHES["splat_bilinear"] += SPLATS
        return loss(*args, **kwargs)

    return counted


def _trainer(warping, graphs, monkeypatch, model=None):
    """``(model, step, state)``; with ``graphs`` the step takes the card's
    path, its graphs made by :class:`FakeGraph`."""
    if model is None:
        torch.manual_seed(0)
        model = build_model(TINY, num_bins=2, device="cpu")
    opt = build_optimizer({"name": "Adam", "lr": 1e-3}, model.parameters(),
                          clip_grad=100.0, device="cpu")
    monkeypatch.setitem(LOSS_REGISTRY, "counted", _counted(warping))
    step = make_train_step(model, opt, LossConfig(res=RES,
                                                  passes_loss=PASSES),
                           "counted", flow_scaling=4.0, res=RES)
    if graphs:
        monkeypatch.setattr(graphed, "uses_graphs", lambda params: True)
        step.graphs.graph_cls = FakeGraph
    return model, step, init_train_state(model, 1, RES[0], RES[1],
                                         device="cpu")


def _graphs(step):
    return [g.graph for g in step.graphs.graphs.values() if g is not None]


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("warping", WARPINGS)
def test_the_cpu_keeps_the_eager_step(warping, monkeypatch):
    model, step, state = _trainer(warping, False, monkeypatch)
    assert not graphed.uses_graphs(list(model.parameters()))
    for i in range(3):
        t0 = time.time_ns()
        with profile(activities=[ProfilerActivity.CPU]):
            state, loss = step(state, _window(i))
        names = [e.name for e in recorded() if e.start_ns >= t0]
        assert all(names.count(p) == 1 for p in PHASES), names
        assert "train.replay" not in names
    assert torch.isfinite(loss) and state.step == 3
    assert not step.graphs.graphs


@pytest.mark.parametrize("warping", WARPINGS)
def test_first_call_eager_second_captures_later_replay(warping,
                                                       monkeypatch):
    _, step, state = _trainer(warping, True, monkeypatch)
    state, _ = step(state, _window(0))
    assert not _graphs(step)  # the warm-up ran eagerly
    state, _ = step(state, _window(1))
    (g,) = _graphs(step)
    assert g.replays == 1  # captured, then replayed for this step
    for i in range(2, 5):
        state, _ = step(state, _window(i))
    assert _graphs(step) == [g] and g.replays == 4 and state.step == 5


@pytest.mark.parametrize("warping", WARPINGS)
def test_graphed_steps_equal_eager_ones(warping, monkeypatch):
    torch.manual_seed(0)
    model = build_model(TINY, num_bins=2, device="cpu")
    twin = copy.deepcopy(model)
    runs = []
    for m, eager in ((model, False), (twin, True)):
        _, step, state = _trainer(warping, True, monkeypatch, m)
        call = step.eager if eager else step
        losses = []
        for i in range(4):
            state, loss = call(state, _window(i))
            losses.append(loss)
        assert bool(_graphs(step)) != eager
        runs.append((torch.stack(losses), state.carry,
                     [p.detach() for p in m.parameters()]))
    (l1, c1, p1), (l2, c2, p2) = runs
    assert torch.equal(_bits(l1), _bits(l2))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(c1, c2))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(p1, p2))


@pytest.mark.parametrize("warping", WARPINGS)
def test_a_new_signature_captures_anew_within_the_bound(warping,
                                                        monkeypatch):
    monkeypatch.setattr(graphed, "MAX_GRAPHS", 2)
    _, step, state = _trainer(warping, True, monkeypatch)
    made = {}
    for n in (32, 48):
        for i in range(2):
            state, _ = step(state, _window(i, n))
        made[n] = _graphs(step)[-1]
    assert _graphs(step) == [made[32], made[48]]
    # every later graph shares the first one's memory pool
    assert made[32].pool_in is None
    assert made[48].pool_in == made[32].pool()
    # past the bound a signature runs eagerly, every call, and is not kept
    for i in range(3):
        state, _ = step(state, _window(2 + i, 64))
        assert _graphs(step) == [made[32], made[48]]
        assert len(step.graphs.graphs) == graphed.MAX_GRAPHS
    # the kept graphs replay on
    state, _ = step(state, _window(5, 32))
    state, _ = step(state, _window(6, 48))
    assert [made[32].replays, made[48].replays] == [2, 2]
    assert _graphs(step) == [made[32], made[48]] and state.step == 9


def _interleaved(sizes, rounds):
    """Windows whose sizes cycle through ``sizes`` ``rounds`` times."""
    return [_window(r * len(sizes) + i, n) for r in range(rounds)
            for i, n in enumerate(sizes)]


@pytest.mark.parametrize("bound", [3, 2])
@pytest.mark.parametrize("warping", WARPINGS)
def test_interleaved_signatures_capture_a_bounded_number_of_times(
        warping, bound, monkeypatch):
    """Three window sizes in turn, as a run under power-of-two buckets
    gives them: each kept signature captures once and then replays; with
    room for two, the third runs eagerly on every call and no graph is
    captured again."""
    monkeypatch.setattr(graphed, "MAX_GRAPHS", bound)
    _, step, state = _trainer(warping, True, monkeypatch)
    rounds = 6
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        for w in _interleaved((32, 48, 64), rounds):
            state, _ = step(state, w)
    rows = [e for e in recorded() if e.start_ns >= t0]

    def counted(name):
        return sum(e.value for e in rows if e.name == name
                   and e.value is not None)

    kept = min(bound, 3)
    assert counted("train_graph_captures") == len(_graphs(step)) == kept
    assert counted("train_graph_replays") == kept * (rounds - 1)
    assert [g.replays for g in _graphs(step)] == [rounds - 1] * kept
    # an eager step opens its forward right under the step (the stand-in's
    # capture and replays run theirs under train.capture and train.replay)
    eager = sum(e.name == "train.forward" and e.parent == "train.step"
                for e in rows)
    assert eager == kept + (3 - kept) * rounds
    assert state.step == 3 * rounds


@pytest.mark.parametrize("warping", WARPINGS)
def test_interleaved_graphed_steps_equal_eager_ones(warping, monkeypatch):
    torch.manual_seed(0)
    model = build_model(TINY, num_bins=2, device="cpu")
    twin = copy.deepcopy(model)
    runs = []
    for m, eager in ((model, False), (twin, True)):
        _, step, state = _trainer(warping, True, monkeypatch, m)
        call = step.eager if eager else step
        losses = []
        for w in _interleaved((32, 48, 64), 3):
            state, loss = call(state, w)
            losses.append(loss)
        assert len(_graphs(step)) == (0 if eager else 3)
        runs.append((torch.stack(losses), state.carry,
                     [p.detach() for p in m.parameters()]))
    (l1, c1, p1), (l2, c2, p2) = runs
    assert torch.equal(_bits(l1), _bits(l2))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(c1, c2))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(p1, p2))


@pytest.mark.parametrize("warping", WARPINGS)
def test_loss_and_carry_alias_no_graph_buffer(warping, monkeypatch):
    _, step, state = _trainer(warping, True, monkeypatch)
    state, _ = step(state, _window(0))
    state, loss = step(state, _window(1))
    (g,) = step.graphs.graphs.values()
    g_loss, g_carry, _ = g.out
    ptrs = {t.data_ptr() for t in [g_loss, *g_carry, *_flat(g.inputs)]}
    assert loss.data_ptr() not in ptrs
    assert not ptrs & {c.data_ptr() for c in state.carry}
    kept = (loss.clone(), [c.clone() for c in state.carry])
    state2, loss2 = step(state, _window(2))  # rewrites the graph's outputs
    assert not torch.equal(g_loss, kept[0])
    assert torch.equal(loss, kept[0])
    assert all(torch.equal(a, b) for a, b in zip(state.carry, kept[1]))


@pytest.mark.parametrize("warping", WARPINGS)
def test_grads_are_bound_to_the_graph_that_ran(warping, monkeypatch):
    model, step, state = _trainer(warping, True, monkeypatch)
    params = list(model.parameters())

    def bound_to(g):
        return all(p.grad is grad for p, grad in zip(params, g.out[2]))

    for i in range(2):
        state, _ = step(state, _window(i, 32))
    (a,) = step.graphs.graphs.values()
    assert bound_to(a)
    state, _ = step.eager(state, _window(2, 32))  # an interleaved eager step
    assert not any(p.grad is grad for p, grad in zip(params, a.out[2]))
    for i in range(2):
        state, _ = step(state, _window(3 + i, 48))
    b = [g for g in step.graphs.graphs.values() if g is not None][-1]
    assert b is not a and bound_to(b)
    state, _ = step(state, _window(5, 32))
    assert bound_to(a) and not bound_to(b)
    assert all(p.grad is not None for p in params)


@pytest.mark.parametrize("warping", WARPINGS)
def test_launches_advance_on_replay(warping, monkeypatch):
    _, step, state = _trainer(warping, True, monkeypatch)
    for i in range(5):
        before = LAUNCHES["splat_bilinear"]
        state, _ = step(state, _window(i))
        assert LAUNCHES["splat_bilinear"] - before == SPLATS, i
    (g,) = step.graphs.graphs.values()
    assert g.launches["splat_bilinear"] == SPLATS


@pytest.mark.parametrize("warping", WARPINGS)
def test_spans_and_counters_of_a_replayed_step(warping, monkeypatch):
    _, step, state = _trainer(warping, True, monkeypatch)
    seen = []
    for i in range(4):
        t0 = time.time_ns()
        with profile(activities=[ProfilerActivity.CPU]):
            state, _ = step(state, _window(i))
        seen.append([e for e in recorded() if e.start_ns >= t0])

    def names(entries, parent="train.step"):
        return [e.name for e in sorted(entries, key=lambda e: e.start_ns)
                if e.parent == parent and e.value is None]

    def counted(entries, name):
        return sum(e.value for e in entries if e.name == name
                   and e.value is not None)

    assert names(seen[0]) == PHASES  # the warm-up: eager
    assert names(seen[1]) == ["train.capture", "train.replay",
                              "train.optimizer"]
    assert names(seen[2]) == names(seen[3]) == ["train.replay",
                                                "train.optimizer"]
    assert [counted(s, "train_graph_captures") for s in seen] == [0, 1, 0, 0]
    assert [counted(s, "train_graph_replays") for s in seen] == [0, 1, 1, 1]
    top = [e for e in seen[3] if e.name == "train.step"]
    assert [(e.parent, e.rid) for e in top] == [(None, 3)]


@pytest.mark.parametrize("warping", WARPINGS)
def test_a_mesh_train_step_stays_eager(warping, monkeypatch):
    """A train step under a mesh (its loss, gradients and loss sum run
    collectives) runs eagerly, every call, on the card's path too, with
    the spans of an eager step; the collectives, stood in for by a world
    of one, run in the step's order: the loss's over the event group, the
    gradients' over the world before the optimizer, the loss's sum over
    the data group last. An event-sharded window without ``net_input``
    is refused."""
    calls = []

    def all_reduce(t, op=None, group=None, async_op=False):
        calls.append(group)

    monkeypatch.setattr(torch.distributed, "all_reduce", all_reduce)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 1)
    monkeypatch.setattr(graphed, "uses_graphs", lambda params: True)

    def no_graph(*args, **kwargs):
        raise AssertionError("a mesh step reached its graphs")

    monkeypatch.setattr(graphed.StepGraphs, "__call__", no_graph)
    torch.manual_seed(0)
    model = build_model(TINY, num_bins=2, device="cpu")
    opt = build_optimizer({"name": "Adam", "lr": 1e-3}, model.parameters(),
                          clip_grad=100.0, device="cpu")
    opt.register_step_pre_hook(lambda o, a, k: calls.append("optimizer"))
    groups = {"event_group": "event", "data_group": "data"}
    mesh = SimpleNamespace(n_data=1, n_event=1, **groups)
    step = make_train_step(model, opt, LossConfig(res=RES,
                                                  passes_loss=PASSES),
                           warping, flow_scaling=4.0, res=RES, mesh=mesh)
    state = init_train_state(model, 1, RES[0], RES[1], device="cpu")
    for i in range(3):
        calls.clear()
        t0 = time.time_ns()
        with profile(activities=[ProfilerActivity.CPU]):
            state, loss = step(state, _window(i))
        entries = sorted((e for e in recorded() if e.start_ns >= t0),
                         key=lambda e: e.start_ns)
        assert [e.name for e in entries
                if e.parent == "train.step" and e.value is None] == PHASES
        assert [(e.parent, e.rid) for e in entries
                if e.name == "train.step"] == [(None, i)]
        n_event = calls.index(None)
        assert n_event > 0 and set(calls[:n_event]) == {"event"}
        assert calls[n_event:] == [None, "optimizer", "data"]
    assert torch.isfinite(loss) and state.step == 3
    assert not step.graphs.graphs
    sharded = make_train_step(model, opt, LossConfig(res=RES,
                                                     passes_loss=PASSES),
                              warping, res=RES,
                              mesh=SimpleNamespace(n_event=2, **groups))
    with pytest.raises(ValueError, match="net_input"):
        sharded(state, _window(3))


def test_the_signature_reads_shapes_dtypes_and_precision():
    carry = (torch.zeros(1, 4, 4, 4),)
    w = _window(0)
    key = graphed.signature(carry, w)
    assert graphed.signature(carry, _window(1)) == key
    assert graphed.signature(carry, _window(0, 48)) != key
    assert graphed.signature((torch.zeros(1, 4, 8, 8),), w) != key
    assert graphed.signature(carry, dict(w, grad_mask=w["grad_mask"]
                                         .to(torch.float64))) != key
    assert graphed.signature(carry, dict(w, net_input=None)) != key
    flags = torch.backends.cudnn
    was = flags.allow_tf32
    try:
        flags.allow_tf32 = not was
        assert graphed.signature(carry, w) != key
    finally:
        flags.allow_tf32 = was
