"""The port's multi-device training layer (``taming_event_flow_tpu_torch/
parallel/``) on the CPU: gloo ranks in children started with ``spawn``
(their bodies in ``tests/torch_parallel_ranks.py``, which imports no JAX),
joined through a ``file://`` rendezvous under ``tmp_path``, against the
JAX package in this process (on ``conftest.py``'s 8 virtual CPU devices).

- ``all_reduce_sum``'s value and gradient (the transpose of a sum is a
  sum), ``pmean``.
- Both losses with ``event_axis`` over 2 and 4 ranks against JAX's
  single-device loss: the value on every rank, the flow gradient as the
  mean over ranks, at the port's loss tolerances (Iterative: rtol 1e-4,
  gradient atol 1e-4 x max |g|, ``tests/test_torch_objectives.py``;
  Linear: ``tests/test_torch_linear.py``'s).
- ``make_train_step(..., mesh=)`` at (1 x 2), (2 x 1) and (2 x 2)
  from the JAX trainer's initial weights (``flax_params_to_state_dict``),
  at ``tests/test_parallel_event.py``'s tolerances (loss rtol 1e-4;
  parameters rtol 2e-3, atol 1e-6; carry rtol 1e-3, atol 1e-5): the loss
  and the carry against JAX's ``make_event_parallel_train_step`` on the
  same mesh shape, the parameters and the carry against the port's own
  one-process step, as the JAX test holds its sharded step to its
  one-device step; the reduced gradients against the one-process ones
  within 1e-4 x max |g| per tensor (``tests/test_torch_training.py``'s
  gradient tolerance). Adam's first update ``lr g / (|g| + eps)`` is steep
  in ``g`` near zero, so where ``|g| < 10 eps`` the reduction's float order
  decides the weight: there the parameters are held within ``lr``, the
  update's own size (measured: ``g`` of -2.92e-10 one-process and
  -2.58e-10 over (2 x 2) moved one weight 3.2e-6 apart, where rtol 2e-3,
  atol 1e-6 allow 1.3e-6; the tensor's gradients agree within 5.1e-6 x
  max |g|). Every rank's parameters are bitwise equal.
- The mesh's refusals and the loader's flag exchange.

Each child is joined with a timeout; a child's traceback fails the test.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taming_event_flow_tpu import objectives as jobj
from taming_event_flow_tpu.parallel.event import (
    make_event_mesh as j_event_mesh,
    make_event_parallel_train_step as j_event_step,
    shard_state_2d as j_shard_state,
    shard_window_2d as j_shard_window,
)
from taming_event_flow_tpu.training import build_optimizer as j_build_opt
from taming_event_flow_tpu.training.step import (
    init_train_state as j_init_state,
)
from taming_event_flow_tpu_torch.models import (
    build_model,
    flax_params_to_state_dict,
)
from taming_event_flow_tpu_torch.objectives import LossConfig
from taming_event_flow_tpu_torch.parallel import (
    init_distributed,
    local_lane_range,
    make_event_mesh,
)
from taming_event_flow_tpu_torch.parallel.spawn import run_ranks
from taming_event_flow_tpu_torch.training import (
    build_optimizer,
    init_train_state,
    make_train_step,
)

from . import torch_parallel_ranks as ranks
from .test_training import RES, make_window
from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240.0  # seconds a spawn of ranks may take
TINY = {"name": "RecEVFlowNet", "base_channels": 8, "num_encoders": 2,
        "num_residual_blocks": 1, "min_size": 4, "final_w_scale": 0.01}
OPT = {"name": "Adam", "lr": 1e-3}
CLIP = 100.0
FLOW_SCALING = 4.0
STEP_TOL = {"loss": dict(rtol=1e-4), "params": dict(rtol=2e-3, atol=1e-6),
            "carry": dict(rtol=1e-3, atol=1e-5)}
GRAD_TOL = 1e-4  # x each tensor's max |g|
STEEP = 10 * 1e-8  # |g| under 10 x Adam's eps: the update is steep in g


def spawn(tmp_path_factory, fn, world, *args):
    url = "file://" + str(tmp_path_factory.mktemp("rdv") / "store")
    return run_ranks(fn, world, (url,) + args, timeout=TIMEOUT)


def test_all_reduce_sum_probe(tmp_path_factory):
    """Rank r contributes ``w (r + 1)`` at ``w = [1, 2]``; the loss is
    ``|sum|^2``. The backward all-reduces the cotangent: the local
    gradients are ``[12, 24]`` and ``[24, 48]``, whose mean is the
    single-process gradient ``[18, 36]``."""
    out = spawn(tmp_path_factory, ranks.probe, 2)
    assert [r["loss"] for r in out] == [45.0, 45.0]
    np.testing.assert_array_equal(out[0]["grad"], [12.0, 24.0])
    np.testing.assert_array_equal(out[1]["grad"], [24.0, 48.0])
    np.testing.assert_array_equal((out[0]["grad"] + out[1]["grad"]) / 2,
                                  [18.0, 36.0])
    assert [r["pmean"] for r in out] == [0.5, 0.5]


# ------------------------------------------------------------------ losses

L_RES = (8, 10)
L_N, L_GRAD = 24, 12  # events a lane (6 of them padding), gradient events
L_TOL = {
    "Iterative": (dict(rtol=1e-4), 1e-4),
    "Linear": (dict(rtol=2e-4, atol=1e-5), 2e-3),
}


def _loss_inputs(seed, passes=4, b=2):
    """``tests/test_torch_objectives.py``'s inputs in a shuffled event
    order, so every shard holds gradient, detached and padding events."""
    rng = np.random.default_rng(seed)
    flows = rng.normal(size=(passes, 2, b, *L_RES, 2)).astype(
        np.float32) * 1.5
    ev = np.zeros((passes, b, L_N, 4), np.float32)
    real = L_N - 6
    ev[..., :real, 0] = rng.uniform(0, 1, (passes, b, real))
    ev[..., :real, 1] = rng.integers(0, L_RES[0], (passes, b, real))
    ev[..., :real, 2] = rng.integers(0, L_RES[1], (passes, b, real))
    ev[..., :real, 3] = rng.choice([-1.0, 1.0], (passes, b, real))
    gm = np.zeros((passes, b, L_N, 1), np.float32)
    gm[:, :, :L_GRAD] = 1.0
    order = rng.permutation(L_N)
    ev, gm = ev[:, :, order], gm[:, :, order]
    ev[:, :, 0, 0] = 0.0  # the window's first event at ts 0
    pol = np.stack([ev[..., 3] > 0, ev[..., 3] < 0], -1).astype(np.float32)
    return flows, ev, pol, gm


LOSS_CASES = [("Iterative", dict(passes_loss=4, scales_loss=1,
                                  flow_spat_smooth_weight=0.2,
                                  flow_temp_smooth_weight=0.1)),
              ("Linear", dict(passes_loss=4, scales_loss=2))]


@pytest.fixture(scope="module")
def loss_runs(tmp_path_factory):
    """The cases, JAX's single-device (value, flow gradient) of each, and
    every rank's results over 2 and 4 ranks."""
    cases = [(w, dict(res=L_RES, **kw), *_loss_inputs(i))
             for i, (w, kw) in enumerate(LOSS_CASES)]
    refs = []
    for warping, cfg_kw, flows, ev, pol, gm in cases:
        jcfg = jobj.LossConfig(**cfg_kw)
        jv, jg = jax.jit(jax.value_and_grad(
            lambda f: jobj.LOSS_REGISTRY[warping](
                f, jnp.asarray(ev), jnp.asarray(pol), jnp.asarray(gm), jcfg)
        ))(jnp.asarray(flows))
        refs.append((float(jv), np.asarray(jg)))
    return refs, {e: spawn(tmp_path_factory, ranks.losses, e, cases)
                  for e in (2, 4)}


@pytest.mark.parametrize("case", [0, 1], ids=["Iterative", "Linear"])
@pytest.mark.parametrize("n_event", [2, 4])
def test_sharded_loss_matches_jax(loss_runs, case, n_event):
    refs, runs = loss_runs
    jv, jg = refs[case]
    value_tol, grad_rtol = L_TOL[LOSS_CASES[case][0]]
    got = [r[case] for r in runs[n_event]]
    for r in got:
        np.testing.assert_allclose(r["loss"], jv, **value_tol)
    grad = np.mean([r["grad"] for r in got], axis=0)
    np.testing.assert_allclose(grad, jg, rtol=grad_rtol,
                               atol=grad_rtol * np.abs(jg).max())
    # each rank alone holds E x its shard's part: not the gradient
    assert not np.allclose(got[0]["grad"], jg, rtol=grad_rtol)


# -------------------------------------------------------------- train step

STEP_CASES = {
    # world: [(n_data, n_event, warping, smoothness)]
    2: [(1, 2, "Iterative", False), (2, 1, "Iterative", False),
        (1, 2, "Linear", False)],
    4: [(2, 2, "Iterative", False), (2, 2, "Linear", False),
        (2, 2, "Iterative", True)],
}
STEP_IDS = [f"{w}-{d}x{e}{'-smooth' if s else ''}"
            for cases in STEP_CASES.values() for d, e, w, s in cases]


def _loss_kw(smooth):
    kw = dict(res=RES, passes_loss=3, scales_loss=1, iterative_mode="two")
    if smooth:  # tests/test_parallel_event.py:92
        kw.update(flow_spat_smooth_weight=0.1, flow_temp_smooth_weight=0.1)
    return kw


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """The JAX trainer's initial state, the window, and every rank's
    results for every case."""
    from .test_training import tiny_model

    jm = tiny_model()
    jopt = j_build_opt(OPT, clip_grad=CLIP)
    jstate = j_init_state(jm, jopt, 2, RES[0], RES[1], 2)
    window = make_window(np.random.default_rng(7), 2)
    weights = {k: v.numpy() for k, v in flax_params_to_state_dict(
        jax.tree.map(np.asarray, jstate.params)).items()}
    runs = {}
    for world, cases in STEP_CASES.items():
        spec = [{"n_data": d, "n_event": e, "warping": w, "model": TINY,
                 "weights": weights, "opt": OPT, "clip": CLIP,
                 "loss": _loss_kw(s), "window": window,
                 "flow_scaling": FLOW_SCALING, "steps": 1}
                for d, e, w, s in cases]
        out = spawn(tmp_path_factory, ranks.train_steps, world, spec)
        for i, key in enumerate(cases):
            runs[key] = [r[i] for r in out]
    return jm, jopt, jstate, window, runs


@pytest.mark.parametrize(
    "key", [k for cases in STEP_CASES.values() for k in cases], ids=STEP_IDS)
def test_event_parallel_step_matches_jax(step_runs, key):
    n_data, n_event, warping, smooth = key
    jm, jopt, jstate, window, runs = step_runs
    mesh = j_event_mesh(n_data, n_event)
    jstep = j_event_step(jm, jopt, jobj.LossConfig(**_loss_kw(smooth)),
                         mesh, warping, flow_scaling=FLOW_SCALING)
    jnew, jloss = jstep(
        j_shard_state(jstate, mesh),
        j_shard_window({k: jnp.asarray(v) for k, v in window.items()}, mesh))
    jax_carry = [np.transpose(np.asarray(c), (0, 3, 1, 2))
                 for c in jax.tree.leaves(jnew.carry)]
    # the port's one-process step from the same weights
    model = build_model(TINY, num_bins=2, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, jstate.params)))
    opt = build_optimizer(OPT, model.parameters(), clip_grad=CLIP,
                          device="cpu")
    step = make_train_step(model, opt, LossConfig(**_loss_kw(smooth)),
                           warping=warping, flow_scaling=FLOW_SCALING)
    one, one_loss = step(init_train_state(model, 2, *RES, device="cpu"),
                         {k: torch.from_numpy(v) for k, v in window.items()})
    np.testing.assert_allclose(float(one_loss), float(jloss),
                               **STEP_TOL["loss"])

    got = runs[key]
    assert len(got) == n_data * n_event
    for r in got:
        np.testing.assert_allclose(r["losses"][0], float(jloss),
                                   **STEP_TOL["loss"])
        # every rank holds the same bits
        for name, value in r["params"].items():
            np.testing.assert_array_equal(value, got[0]["params"][name])
    for name, ref in model.named_parameters():
        g = ref.grad.numpy()
        np.testing.assert_allclose(got[0]["grads"][name], g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg=name)
        steep = np.abs(g) < STEEP
        want, have = ref.detach().numpy(), got[0]["params"][name]
        np.testing.assert_allclose(have[~steep], want[~steep], err_msg=name,
                                   **STEP_TOL["params"])
        np.testing.assert_allclose(have[steep], want[steep], rtol=0,
                                   atol=OPT["lr"], err_msg=name)
    for r in got:
        lo, hi = r["lanes"]
        assert len(r["carry"]) == len(jax_carry) == len(one.carry)
        for c, ref, own in zip(r["carry"], jax_carry, one.carry):
            np.testing.assert_allclose(c, ref[lo:hi], **STEP_TOL["carry"])
            np.testing.assert_allclose(c, own[lo:hi].numpy(),
                                       **STEP_TOL["carry"])


# ------------------------------------------------------- mesh and flags


def test_mesh_shapes_and_flags(tmp_path_factory):
    """A world of 2 refuses a mesh it cannot hold (too big or too small),
    batches and event lists its axes do not divide, and the training
    configs ``train_flow.py`` refuses; the flags exchange gathers the data
    axis's lanes and ANDs the epoch flags, and catches an event group whose
    ranks streamed different lanes."""
    out = spawn(tmp_path_factory, ranks.mesh_errors, 2)
    for rank, r in enumerate(out):
        assert "need 4 ranks" in r["too_big"] and "ROADMAP" in r["too_big"]
        assert "every rank needs a place" in r["too_small"]
        assert r["lanes"] and r["world_lanes"] and r["events"]
        assert r["lane_range"] == (2 * rank, 2 * rank + 2)
        assert r["flags"] == ([False, True], False)
        assert r["event_flags"] == ([True, False], True)
        assert "different lanes" in r["diverged"]
        # the event ring of consecutive ranks, and an axis the world
        # does not divide
        assert r["multihost"][0] == 2 and "divide" in r["multihost"][1]
        # the training CLI's mesh: (1, 2) for parallel {event: 2}; a batch
        # the data axis does not divide, a missing seed, a bucket the event
        # axis does not divide
        shape, refused = r["train_mesh"]
        assert shape == (1, 2)
        assert "batch_size 3" in refused[0] and "loader.seed" in refused[1]
        assert "n_events_pad 63" in refused[2]


def test_mesh_without_a_process_group():
    """Without a process group the world is one rank: a larger mesh raises
    ``ValueError`` naming ROADMAP.md, the world's lanes are all lanes, and
    ``init_distributed`` without a rendezvous initializes nothing."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="ROADMAP"):
        make_event_mesh(2, 1)
    with pytest.raises(ValueError, match="ROADMAP"):
        make_event_mesh(1, 2)
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_event_mesh(1, 1)
    assert local_lane_range(8) == (0, 8)
    assert init_distributed({}) is False
    assert init_distributed(None) is False
    with pytest.raises(ValueError, match="num_processes"):
        init_distributed({"coordinator": "localhost:1"})
    assert not torch.distributed.is_initialized()


def test_parallel_imports_only_torch_distributed():
    """``parallel/`` imports torch (``torch.distributed`` its only
    communication library), numpy and the standard library: no JAX; and
    nothing of the port's ``training`` or ``objectives``, which import
    ``parallel`` (the train step under a mesh lives in ``training``)."""
    pkg = os.path.join(REPO, "taming_event_flow_tpu_torch", "parallel")
    allowed = {"torch", "numpy", "__future__", "dataclasses", "functools",
               "multiprocessing", "os", "queue", "time", "traceback",
               "typing"}
    seen = set()
    for name in sorted(os.listdir(pkg)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(pkg, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            elif isinstance(node, ast.ImportFrom) and node.level > 1:
                ups = ([node.module] if node.module
                       else [a.name for a in node.names])
                assert not {u.split(".")[0] for u in ups} & {
                    "training", "objectives"}, (name, ups)
                continue
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in allowed, (name, m)
                seen.add(m)
    assert "torch.distributed" in seen


def test_rank_device_resolution(monkeypatch):
    """A bare ``cuda`` is ``cuda:<LOCAL_RANK>`` under ``torchrun``; a card
    that does not exist raises, and without a card nothing falls back to
    the CPU (the CUDA queries are stubbed, so the test needs no card)."""
    from taming_event_flow_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert resolve_device("cuda") == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device("cuda") == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="does not exist"):
        resolve_device("cuda:2")
    monkeypatch.setenv("LOCAL_RANK", "5")
    with pytest.raises(RuntimeError, match="does not exist"):
        resolve_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
