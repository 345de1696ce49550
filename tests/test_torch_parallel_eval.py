"""Event-sharded evaluation in the port (``parallel/eval.py``, the sharded
``EvalPipeline``) on the CPU: gloo ranks in children started with
``spawn`` (``tests/torch_parallel_ranks.py``, no JAX there) against the
JAX package's single-device validation and the port's one-rank pipeline in
this process.

- ``IterativeValidation`` and ``LinearValidation`` with their slots sharded
  over 2 and 4 ranks: the sharded state is bitwise this rank's slice of the
  one-rank port's (the update is per event); the sharded reducers against
  JAX's single-device ones at ``tests/test_parallel_eval.py``'s metric
  tolerance (FWL, RSAT rtol 1e-5) and the images and backward flow at the
  port's own tolerance against JAX (rtol, atol 1e-4,
  ``tests/test_torch_validation.py``).
- ``EvalPipeline`` over 2 ranks, unrectified, rectified (the count input
  derived on every rank from the raw coordinates and ``cur_ridx``) and
  with a bucket that grows mid-run, against the one-rank port within the
  pipeline-parity tolerance (``tests/test_pipeline_parity.py:196``:
  rtol 2e-3, atol 2e-4), ``flow_bw`` within one u16 lattice step; the
  JAX rule for when it shards.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taming_event_flow_tpu.metrics import validation as jval
from taming_event_flow_tpu_torch.metrics import IterativeValidation, ValConfig
from taming_event_flow_tpu_torch.models import build_model
from taming_event_flow_tpu_torch.parallel import shard_val_state
from taming_event_flow_tpu_torch.parallel.spawn import run_ranks
from taming_event_flow_tpu_torch.pipeline import EvalPipeline

from . import torch_parallel_ranks as ranks
from .test_torch_pipeline import MODEL
from .test_torch_pipeline import _config as dsec_config
from .test_torch_pipeline import _window
from .test_torch_rectify import _config as rect_config
from .test_torch_rectify import _rectified_sequence
from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TIMEOUT = 240.0
RES = (12, 16)
P, N = 3, 64  # passes, events a pass (divisible by 4)
METRIC_RTOL = 1e-5  # tests/test_parallel_eval.py
LOC_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_validation.py
PIPE_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_pipeline_parity.py:196


def spawn(tmp_path_factory, fn, world, *args):
    url = "file://" + str(tmp_path_factory.mktemp("rdv") / "store")
    return run_ranks(fn, world, (url,) + args, timeout=TIMEOUT)


def _passes(seed):
    """One lane of P passes: sorted ts from 0, integer pixels, +-1
    polarity, a padded tail, flow maps and event masks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(P):
        ev = np.zeros((1, N, 4), np.float32)
        ev[..., 0] = np.sort(rng.uniform(0, 1, (1, N)), axis=1)
        ev[:, 0, 0] = 0.0
        ev[..., 1] = rng.integers(0, RES[0], (1, N))
        ev[..., 2] = rng.integers(0, RES[1], (1, N))
        ev[..., 3] = rng.choice([-1.0, 1.0], (1, N))
        ev[:, -N // 8:] = 0.0  # padding rows
        pol = np.stack([ev[..., 3] > 0, ev[..., 3] < 0], -1).astype(
            np.float32)
        flow = (rng.normal(size=(1, *RES, 2)) * 1.5).astype(np.float32)
        emask = (rng.uniform(size=(1, *RES, 1)) > 0.5).astype(np.float32)
        out.append((flow, ev, pol, emask))
    return out


VAL_CASES = ["Iterative", "Linear"]


@pytest.fixture(scope="module")
def val_runs(tmp_path_factory):
    cases = [(w, dict(res=RES, passes=P), _passes(i))
             for i, w in enumerate(VAL_CASES)]
    return cases, {e: spawn(tmp_path_factory, ranks.validation, e, cases)
                   for e in (2, 4)}


@pytest.mark.parametrize("case", [0, 1], ids=VAL_CASES)
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_validation_matches_jax(val_runs, case, world):
    cases, runs = val_runs
    warping, cfg_kw, passes = cases[case]
    jv = jval.METRIC_REGISTRY[warping](jval.ValConfig(**cfg_kw), 1, N)
    js = jv.init()
    for flow, ev, pol, emask in passes:
        js = jv.update(js, *(jnp.asarray(a) for a in (flow, ev, pol, emask)))
    ref = {
        "fwl": float(jv.fwl(js)),
        "rsat": np.asarray(jv.rsat(js)),
        "window_events": np.asarray(jv.window_events(js)),
        "window_iwe_fw": np.asarray(jv.window_iwe(js, mode="forward")),
        "window_iwe_bw": np.asarray(jv.window_iwe(js, mode="backward")),
        "window_flow_bw": np.asarray(jv.window_flow(js, mode="backward")),
    }
    got = [r[case] for r in runs[world]]
    for r in got:
        assert r["bitwise"]
        np.testing.assert_allclose(r["fwl"], ref["fwl"], rtol=METRIC_RTOL)
        np.testing.assert_allclose(r["rsat"], ref["rsat"], rtol=METRIC_RTOL)
        rsat, fwl = r["rsat_fwl"]
        np.testing.assert_allclose(rsat, ref["rsat"], rtol=METRIC_RTOL)
        # FWL from RSAT's merged count planes: bitwise the standalone one
        assert fwl == r["fwl"]
        for key in ("window_events", "window_iwe_fw", "window_iwe_bw",
                    "window_flow_bw"):
            np.testing.assert_allclose(r[key], ref[key], err_msg=key,
                                       **LOC_TOL)
        # every rank holds the merged images, not its partial ones
        np.testing.assert_array_equal(r["window_events"],
                                      got[0]["window_events"])


def test_shard_val_state_refuses_round_ts():
    state = IterativeValidation(ValConfig(res=RES, passes=P), 1, N,
                                device="cpu").init()
    with pytest.raises(ValueError, match="round_ts"):
        shard_val_state(state, None, round_ts=True)


# ---------------------------------------------------------- the pipeline


def _weights(seed=3):
    model = build_model(MODEL, device="cpu", seed=seed)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _one_rank(case):
    """The port's pipeline on one rank over the same windows."""
    model = build_model(case["model"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["weights"].items()})
    pipe = EvalPipeline(case["config"], model, device="cpu")
    assert pipe.eval_mesh is None
    pipe.cur_ridx = case["ridx"]
    out = []
    for batches in case["windows"]:
        for b in batches:
            pipe.ingest(pipe.ensure_bucket(b), {"ts": 0.0})
        m = pipe.boundary_metrics(batches[-1], {"ts": 0.0})
        out.append({k: np.asarray(v) for k, v in m.items()})
    return out, pipe.n_slots


def _grow_windows():
    """DSEC-protocol windows of 49 events a pass against a 32-event
    bucket: the bucket grows on the first batch (to 49 on one rank, to 50
    over 2)."""
    return [_window(11, n=49), _window(12, n=49)]


PIPE_CASES = {
    "unrectified": lambda: dict(config=dsec_config(dict(
        store=True, show=["flow_bw"])), model=MODEL,
        windows=[_window(1), _window(2)], ridx=None),
    "rectified": lambda: dict(config=rect_config(dict(
        store=True, show=["flow_bw"])), model=dict(MODEL),
        windows=_rectified_sequence(5)[0], ridx=_rectified_sequence(5)[1]),
    "grown_bucket": lambda: dict(config=dsec_config(
        dict(enabled=True), n_events_pad=32), model=MODEL,
        windows=_grow_windows(), ridx=None),
    # the JAX rule: no sharding with round_ts, nor with a bucket the
    # ranks do not divide
    "round_ts": lambda: dict(config=dict(dsec_config(), loss={
        "flow_scaling": 8, "round_ts": True}), model=MODEL,
        windows=[_window(4)], ridx=None),
    "odd_bucket": lambda: dict(config=dsec_config(n_events_pad=63),
                               model=MODEL, windows=[_window(5)], ridx=None),
}


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    cases = {}
    for name, make in PIPE_CASES.items():
        case = make()
        case["weights"] = _weights()
        cases[name] = case
    names = list(cases)
    out = spawn(tmp_path_factory, ranks.pipeline_windows, 2,
                [cases[n] for n in names])
    return cases, {n: [r[i] for r in out] for i, n in enumerate(names)}


@pytest.mark.parametrize("name", list(PIPE_CASES))
def test_sharded_pipeline_matches_one_rank(pipe_runs, name):
    cases, runs = pipe_runs
    ref, n_slots = _one_rank(cases[name])
    sharded = name not in ("round_ts", "odd_bucket")
    for r in runs[name]:
        assert r["sharded"] == sharded
        if sharded:
            assert r["n_slots"] == 2 * r["slots_here"]
            assert r["n_slots"] == n_slots + (n_slots % 2)
        for ours, want in zip(r["metrics"], ref):
            for k in ("fwl", "rsat", "aee"):
                np.testing.assert_allclose(float(ours[k]), float(want[k]),
                                           err_msg=k, **PIPE_TOL)
            if "flow_bw" in want:
                diff = np.abs(ours["flow_bw"].astype(np.int64)
                              - want["flow_bw"].astype(np.int64))
                assert diff.max() <= 1
    # every rank computed the same merged metrics
    a, b = runs[name]
    for ma, mb in zip(a["metrics"], b["metrics"]):
        for k in ("fwl", "rsat", "aee"):
            assert float(ma[k]) == float(mb[k]), k
