"""The port's eval slice against the JAX package's: both ``EvalPipeline``s on
the same tiny protocol (32x48, P=4, N=64) with the same weights and the same
synthetic windows, plus the pipeline's units and the port's hygiene (no JAX
imports, no silent CPU fallback)."""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taming_event_flow_tpu.models import RecEVFlowNet as JaxRecEVFlowNet
from taming_event_flow_tpu.pipeline import EvalPipeline as JaxEvalPipeline
from taming_event_flow_tpu_torch.metrics import IterativeValidation, ValConfig
from taming_event_flow_tpu_torch.models import (
    build_model,
    flax_params_to_state_dict,
)
from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches
from taming_event_flow_tpu_torch.pipeline import (
    EvalPipeline,
    MetricsConsumer,
    VisPolicy,
    consume_mets,
    initialize_quant_results,
)
from taming_event_flow_tpu_torch.utils import flow_to_u16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (32, 48)
PASSES, N = 4, 64
METRIC_TOL = dict(rtol=2e-3, atol=2e-4)  # the JAX suite's pipeline parity
MODEL = {"name": "RecEVFlowNet", "base_channels": 8, "num_encoders": 2}
DSEC_VIS = {"store": True, "show": ["flow_bw"]}


def _config(vis=None, metrics=None, runtime=None, n_events_pad=N):
    return {
        "data": {"mode": "gtflow", "passes_loss": PASSES, "voxel": None,
                 "window": 1},
        "loader": {"resolution": list(RES), "n_events_pad": n_events_pad},
        "loss": {"flow_scaling": 8, "round_ts": False},
        "metrics": metrics if metrics is not None else {
            "warping": "Iterative", "name": ["FWL", "RSAT", "AEE"]},
        "vis": vis if vis is not None else {},
        "runtime": runtime or {},
    }


def _window(seed, n=48):
    """One GT window of loader-like batches (integer coordinates, sorted
    ts, +-1 polarity, count net input, masks) with a GT flow map."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(PASSES):
        ev = np.zeros((1, n, 4), np.float32)
        ev[0, :, 0] = np.sort(rng.uniform(0, 1, n))
        ev[0, 0, 0] = 0.0
        ev[0, :, 1] = rng.integers(0, RES[0], n)
        ev[0, :, 2] = rng.integers(0, RES[1], n)
        ev[0, :, 3] = rng.choice([-1.0, 1.0], n)
        pol = np.stack([ev[..., 3] > 0, ev[..., 3] < 0], -1)
        net = np.zeros((1, *RES, 2), np.float32)
        np.add.at(net, (0, ev[0, :, 1].astype(int), ev[0, :, 2].astype(int),
                        (ev[0, :, 3] < 0).astype(int)), 1.0)
        out.append({
            "event_list": ev,
            "event_list_pol_mask": pol.astype(np.float32),
            "net_input": net,
            "event_mask": (net.sum(-1, keepdims=True) > 0).astype(
                np.float32),
            "gtflow": rng.normal(size=(1, *RES, 2)).astype(np.float32),
        })
    return out


@pytest.fixture(scope="module")
def models():
    jm = JaxRecEVFlowNet(num_bins=2, base_channels=8, num_encoders=2)
    carry = jm.init_state(1, *RES)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *RES, 2)),
                     carry)["params"]
    tm = build_model(MODEL, device="cpu")
    tm.load_state_dict(
        flax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _drive(pipe, windows, jump_at=None):
    """The eval loop: ingest every pass, read the boundary metrics. With
    ``jump_at`` the last window has a ts jump before that pass."""
    results = []
    for w, batches in enumerate(windows):
        for i, b in enumerate(batches):
            if jump_at is not None and w == len(windows) - 1 \
                    and i == jump_at:
                pipe.ts_jump_flush()
            pipe.ingest(pipe.ensure_bucket(b), {"ts": 0.0})
        m = pipe.boundary_metrics(batches[-1], {"ts": 0.0})
        results.append({k: np.asarray(v) for k, v in m.items()})
    return results


def _assert_metrics_close(ours, ref):
    for o, r in zip(ours, ref):
        for k in ("fwl", "rsat", "aee"):
            np.testing.assert_allclose(float(o[k]), float(r[k]),
                                       err_msg=k, **METRIC_TOL)
        # flow_bw on the DSEC u16 lattice: within one lattice step
        assert o["flow_bw"].dtype == np.uint16
        ref_bw = r["flow_bw"]
        if ref_bw.dtype != np.uint16:  # the JAX pipeline's float32 wire
            ref_bw = flow_to_u16(torch.tensor(ref_bw)).numpy()
        diff = np.abs(o["flow_bw"].astype(np.int64)
                      - ref_bw.astype(np.int64))
        assert diff.max() <= 1


@pytest.mark.parametrize("runtime,jump_at", [
    ({}, None),  # windowed, everything derived from the event lists
    # the JAX pipeline ships net input, masks and flow_bw as float32;
    # the port parses the key and derives them all the same
    ({"packed_wire": False}, None),
    ({}, 2),  # ts jump mid-window: flush to the per-pass path
])
def test_slice_matches_jax_pipeline(models, runtime, jump_at):
    jm, params, tm = models
    windows = [_window(1), _window(2)]
    cfg = _config(vis=DSEC_VIS, runtime=runtime)
    ref = _drive(JaxEvalPipeline(cfg, jm, params, auto_shard=False),
                 windows, jump_at)
    reset_launches()
    ours = _drive(EvalPipeline(cfg, tm, device="cpu"), windows, jump_at)
    assert LAUNCHES == {"splat_bilinear": 0, "gather_bilinear": 0,
                        "gather_fused": 0, "row_gather": 0}
    _assert_metrics_close(ours, ref)


def test_per_pass_path_equals_windowed(models):
    """Live display forces the per-pass path; its boundary metrics equal
    the windowed path's on the same windows."""
    _, _, tm = models
    windows = [_window(3)]
    windowed = EvalPipeline(_config(vis=DSEC_VIS), tm, device="cpu")
    per_pass = EvalPipeline(_config(vis={"enabled": True}), tm,
                            device="cpu")
    assert windowed.windowed and not per_pass.windowed
    a = _drive(windowed, windows)[0]
    b = _drive(per_pass, windows)[0]
    for k in ("fwl", "rsat", "aee"):
        np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-6)


def test_start_sequence_resets_carry_and_state(models):
    _, _, tm = models
    pipe = EvalPipeline(_config(vis=DSEC_VIS), tm, device="cpu")
    first = _drive(pipe, [_window(4)])[0]
    for b in _window(5)[:2]:  # a partial window, then a new sequence
        pipe.ingest(pipe.ensure_bucket(b), {"ts": 0.0})
    pipe.start_sequence()
    assert pipe.passes_done == 0 and not pipe.wbuf
    assert all(float(c.abs().sum()) == 0 for c in pipe.carry)
    again = _drive(pipe, [_window(4)])[0]
    for k in ("fwl", "rsat", "aee"):
        np.testing.assert_allclose(float(again[k]), float(first[k]),
                                   rtol=1e-6)


def test_bf16_forward_contract(models):
    """``inference_dtype: bfloat16``: carry and model forward in bf16, the
    flow handed to the validation update in float32."""
    _, _, tm = models
    cfg = _config(vis=DSEC_VIS, metrics={
        "warping": "Iterative", "name": ["FWL", "RSAT", "AEE"],
        "inference_dtype": "bfloat16"})
    pipe = EvalPipeline(cfg, tm, device="cpu")
    assert all(c.dtype == torch.bfloat16 for c in pipe.carry)
    flow = None
    for b in _window(6):
        flow = pipe.ingest(pipe.ensure_bucket(b), {"ts": 0.0})
    assert flow.dtype == torch.float32 and flow.shape == (1, *RES, 2)
    assert all(c.dtype == torch.bfloat16 for c in pipe.carry)
    assert next(tm.parameters()).dtype == torch.float32  # caller's model
    m = pipe.boundary_metrics(_window(6)[-1], {"ts": 0.0})
    assert all(np.isfinite(float(m[k])) for k in ("fwl", "rsat", "aee"))


def test_flags_dsec_submission_protocol(models):
    _, _, tm = models
    pipe = EvalPipeline(_config(vis=DSEC_VIS), tm, device="cpu")
    assert pipe.windowed and pipe.use_extras and pipe.aee_in_program
    assert not pipe.val_cfg.track_fw_prop and not pipe.val_cfg.track_bw


def test_flags_eval_time_gate(models):
    """eval_time moves the window metrics out of the step; windows outside
    the gate produce none."""
    _, _, tm = models
    pipe = EvalPipeline(_config(vis=DSEC_VIS, metrics={
        "warping": "Iterative", "name": ["AEE", "FWL"],
        "eval_time": [1.0, 2.0]}), tm, device="cpu")
    assert pipe.windowed and not pipe.use_extras
    for b in _window(7):
        pipe.ingest(pipe.ensure_bucket(b), {"ts": 1.5})
    m = pipe.boundary_metrics(_window(7)[-1], {"ts": 1.5})
    assert set(m) == {"aee", "fwl", "flow_bw"}
    for b in _window(7):
        pipe.ingest(pipe.ensure_bucket(b), {"ts": 0.5})
    assert pipe.boundary_metrics(_window(7)[-1], {"ts": 0.5}) is None


def test_runtime_keys_parse_and_linear_is_not_ported(models):
    """The JAX pipeline's wire keys parse and change nothing: flow_bw comes
    back on the u16 lattice either way."""
    _, _, tm = models
    windows = [_window(9)]
    outs = [_drive(EvalPipeline(_config(vis=DSEC_VIS, runtime=runtime), tm,
                                device="cpu"), windows)[0]
            for runtime in ({}, {"packed_wire": False, "u32_wire": True,
                                 "probe_wire": True})]
    for k in ("fwl", "rsat", "aee", "flow_bw"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    assert outs[1]["flow_bw"].dtype == np.uint16
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EvalPipeline(_config(metrics={"warping": "Linear"}), tm,
                     device="cpu")


def test_ensure_bucket_pads_and_grows(models):
    _, _, tm = models
    pipe = EvalPipeline(_config(vis=DSEC_VIS, n_events_pad=32), tm,
                        device="cpu")
    short = _window(8, n=16)[0]
    out = pipe.ensure_bucket(short)
    assert out["event_list"].shape[1] == 32
    assert np.all(out["event_list"][:, 16:] == 0)
    big = _window(8, n=96)[0]
    with pytest.warns(UserWarning, match="event bucket grew"):
        out = pipe.ensure_bucket(big)
    assert pipe.criteria.n_events == 96
    assert pipe.vstate.event_ts.shape[2] == 96


def test_vis_policy():
    assert not VisPolicy(_config()).want("flow_bw")
    p = VisPolicy(_config(vis={"store": True, "show": ["error_flow"]}))
    assert p.want("error_flow") and p.want("flow_bw") and not p.want("flow")
    p = VisPolicy(_config(vis={"enabled": True}))
    assert all(p.want(k) for k in ("flow", "events", "iwe_bw_window"))


def test_consume_mets_and_consumer():
    rng = np.random.default_rng(0)
    flow = rng.normal(size=(1, 4, 5, 2)).astype(np.float32) * 3
    host = {"flow_bw": flow_to_u16(torch.from_numpy(flow)).numpy(),
            "aee": np.float32(1.5), "rsat": np.float32(0.9),
            "fwl": np.float32(1.2)}
    names = ["FWL", "RSAT", "AEE"]
    vr = initialize_quant_results({}, "seq", names)
    fb = consume_mets(host, vr, "seq", names)
    np.testing.assert_allclose(fb, flow, atol=1.0 / 128)
    assert vr["seq"]["AEE"] == {"metric": 1.5, "it": 1}

    windows = [({"aee": torch.tensor(float(i)), "fwl": torch.tensor(1.0)},
                f"seq{i % 2}") for i in range(6)]
    consumer = MetricsConsumer(names, depth=2)
    for mets, seq in windows:
        consumer.put(mets, seq)
    res = consumer.close()
    assert res["seq0"]["AEE"] == {"metric": 0.0 + 2.0 + 4.0, "it": 3}
    assert res["seq1"]["FWL"] == {"metric": 3.0, "it": 3}

    bad = MetricsConsumer(["FWL"], depth=2)
    bad.put({"fwl": "not-a-number"}, "seq0")
    with pytest.raises(ValueError):
        bad.close()


# ----------------------------------------------------------------- hygiene


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "taming_event_flow_tpu",
              "h5py", "yaml")


def _port_files():
    pkg = os.path.join(REPO, "taming_event_flow_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_nothing_of_jax():
    files = list(_port_files())
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in _FORBIDDEN, (path, name)


def test_entry_points_raise_without_cuda(monkeypatch, models):
    """With no card and no ``device`` given, the entry points raise: the
    port never falls back to the CPU on its own."""
    _, _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(MODEL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EvalPipeline(_config(), tm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IterativeValidation(ValConfig(res=RES, passes=PASSES), 1, N)
