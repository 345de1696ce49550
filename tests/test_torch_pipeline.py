"""The port's eval slice against the JAX package's: both ``EvalPipeline``s on
the same tiny protocol (32x48, P=4, N=64) with the same weights and the same
synthetic windows, plus the pipeline's units and the port's hygiene (no JAX
imports, no silent CPU fallback)."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taming_event_flow_tpu.models import RecEVFlowNet as JaxRecEVFlowNet
from taming_event_flow_tpu.pipeline import EvalPipeline as JaxEvalPipeline
from taming_event_flow_tpu_torch.metrics import (
    IterativeValidation,
    LinearValidation,
    ValConfig,
)
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

from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

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
        # flow_bw in the wire's dtype (the u16 lattice on the packed wire,
        # float32 on the plain one), within one lattice step
        assert o["flow_bw"].dtype == r["flow_bw"].dtype

        def lattice(bw):
            if bw.dtype == np.uint16:
                return bw.astype(np.int64)
            return flow_to_u16(torch.tensor(bw)).numpy().astype(np.int64)

        assert np.abs(lattice(o["flow_bw"]) - lattice(r["flow_bw"])).max() \
            <= 1


@pytest.mark.parametrize("runtime,jump_at", [
    ({}, None),  # windowed, everything derived from the event lists
    # the plain wire: net input and masks ship as the loader built them,
    # flow_bw comes back float32, in both pipelines
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


def test_runtime_keys_parse_and_linear_builds(models):
    """The JAX pipeline's wire keys parse and change no metric: the plain
    wire (with the u32 and probe keys beside it) gives the packed one's
    metrics bit for bit, and its flow_bw comes back float32, the packed
    wire's u16 lattice its exact encoding. A Linear pipeline builds with
    the Linear validation."""
    _, _, tm = models
    windows = [_window(9)]
    outs = [_drive(EvalPipeline(_config(vis=DSEC_VIS, runtime=runtime), tm,
                                device="cpu"), windows)[0]
            for runtime in ({}, {"packed_wire": False, "u32_wire": True,
                                 "probe_wire": True})]
    for k in ("fwl", "rsat", "aee"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    assert outs[0]["flow_bw"].dtype == np.uint16
    assert outs[1]["flow_bw"].dtype == np.float32
    np.testing.assert_array_equal(
        flow_to_u16(torch.from_numpy(outs[1]["flow_bw"])).numpy(),
        outs[0]["flow_bw"])
    pipe = EvalPipeline(_config(metrics={"warping": "Linear"}), tm,
                        device="cpu")
    assert isinstance(pipe.criteria, LinearValidation)


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


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack",
              "taming_event_flow_tpu")
# optional host packages: imported only inside the functions that use them
_FUNCTION_ONLY = ("h5py", "yaml", "cv2")


def _port_files():
    pkg = os.path.join(REPO, "taming_event_flow_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "bench_torch.py")
    yield os.path.join(REPO, "train_flow_torch.py")
    yield os.path.join(REPO, "eval_flow_torch.py")
    yield os.path.join(REPO, "examples", "streaming_inference_torch.py")
    yield os.path.join(REPO, "scripts", "import_torch_checkpoint_torch.py")


def _imports(tree):
    """``(name, at_import_time)`` of every import in ``tree``: at import
    time unless it sits inside a function."""

    def walk(node, in_function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                for a in child.names:
                    yield a.name, not in_function
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module, not in_function
            yield from walk(child, in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    return walk(tree, False)


def test_port_imports_nothing_of_jax():
    """No port file (the package, ``chip_smoke.py``, ``bench_torch.py``,
    ``train_flow_torch.py``, ``eval_flow_torch.py``, the streaming example
    and the import script) imports JAX, the JAX package or ``msgpack`` anywhere, nor h5py, PyYAML
    or cv2 at import time."""
    files = list(_port_files())
    assert len(files) > 25
    pkg = os.path.join(REPO, "taming_event_flow_tpu_torch")
    assert {os.path.join(pkg, "objectives", "linear.py"),
            os.path.join(pkg, "models", "fire.py"),
            os.path.join(pkg, "tracking", "flax_msgpack.py"),
            os.path.join(pkg, "parallel", "event.py"),
            os.path.join(pkg, "parallel", "collectives.py")} <= set(files)
    late = set()
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for name, at_import in _imports(tree):
            top = name.split(".")[0]
            assert top not in _FORBIDDEN, (path, name)
            assert not (at_import and top in _FUNCTION_ONLY), (path, name)
            if top in _FUNCTION_ONLY:
                late.add(top)
    assert late == set(_FUNCTION_ONLY)  # the scan sees function bodies


def _port_modules():
    pkg = os.path.join(REPO, "taming_event_flow_tpu_torch")
    out = ["train_flow_torch", "eval_flow_torch", "chip_smoke", "bench_torch",
           "examples.streaming_inference_torch",
           "scripts.import_torch_checkpoint_torch"]
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                parts = os.path.relpath(os.path.join(root, f),
                                        REPO)[:-3].split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                out.append(".".join(parts))
    return sorted(out)


def test_port_imports_without_optional_packages():
    """In a process where h5py, PyYAML and cv2 cannot be imported, every
    port module, both CLIs, the streaming example and the import script
    import, and the parser builds a config from its defaults; nothing of
    JAX is loaded."""
    modules = _port_modules()
    assert len(modules) > 25
    assert {"taming_event_flow_tpu_torch.objectives.linear",
            "taming_event_flow_tpu_torch.models.fire",
            "taming_event_flow_tpu_torch.parallel.multihost"} <= set(modules)
    code = "\n".join([
        "import importlib, sys",
        "for name in ('h5py', 'yaml', 'cv2'):",
        "    sys.modules[name] = None",
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        "from taming_event_flow_tpu_torch.configs import YAMLParser",
        "assert YAMLParser().config['loader']['batch_size'] == 1",
        "assert not any(k.split('.')[0] in ('jax', 'taming_event_flow_tpu',",
        "                                   'msgpack')",
        "               for k in sys.modules)",
        "print('imported', len(sys.modules))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "imported" in out.stdout


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
