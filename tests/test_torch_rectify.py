"""The port's rectified slice against the JAX package: the row gather held
to the study kernel ``dma_gather`` (``scripts/bench_dma_gather.py``, Pallas
in interpret mode), the count input's rectification remap, the numpy
rectification helpers, and one rectified DSEC-protocol window through both
``EvalPipeline``s (32x40, P=3, a narrow RecEVFlowNet from converted Flax
parameters). CPU: the port's wrappers run their plain PyTorch versions;
``chip_smoke.py`` holds the CUDA kernel to them on the card."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as jpl

from taming_event_flow_tpu.data import base as jbase
from taming_event_flow_tpu.models import RecEVFlowNet as JaxRecEVFlowNet
from taming_event_flow_tpu.ops import encodings as jenc
from taming_event_flow_tpu.pipeline import EvalPipeline as JaxEvalPipeline
from taming_event_flow_tpu_torch import data as tdata
from taming_event_flow_tpu_torch import ops as tops
from taming_event_flow_tpu_torch.models import (
    build_model,
    flax_params_to_state_dict,
)
from taming_event_flow_tpu_torch.pipeline import EvalPipeline
from taming_event_flow_tpu_torch.training.step import _derive_inputs
from taming_event_flow_tpu_torch.training.window import pad_batch_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (32, 40)
PASSES, N_PAD = 3, 96
BORDER = 2  # out-of-source pixels around the rectified frame
METRIC_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_pipeline_parity.py:196


# ------------------------------------------------------- row gather (kernel 4)


def _load_study():
    path = os.path.join(REPO, "scripts", "bench_dma_gather.py")
    spec = importlib.util.spec_from_file_location("bench_dma_gather", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("width", [1, 2, 8])
def test_row_gather_plain_matches_dma_gather(rng, monkeypatch, width):
    """The study's Pallas kernel, run in interpret mode (``dma_gather``
    imports ``pallas`` inside the function, so the patched ``pallas_call``
    takes effect), against the plain row gather: exact."""
    real = jpl.pallas_call
    monkeypatch.setattr(
        jpl, "pallas_call",
        lambda *a, **k: real(*a, **{**k, "interpret": True}))
    study = _load_study()
    rows, m = 1000, 1024
    table = rng.normal(size=(rows, width)).astype(np.float32)
    idx = rng.integers(0, rows, m).astype(np.int32)
    ref = np.asarray(study.dma_gather(jnp.asarray(table), jnp.asarray(idx),
                                      depth=8, block=512))
    out = tops.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert out.shape == (m, width) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(ref, table[idx])


def test_row_gather_clamps_out_of_range_indices(rng):
    table = rng.normal(size=(7, 3)).astype(np.float32)
    idx = np.array([-5, -1, 0, 3, 6, 7, 100], np.int32)
    out = tops.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), table[np.clip(idx, 0, 6)])
    empty = tops.row_gather(torch.from_numpy(table),
                            torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, 3)


def test_row_gather_raises_instead_of_falling_back():
    """A table that requires grad raises under grad mode (no path
    differentiates through the row gather); a tensor that is neither on
    the CPU nor on a card has no kernel; wrong types and shapes raise."""
    idx = torch.zeros(4, dtype=torch.int32)
    table = torch.ones(3, 2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        tops.row_gather(table, idx)
    with torch.no_grad():
        assert tops.row_gather(table, idx).shape == (4, 2)
    with pytest.raises(ValueError, match="no kernel"):
        tops.row_gather(torch.zeros(3, 2, device="meta"),
                        torch.zeros(4, dtype=torch.int32, device="meta"))
    with pytest.raises(TypeError, match="int32"):
        tops.row_gather(torch.zeros(3, 2), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError, match="float32"):
        tops.row_gather(torch.zeros(3, 2, dtype=torch.float64), idx)
    with pytest.raises(ValueError, match="empty table"):
        tops.row_gather(torch.zeros(0, 2), idx)
    assert tops.LAUNCHES["row_gather"] == 0


# ------------------------------------------------- rectified count input


def _hole_index(rng, lanes, res):
    """A random 1-based gather index with out-of-source pixels (0), as a
    cv2-built index carries them."""
    h, w = res
    ridx = rng.integers(1, h * w + 1, (lanes, h, w)).astype(np.int32)
    ridx[rng.uniform(size=ridx.shape) < 0.2] = 0
    return ridx


@pytest.mark.parametrize("lanes", [1, 2])
def test_derive_count_input_remap_matches_jax(rng, lanes):
    """A [P, B, N, 4] window with rectified (fractional) coordinates in the
    list, the raw integer ones beside it and one [B, H, W] index broadcast
    over the passes: exact against the JAX derivation."""
    res, p, n = (9, 11), 3, 50
    raw = np.zeros((p, lanes, n, 2), np.uint16)
    raw[..., 0] = rng.integers(0, res[0], (p, lanes, n))
    raw[..., 1] = rng.integers(0, res[1], (p, lanes, n))
    ev = np.zeros((p, lanes, n, 4), np.float32)
    ev[..., 1:3] = raw + rng.uniform(-0.4, 0.4, raw.shape)
    ev[..., 3] = rng.choice([-1.0, 1.0], (p, lanes, n))
    ev[..., -n // 5:, 3] = 0.0  # padding rows
    ridx = _hole_index(rng, lanes, res)
    ref = np.asarray(jenc.derive_count_input(
        jnp.asarray(ev), res, raw_xy=jnp.asarray(raw),
        remap_idx=jnp.asarray(ridx)))
    out = tops.derive_count_input(torch.from_numpy(ev), res,
                                  raw_xy=torch.from_numpy(raw),
                                  remap_idx=torch.from_numpy(ridx))
    assert out.shape == ref.shape == (p, lanes) + res + (2,)
    assert (ref == 0).all(-1).any() and ref.max() >= 1
    np.testing.assert_array_equal(out.numpy(), ref)
    # raw coordinates alone: the unrectified counts at the raw pixels
    np.testing.assert_array_equal(
        tops.derive_count_input(torch.from_numpy(ev), res,
                                raw_xy=torch.from_numpy(raw)).numpy(),
        np.asarray(jenc.derive_count_input(jnp.asarray(ev), res,
                                           raw_xy=jnp.asarray(raw))))


def _maps(res, k=0.04):
    """A mild radial distortion: the forward map (file layout,
    ``[y_raw, x_raw] = (x_rect, y_rect)``) and an approximate backward
    mapping (``[y_rect, x_rect] = (x_raw, y_raw)``), both float32."""
    h, w = res
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cy, cx = (h - 1) / 2, (w - 1) / 2
    r2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / (cy ** 2 + cx ** 2)
    fwd = np.stack([cx + (xx - cx) * (1 + k * r2),
                    cy + (yy - cy) * (1 + k * r2)], -1).astype(np.float32)
    bwd = np.stack([cx + (xx - cx) * (1 - k * r2),
                    cy + (yy - cy) * (1 - k * r2)], -1).astype(np.float32)
    return fwd, bwd


def test_rectification_helpers_match_jax_loader(rng, monkeypatch):
    """``remap_index``, ``remap``, ``rectify_events`` and
    ``events_to_channels_np`` against the JAX loader's numpy paths (cv2
    switched off): exact."""
    monkeypatch.setattr(jbase, "cv2", None)
    loader = jbase.BaseStreamLoader({
        "loader": {"resolution": list(RES), "batch_size": 1},
        "data": {}})
    fwd, bwd = _maps(RES, k=0.3)  # strong enough to clip at the border
    ridx = tdata.remap_index(bwd, RES)
    np.testing.assert_array_equal(ridx, loader.remap_index(bwd))
    assert ridx.dtype == np.int32 and ridx.min() >= 1
    img = rng.normal(size=RES + (3,)).astype(np.float32)
    np.testing.assert_array_equal(tdata.remap(img, bwd, RES),
                                  loader.remap(img, bwd))
    assert tdata.remap(img, None, RES) is img
    assert tdata.remap_index(None, RES) is None
    xs = rng.integers(0, RES[1], 200).astype(np.float32)
    ys = rng.integers(0, RES[0], 200).astype(np.float32)
    for a, b in zip(tdata.rectify_events(fwd, xs, ys),
                    loader.rectify_events(fwd, xs, ys)):
        np.testing.assert_array_equal(a, b)
    ps = rng.choice([-1.0, 0.0, 1.0], 200).astype(np.float32)
    np.testing.assert_array_equal(
        tdata.events_to_channels_np(xs, ys, ps, RES),
        jbase.events_to_channels_np(xs, ys, ps, RES))


# ------------------------------------------------- the rectified eval window


def _rectified_sequence(seed, n_windows=2):
    """Rectified DSEC-like windows: raw integer events, rectified
    coordinates in the event list from the forward map, the host-built
    count input remapped through the index (with a zeroed border, as cv2's
    out-of-source fill leaves it). Returns ``(windows, ridx [1, H, W])``."""
    rng = np.random.default_rng(seed)
    h, w = RES
    fwd, bwd = _maps(RES)
    ridx = tdata.remap_index(bwd, RES)
    ridx[:BORDER] = ridx[-BORDER:] = 0
    ridx[:, :BORDER] = ridx[:, -BORDER:] = 0
    src = np.where(ridx > 0, ridx - 1, 0).reshape(-1)
    windows = []
    for _ in range(n_windows):
        batches = []
        for _ in range(PASSES):
            n = int(rng.integers(60, 90))
            xs = rng.integers(0, w, n).astype(np.float32)
            ys = rng.integers(0, h, n).astype(np.float32)
            ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
            rx, ry = tdata.rectify_events(fwd, xs, ys)
            ev = np.zeros((1, n, 4), np.float32)
            ev[0, :, 0] = np.sort(rng.uniform(0, 1, n))
            ev[0, 0, 0] = 0.0
            ev[0, :, 1], ev[0, :, 2], ev[0, :, 3] = ry, rx, ps
            cnt = tdata.events_to_channels_np(xs, ys, ps, RES)
            net = np.where((ridx > 0)[..., None],
                           cnt.reshape(-1, 2)[src].reshape(h, w, 2), 0.0)
            raw = np.stack([ys, xs], -1).astype(np.uint16)[None]
            batches.append({
                "event_list": ev,
                "event_list_pol_mask": np.stack([ps > 0, ps < 0], -1)[None]
                .astype(np.float32),
                "event_raw_xy": raw,
                "net_input": net[None].astype(np.float32),
                "event_mask": (net.sum(-1, keepdims=True) > 0)[None]
                .astype(np.float32),
            })
        batches[-1]["gtflow"] = rng.normal(size=(1, h, w, 2)).astype(
            np.float32)
        windows.append(batches)
    return windows, ridx[None]


def _config(vis):
    return {
        "data": {"mode": "gtflow", "passes_loss": PASSES, "voxel": None,
                 "window": 1},
        "loader": {"resolution": list(RES), "n_events_pad": N_PAD},
        "loss": {"flow_scaling": 8, "round_ts": False},
        "metrics": {"warping": "Iterative", "name": ["FWL", "RSAT", "AEE"]},
        "vis": vis,
        "runtime": {},
    }


def _drive(pipe, windows, ridx):
    pipe.cur_ridx = ridx
    out = []
    for batches in windows:
        for b in batches:
            pipe.ingest(pipe.ensure_bucket(b), {"ts": 0.0})
        m = pipe.boundary_metrics(batches[-1], {"ts": 0.0})
        out.append({k: float(m[k]) for k in ("fwl", "rsat", "aee")})
    return out


@pytest.fixture(scope="module")
def models():
    jm = JaxRecEVFlowNet(num_bins=2, base_channels=8, num_encoders=2)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, *RES, 2)),
                     jm.init_state(1, *RES))["params"]
    tm = build_model({"name": "RecEVFlowNet", "base_channels": 8,
                      "num_encoders": 2}, device="cpu")
    tm.load_state_dict(
        flax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("vis", [
    {"store": True, "show": ["flow_bw"]},  # windowed path
    {"enabled": True},  # per-pass path
])
def test_rectified_window_matches_jax_pipeline(models, vis):
    """Both pipelines derive the count input from the raw coordinates and
    ``cur_ridx``; the port's metrics match the JAX package's, and equal
    the port's own on the host-built input (no index)."""
    jm, params, tm = models
    windows, ridx = _rectified_sequence(5)
    ref = _drive(JaxEvalPipeline(_config(vis), jm, params, auto_shard=False),
                 windows, jnp.asarray(ridx))
    pipe = EvalPipeline(_config(vis), tm, device="cpu")
    assert pipe.windowed == ("store" in vis)
    ours = _drive(pipe, windows, ridx)
    assert pipe.cur_ridx.dtype == torch.int32
    host = _drive(EvalPipeline(_config(vis), tm, device="cpu"), windows,
                  None)
    for o, r, hb in zip(ours, ref, host):
        for k in ("fwl", "rsat", "aee"):
            np.testing.assert_allclose(o[k], r[k], err_msg=k, **METRIC_TOL)
            assert o[k] == hb[k], k


def test_derived_rectified_input_equals_host_built():
    """The step's derivation from raw coordinates and the index is bitwise
    the host's remapped count input and event mask, per pass and for a
    whole stacked window; without an index the batch ships its input."""
    windows, ridx = _rectified_sequence(6, n_windows=1)
    batches = [pad_batch_events(b, N_PAD) for b in windows[0]]
    t = torch.from_numpy
    for b in batches:
        x, _, emask = _derive_inputs(RES, t(b["event_list"]), None, None,
                                     None, t(b["event_raw_xy"]), t(ridx))
        np.testing.assert_array_equal(x.numpy(), b["net_input"])
        np.testing.assert_array_equal(emask.numpy(), b["event_mask"])
    stack = lambda k: t(np.stack([b[k] for b in batches]))  # noqa: E731
    x, _, emask = _derive_inputs(RES, stack("event_list"), None, None, None,
                                 stack("event_raw_xy"), t(ridx))
    np.testing.assert_array_equal(x.numpy(), stack("net_input").numpy())
    np.testing.assert_array_equal(emask.numpy(), stack("event_mask").numpy())

    pipe = EvalPipeline(_config({"store": True, "show": ["flow_bw"]}),
                        build_model({"name": "RecEVFlowNet",
                                     "base_channels": 8, "num_encoders": 2},
                                    device="cpu"), device="cpu")
    assert not pipe._derive_on_device(batches[0])
    pipe.cur_ridx = ridx
    assert pipe._derive_on_device(batches[0])
    xs, _, emasks, _, raw = pipe.stage_window(batches)
    assert xs is None and emasks is None and raw.dtype == torch.uint16


def test_unpack_window_derives_rectified_counts():
    """A training window without ``net_input`` derives its count input from
    ``event_raw_xy`` and ``remap_idx`` when it carries them (the keys the
    JAX ``unpack_window`` reads)."""
    from taming_event_flow_tpu_torch.training import unpack_window

    windows, ridx = _rectified_sequence(7, n_windows=1)
    batches = [pad_batch_events(b, N_PAD) for b in windows[0]]
    stack = lambda k: torch.from_numpy(  # noqa: E731
        np.stack([b[k] for b in batches]))
    window = {"event_list": stack("event_list"),
              "event_raw_xy": stack("event_raw_xy"),
              "remap_idx": torch.from_numpy(ridx),
              "pol_mask": stack("event_list_pol_mask"),
              "grad_mask": torch.ones(PASSES, 1, N_PAD, 1)}
    out = unpack_window(window, res=RES)
    np.testing.assert_array_equal(out["net_input"].numpy(),
                                  stack("net_input").numpy())
