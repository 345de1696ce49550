"""The port's eval-side host code against the JAX package's: the image
codecs and colour maps (bitwise), the ``Visualization`` PNG store and its
writeback thread, ``EvalPipeline.vis_window_images``, ``batch_stream`` over
the same files, and the result loggers' files."""

import copy
import os
import pathlib

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from taming_event_flow_tpu.data import H5Loader as JaxH5Loader
from taming_event_flow_tpu.data import base as jbase
from taming_event_flow_tpu.models import RecEVFlowNet as JaxRecEVFlowNet
from taming_event_flow_tpu.pipeline import EvalPipeline as JaxEvalPipeline
from taming_event_flow_tpu.pipeline import batch_stream as jax_batch_stream
from taming_event_flow_tpu.tracking import loggers as jax_loggers
from taming_event_flow_tpu.tracking.store import TrackingStore as JaxStore
from taming_event_flow_tpu.utils import visualization as jvis
from taming_event_flow_tpu_torch.configs import DEFAULTS, deep_merge
from taming_event_flow_tpu_torch.data import H5Loader, write_synthetic_h5
from taming_event_flow_tpu_torch.models import (
    build_model,
    flax_params_to_state_dict,
)
from taming_event_flow_tpu_torch.pipeline import EvalPipeline, batch_stream
from taming_event_flow_tpu_torch.tracking import TrackingStore, loggers
from taming_event_flow_tpu_torch.utils import visualization as pvis

from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RES = (24, 32)
MODEL = {"name": "RecEVFlowNet", "base_channels": 8, "num_encoders": 2}

# ------------------------------------------------------------ colour maps


@pytest.mark.parametrize("scale", [1e-3, 1.0, 40.0, 0.0],
                         ids=["small", "unit", "large", "zero_range"])
def test_flow_to_image_is_bitwise_the_jax_function(scale):
    """The port's numpy HSV wheel equals the JAX function (which converts
    through matplotlib here) byte for byte; ``zero_range`` is a constant
    flow, whose magnitude range is 0."""
    rng = np.random.default_rng(int(scale * 1000) + 7)
    flow = (rng.normal(size=(64, 80, 2)) * scale).astype(np.float32)
    if scale == 0.0:
        flow[:] = np.array([1.5, -0.5], np.float32)
    ours = pvis.flow_to_image(flow)
    assert ours.dtype == np.uint8 and ours.shape == (64, 80, 3)
    np.testing.assert_array_equal(ours, jvis.flow_to_image(flow))


def test_hsv_wheel_matches_matplotlib_at_the_sector_edges():
    """Hue 1.0 (sector 6 wraps to 0), saturation 0 and every sector,
    against ``matplotlib.colors.hsv_to_rgb``."""
    import matplotlib.colors

    rng = np.random.default_rng(0)
    hsv = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    hsv[:6, 0] = np.arange(6) / 6.0
    hsv[6:12, 0] = 1.0
    hsv[12:18, 1] = 0.0
    np.testing.assert_array_equal(pvis._hsv_to_rgb(hsv),
                                  matplotlib.colors.hsv_to_rgb(hsv))


@pytest.mark.parametrize("scheme", ["green_red", "gray", "rpg", "prophesee"])
def test_events_to_image_is_bitwise_the_jax_function(scheme):
    rng = np.random.default_rng(1)
    cnt = rng.integers(0, 5, size=(20, 30, 2)).astype(np.float32)
    cnt[:5] = 0
    np.testing.assert_array_equal(pvis.events_to_image(cnt, scheme),
                                  jvis.events_to_image(cnt, scheme))
    with pytest.raises(ValueError):
        pvis.events_to_image(cnt, "sepia")


def test_error_to_image_is_bitwise_the_jax_function():
    rng = np.random.default_rng(2)
    err = rng.uniform(0, 45, (20, 30)).astype(np.float32)
    np.testing.assert_array_equal(pvis.error_to_image(err),
                                  jvis.error_to_image(err))


def test_dsec_codec_round_trip():
    rng = np.random.default_rng(3)
    flow = (rng.normal(size=(16, 20, 2)) * 10).astype(np.float32)
    enc = pvis.encode_dsec_flow(flow)
    assert enc.dtype == np.uint16 and enc.shape == (16, 20, 3)
    np.testing.assert_array_equal(enc, jvis.encode_dsec_flow(flow))
    np.testing.assert_allclose(pvis.decode_dsec_flow(enc), flow,
                               atol=1.0 / 128)
    # the device lattice is the PNG's x/y channels
    u16 = pvis.flow_to_u16(torch.from_numpy(flow)).numpy()
    np.testing.assert_array_equal(np.flip(enc, -1)[..., :2], u16)
    np.testing.assert_array_equal(
        pvis.encode_dsec_flow(pvis.u16_to_flow(u16)), enc)


# ------------------------------------------------------------- PNG store


def _vis_config(store=True, async_store=None):
    vis = {"enabled": False, "store": store, "bars": False}
    if async_store is not None:  # the JAX store's switch
        vis["async_store"] = async_store
    return {"vis": vis}


def _files(root):
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in root.rglob("*") if p.is_file()}


def _store_run(module, root, async_store=None, as_tensor=False):
    """Six steps over two sequences: flow_bw, events and flow panels (and
    the error panel, from flow_bw and the GT). ``as_tensor`` hands the
    slots to the store as torch tensors, flow_bw as the u16 lattice."""
    vis = module.Visualization(_vis_config(True, async_store), eval_id=0,
                               path_results=str(root))
    r = np.random.default_rng(3)
    for i in range(6):
        seq = "seq_a" if i < 4 else "seq_b"
        batch = {
            "net_input": r.integers(0, 4, (1, 8, 10, 2)).astype(np.float32),
            "gtflow": r.normal(size=(1, 8, 10, 2)).astype(np.float32),
        }
        flow_bw = pvis.u16_to_flow(pvis.flow_to_u16(torch.from_numpy(
            r.normal(size=(1, 8, 10, 2)).astype(np.float32) * 5)).numpy())
        flow = r.normal(size=(1, 8, 10, 2)).astype(np.float32)
        if as_tensor:
            vis.data["flow_bw"] = pvis.flow_to_u16(torch.from_numpy(flow_bw))
            vis.data["flow"] = torch.from_numpy(flow)
        else:
            vis.data["flow_bw"] = flow_bw
            vis.data["flow"] = flow
        vis.step(batch, sequence=seq, ts=0.1 * i,
                 show=["flow_bw", "events", "flow", "error_flow"])
    vis.close()
    return _files(os.path.join(str(root), "results", "eval_0"))


def test_store_matches_jax_sync_async_and_tensors(tmp_path):
    """The port's store, always on its writeback thread for a store-only
    protocol, writes the synchronous JAX store's bytes, and the same bytes
    when the slots hold tensors."""
    ref = _store_run(jvis, tmp_path / "jax", async_store=False)
    assert any(k.endswith("png") for k in ref)
    assert "seq_b/timestamps.txt" in ref
    vis = pvis.Visualization(_vis_config(), eval_id=0,
                             path_results=str(tmp_path / "probe"))
    assert vis._async
    assert _store_run(pvis, tmp_path / "async") == ref
    assert _store_run(pvis, tmp_path / "tensor", as_tensor=True) == ref


def test_store_worker_error_surfaces(tmp_path):
    """An exception on the writeback thread re-raises on close()."""
    vis = pvis.Visualization(_vis_config(), eval_id=0,
                             path_results=str(tmp_path))
    vis.data["flow_bw"] = "not an array"  # render() throws in the worker
    vis.step({}, sequence="s", ts=0.0, show=["flow_bw"])
    with pytest.raises(Exception):
        vis.close()
    vis.close()  # idempotent after the error is consumed


def test_store_full_queue_after_worker_error_does_not_hang(tmp_path):
    """With the bounded queue full and the worker failed, later step()s and
    close() unblock and re-raise instead of waiting on a full queue."""
    vis = pvis.Visualization(_vis_config(), eval_id=0,
                             path_results=str(tmp_path))
    with pytest.raises(Exception):
        for _ in range(24):
            vis.data["flow_bw"] = "not an array"
            vis.step({}, sequence="s", ts=0.0, show=["flow_bw"])
        vis.close()
    vis.close()


def test_store_snapshot_filtered_by_show(tmp_path):
    """A ``show=['flow_bw']`` store (the DSEC submission config) converts
    no other slot or input to the host."""

    class Explodes:
        """Stands in for a tensor whose conversion would be a copy."""

        def __array__(self, *a, **k):
            raise AssertionError("converted an unshown input")

    vis = pvis.Visualization(_vis_config(), eval_id=0,
                             path_results=str(tmp_path))
    r = np.random.default_rng(0)
    for i in range(3):
        vis.data["flow_bw"] = torch.from_numpy(
            r.normal(size=(1, 8, 10, 2)).astype(np.float32))
        vis.data["flow"] = Explodes()
        vis.step({"net_input": Explodes(), "gtflow": Explodes()},
                 sequence="s", ts=0.1 * i, show=["flow_bw"])
    vis.close()
    stored = os.listdir(os.path.join(str(tmp_path), "results", "eval_0",
                                     "s", "flow_bw"))
    assert len(stored) == 3


# ------------------------------------------------------ pipeline readouts


def _config(passes, vis, n_events_pad=64):
    cfg = {
        "data": {"mode": "gtflow", "passes_loss": passes, "voxel": None,
                 "window": 1},
        "loader": {"resolution": list(RES), "n_events_pad": n_events_pad},
        "loss": {"flow_scaling": 8, "round_ts": False},
        "metrics": {"warping": "Iterative", "name": ["FWL", "RSAT", "AEE"]},
        "vis": vis,
    }
    return cfg


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


def _batches(seed, n_pass, n=48):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_pass):
        ev = np.zeros((1, n, 4), np.float32)
        ev[0, :, 0] = np.sort(rng.uniform(0, 1, n))
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


WINDOW_PANELS = ["events_window", "iwe_fw_window", "iwe_bw_window",
                 "flow_window", "events_dynamic", "iwe_fw_dynamic",
                 "iwe_bw_dynamic", "flow_dynamic"]


def test_vis_window_images_match_jax(models):
    """At P = 2 with ``dynamic: true`` every window and dynamic panel after
    every pass equals the JAX pipeline's."""
    jm, params, tm = models
    cfg = _config(2, {"store": True, "dynamic": True, "show": WINDOW_PANELS})
    jpipe = JaxEvalPipeline(cfg, jm, params, auto_shard=False)
    pipe = EvalPipeline(cfg, tm, device="cpu")
    assert not pipe.windowed and not jpipe.windowed
    seen = set()
    for b in _batches(4, 6):
        jpipe.ingest(jpipe.ensure_bucket(b), {"ts": 0.0})
        pipe.ingest(pipe.ensure_bucket(b), {"ts": 0.0})
        ref, ours = jpipe.vis_window_images(), pipe.vis_window_images()
        assert set(ours) == set(ref)
        for key, val in ref.items():
            np.testing.assert_allclose(ours[key].numpy(), np.asarray(val),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
        seen |= set(ours)
        if pipe.passes_done == pipe.passes:
            jpipe.boundary_outputs(b, {"ts": 0.0})
            pipe.boundary_outputs(b, {"ts": 0.0})
    assert seen == set(WINDOW_PANELS)


@pytest.fixture(scope="module")
def stream_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream")
    write_synthetic_h5(str(root / "a_jump.h5"), n_events=2000, res=RES,
                       n_flow_frames=8, seed=5, gt_gap_after=0.5)
    write_synthetic_h5(str(root / "b_rect.h5"), n_events=2000, res=RES,
                       n_flow_frames=6, seed=6, rectify=True)
    return str(root)


def _stream_config(path):
    cfg = deep_merge(copy.deepcopy(DEFAULTS),
                     _config(2, {"store": True, "show": ["flow_bw"]}))
    cfg["data"]["path"] = path
    cfg["loader"].update(batch_size=1, augment=[], seed=11,
                         n_events_pad=512)
    return cfg


def test_batch_stream_matches_jax(models, stream_files, monkeypatch):
    """Over a file with a GT gap and a rectified file, the port's
    ``batch_stream`` yields the JAX one's batches and metadata: sequence,
    ts, end_test, bar_iters, the rectification index, and ``ts_jump_reset``
    set on the batch and cleared on the loader, and the u32 wire's forward
    rectification map. The port stages no window on the producer (the
    consumer stacks it), so its metadata holds those keys alone."""
    monkeypatch.setattr(jbase, "cv2", None)  # the port's numpy remap
    jm, params, tm = models
    cfg = _stream_config(stream_files)
    jdata, data = JaxH5Loader(cfg, shuffle=True), H5Loader(cfg, shuffle=True)
    jpipe = JaxEvalPipeline(cfg, jm, params, auto_shard=False)
    pipe = EvalPipeline(cfg, tm, device="cpu")
    assert pipe.windowed
    ref = list(jax_batch_stream(jdata, jpipe))
    ours = list(batch_stream(data, pipe))
    assert len(ours) == len(ref) > 10
    jumps = rect = 0
    for i, ((jb, jmeta), (b, meta)) in enumerate(zip(ref, ours)):
        assert set(b) == set(jb)
        for k in jb:
            np.testing.assert_array_equal(b[k], jb[k], err_msg=f"{i} {k}")
        for k in ("sequence", "ts", "end_test", "bar_iters"):
            assert meta[k] == jmeta[k], (i, k)
        if jmeta["remap_idx"] is None:
            assert meta["remap_idx"] is None
        else:
            rect += 1
            np.testing.assert_array_equal(meta["remap_idx"].numpy(),
                                          np.asarray(jmeta["remap_idx"]))
        if jmeta["rect_map"] is None:
            assert meta["rect_map"] is None
        else:
            np.testing.assert_array_equal(meta["rect_map"].numpy(),
                                          np.asarray(jmeta["rect_map"]))
        assert set(meta) == {"sequence", "ts", "end_test", "bar_iters",
                             "remap_idx", "rect_map"}, i
        jumps += bool(b["ts_jump_reset"].any())
    assert jumps >= 1 and rect >= 2
    assert sum("staged" in m for _, m in ref) >= 2  # the JAX producer's
    assert not any(lane.ts_jump_reset for lane in data.lanes)
    assert ours[-1][1]["end_test"]


# ---------------------------------------------------------------- loggers


def test_loggers_files_read_by_the_jax_store(tmp_path, monkeypatch):
    """``log_config``/``log_results`` write the JAX loggers' files and
    attach them to the run, where the JAX run store finds them; eval ids
    count up as the JAX ``next_eval_id`` counts."""
    root = str(tmp_path / "track")
    runid = TrackingStore(root).start_run().info.run_id
    monkeypatch.setattr(loggers, "default_store", lambda: TrackingStore(root))
    monkeypatch.setattr(jax_loggers, "default_store", lambda: JaxStore(root))
    cfg = {"data": {"mode": "gtflow", "window": 0.1}, "vis": {"show": None}}
    results = {"AEE": {"seq0": "1.25"}, "FWL": {"seq0": "1.01"}}
    dirs = {}
    for tag, mod in (("jax", jax_loggers), ("port", loggers)):
        d = mod.create_model_dir(str(tmp_path / tag), runid)
        ids = [mod.log_config(d, runid, cfg) for _ in range(2)]
        mod.log_results(runid, results, d, ids[-1])
        assert ids == [0, 1] and mod.next_eval_id(d) == 2
        dirs[tag] = d
    assert _files(dirs["port"]) == _files(dirs["jax"])
    art = JaxStore(root).get_run(runid).info.artifact_uri
    assert yaml.safe_load(open(os.path.join(art, "metrics_1.yml"))) == results
    assert yaml.safe_load(open(os.path.join(art, "eval_0.yml"))) == cfg
    vr = loggers.initialize_quant_results({}, "s", ["AEE", "FWL"])
    assert vr == jax_loggers.initialize_quant_results({}, "s", ["AEE", "FWL"])
