"""The packed and u32 wires of the port against the JAX package's and
against the port's own plain wire: the u32 event words, the loader's
forward rectification maps, the packed training window, DSEC-protocol eval
windows on each wire (unrectified and rectified, through both
``EvalPipeline``s), and both CLIs with ``runtime.packed_wire`` on and off.

The wires are exact by construction, so every comparison between the
port's wires is bitwise; the port against the JAX pipeline is held to the
pipeline-parity tolerance (``tests/test_pipeline_parity.py:196``). CPU: the
row gather of the u32 wire's lookup runs its plain version here;
``chip_smoke.py`` runs the kernel on the card.
"""

import argparse
import os
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import eval_flow_torch
import train_flow_torch
from taming_event_flow_tpu.data import H5Loader as JaxLoader
from taming_event_flow_tpu.data import base as jbase
from taming_event_flow_tpu.ops import encodings as jenc
from taming_event_flow_tpu.pipeline import EvalPipeline as JaxEvalPipeline
from taming_event_flow_tpu.training import step as jstep
from taming_event_flow_tpu.training import window as jwindow
from taming_event_flow_tpu_torch import data as tdata
from taming_event_flow_tpu_torch import ops as tops
from taming_event_flow_tpu_torch.configs import YAMLParser
from taming_event_flow_tpu_torch.data import H5Loader, write_synthetic_h5
from taming_event_flow_tpu_torch.pipeline import EvalPipeline
from taming_event_flow_tpu_torch.training import (
    stack_window,
    unpack_window,
)
from taming_event_flow_tpu_torch.utils import u16_to_flow

from .test_torch_data import make_config
from .test_torch_eval_cli import eval_cfg
from .test_torch_rectify import (
    METRIC_TOL,
    PASSES,
    RES,
    _config,
    _maps,
    _rectified_sequence,
    models,  # noqa: F401 (fixture)
)
from .test_torch_train_cli import RES as CLI_RES
from .test_torch_train_cli import losses, train_cfg, write_cfg
from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

WIRES = {"plain": {"packed_wire": False},
         "packed": {"packed_wire": True, "u32_wire": False},
         "u32": {"packed_wire": True, "u32_wire": True}}


def _events(rng, shape, res, pad_rows=0):
    ys = rng.integers(0, res[0], shape).astype(np.float32)
    xs = rng.integers(0, res[1], shape).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], shape).astype(np.float32)
    if pad_rows:
        ys[..., -pad_rows:] = xs[..., -pad_rows:] = ps[..., -pad_rows:] = 0
    return ys, xs, ps


def test_event_wire_matches_jax(rng):
    """Packing on the host, and unpacking with and without the forward map
    (the last row and column included): bitwise the JAX package's, and the
    looked-up coordinates bitwise the host's ``rectify_events``."""
    shape = (3, 2, 50)
    ys, xs, ps = _events(rng, shape, RES, pad_rows=5)
    ys[0, 0, 0], xs[0, 0, 0] = RES[0] - 1, RES[1] - 1
    words = tops.pack_event_wire_np(ys, xs, ps)
    ref = jenc.pack_event_wire_np(ys, xs, ps)
    assert words.dtype == ref.dtype == np.uint32
    np.testing.assert_array_equal(words, ref)
    ts = rng.uniform(0, 1, shape).astype(np.float32)
    fwd, _ = _maps(RES)
    for rect in (None, fwd):
        jev, jraw = jenc.unpack_event_wire(
            jnp.asarray(ts), jnp.asarray(words),
            None if rect is None else jnp.asarray(rect))
        for yxp in (torch.from_numpy(words),
                    torch.from_numpy(words.view(np.int32))):
            ev, raw = tops.unpack_event_wire(
                torch.from_numpy(ts), yxp,
                None if rect is None else torch.from_numpy(rect))
            np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
            np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    rx, ry = tdata.rectify_events(fwd, xs.reshape(-1), ys.reshape(-1))
    np.testing.assert_array_equal(ev[..., 1].numpy().reshape(-1), ry)
    np.testing.assert_array_equal(ev[..., 2].numpy().reshape(-1), rx)


def _pack_through_int64(ys, xs, ps):
    """The pack as the port wrote it before it took ``out=``: numpy
    temporaries, the polarity code in int64."""
    pcode = np.where(ps > 0, 1, 0) + np.where(ps < 0, 2, 0)
    return ((ys.astype(np.uint32) << 16) | (xs.astype(np.uint32) << 2)
            | pcode.astype(np.uint32))


def _wire_window(rng, case):
    """A ``[P, 1, N, 4]`` float32 event list: loader-like random windows
    with padding rows, or the format's edges (y = 65535, x = 16383, every
    polarity in {-1, 0, +1} at each corner, padding rows)."""
    ev = np.zeros((3, 1, 64, 4), np.float32)
    if case == "random":
        ys, xs, ps = _events(rng, ev.shape[:-1], (480, 640), pad_rows=9)
    else:
        corners = [(y, x, p) for y in (0, 65535) for x in (0, 16383)
                   for p in (-1.0, 0.0, 1.0)]
        ys, xs, ps = (np.zeros(ev.shape[:-1], np.float32) for _ in range(3))
        for i, (y, x, p) in enumerate(corners):
            ys[i % 3, 0, i], xs[i % 3, 0, i], ps[i % 3, 0, i] = y, x, p
        ys[:, :, 40:50] = 65535
        xs[:, :, 40:50] = 16383
        ps[:, :, 40:50] = rng.choice([-1.0, 1.0], (3, 1, 10))
    ev[..., 0] = rng.uniform(0, 1, ev.shape[:-1])
    ev[..., 1], ev[..., 2], ev[..., 3] = ys, xs, ps
    return ev


@pytest.mark.parametrize("case", ["random", "edges"])
@pytest.mark.parametrize("into", [False, True],
                         ids=["returned", "into_staging_rows"])
def test_pack_into_buffer_is_bitwise(rng, case, into):
    """``pack_event_wire_np``, with and without ``out=``, gives the words
    of the int64 pack and of the JAX package's, from the event list's
    strided columns. ``out=`` (a pass's row of an int32 staging buffer,
    holding stale words) receives exactly the words returned."""
    ev = _wire_window(rng, case)
    ys, xs, ps = ev[..., 1], ev[..., 2], ev[..., 3]
    want = _pack_through_int64(ys, xs, ps)
    np.testing.assert_array_equal(jenc.pack_event_wire_np(ys, xs, ps), want)
    if into:
        buf = np.full(ev.shape[:-1], -1, np.int32).view(np.uint32)
        for k in range(ev.shape[0]):
            row = buf[k]
            got = tops.pack_event_wire_np(ys[k], xs[k], ps[k], out=row)
            assert got is row
            np.testing.assert_array_equal(got, want[k])
        words = buf
    else:
        words = tops.pack_event_wire_np(ys, xs, ps)
    assert words.dtype == np.uint32
    np.testing.assert_array_equal(words, want)


def test_rectify_values_match_jax_loader(tmp_path, monkeypatch):
    """``H5Loader.rectify_values()``: the lanes' forward maps as the JAX
    loader stacks them, ``None`` for an unrectified file."""
    monkeypatch.setattr(jbase, "cv2", None)
    for name, kw in (("rect", dict(rectify=True)), ("plain", {})):
        d = tmp_path / name
        write_synthetic_h5(str(d / "seq0.h5"), n_events=2000, res=RES,
                           seed=3, **kw)
        cfg = make_config(str(d), batch_size=2)
        ours, ref = H5Loader(cfg), JaxLoader(cfg)
        ours.next_batch()
        ref.next_batch()
        a, b = ours.rectify_values(), ref.rectify_values()
        if name == "plain":
            assert a is None and b is None
            continue
        assert a.dtype == b.dtype == np.float32 and a.shape == (2,) + RES + (
            2,)
        np.testing.assert_array_equal(a, b)


def _loader_batches(rng, p=3, b=2, sizes=(40, 64, 52), res=RES):
    out = []
    for k in range(p):
        ys, xs, ps = _events(rng, (b, sizes[k]), res, pad_rows=4)
        ev = np.stack([rng.uniform(0, 1, ys.shape), ys, xs, ps],
                      -1).astype(np.float32)
        net = np.stack([tdata.events_to_channels_np(xs[i], ys[i], ps[i], res)
                        for i in range(b)]).astype(np.float32)
        out.append({
            "net_input": net, "event_list": ev,
            "event_list_pol_mask": np.stack([ps > 0, ps < 0],
                                            -1).astype(np.float32),
            "grad_mask": (rng.uniform(size=ys.shape + (1,)) < 0.7).astype(
                np.float32),
        })
    return out


@pytest.mark.parametrize("kw", [{}, {"net_compact": True},
                                {"derive_net": True}],
                         ids=["f32_net", "compact_net", "derived_net"])
def test_packed_window_unpacks_to_the_plain_one(rng, kw):
    """``stack_window(packed=True)`` array for array the JAX package's, and
    ``unpack_window`` of it, the plain window, element for element (as the
    JAX ``unpack_window`` of the JAX packed window)."""
    batches = _loader_batches(rng)
    packed = stack_window(batches, packed=True, **kw)
    ref = jwindow.stack_window(batches, packed=True, **kw)
    assert sorted(packed) == sorted(ref)
    for k in ref:
        assert packed[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(packed[k], ref[k])
    if kw.get("net_compact"):
        assert packed["net_input"].dtype == np.uint8
    plain = unpack_window({k: torch.from_numpy(v) for k, v in
                           stack_window(batches).items()})
    got = unpack_window({k: torch.from_numpy(v) for k, v in packed.items()},
                        res=RES)
    jgot = jstep.unpack_window({k: jnp.asarray(v) for k, v in ref.items()},
                               res=RES)
    for k in plain:
        assert got[k].dtype == plain[k].dtype == torch.float32, k
        torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jgot[k]))


def _plain_sequence(seed, n_windows=2):
    """Unrectified DSEC-like windows (integer coordinates, host-built
    count input, padding rows), ``_rectified_sequence``'s layout."""
    rng = np.random.default_rng(seed)
    windows = []
    for _ in range(n_windows):
        batches = []
        for _ in range(PASSES):
            n = int(rng.integers(60, 90))
            ys, xs, ps = _events(rng, (n,), RES)
            ev = np.zeros((1, n, 4), np.float32)
            ev[0, :, 0] = np.sort(rng.uniform(0, 1, n))
            ev[0, 0, 0] = 0.0
            ev[0, :, 1], ev[0, :, 2], ev[0, :, 3] = ys, xs, ps
            net = tdata.events_to_channels_np(xs, ys, ps, RES)
            batches.append({
                "event_list": ev,
                "event_list_pol_mask": np.stack([ps > 0, ps < 0], -1)[None]
                .astype(np.float32),
                "net_input": net[None].astype(np.float32),
                "event_mask": (net.sum(-1, keepdims=True) > 0)[None]
                .astype(np.float32),
            })
        batches[-1]["gtflow"] = rng.normal(size=(1,) + RES + (2,)).astype(
            np.float32)
        windows.append(batches)
    return windows


def _drive(pipe, windows, ridx=None, rect=None):
    pipe.cur_ridx = ridx
    pipe.cur_rect = rect
    out = []
    for batches in windows:
        for b in batches:
            pipe.ingest(pipe.ensure_bucket(b), {"ts": 0.0})
        m = pipe.boundary_metrics(batches[-1], {"ts": 0.0})
        out.append({k: np.asarray(m[k]) for k in ("fwl", "rsat", "aee",
                                                   "flow_bw")})
    return out


@pytest.mark.parametrize("rectified", [False, True],
                         ids=["unrectified", "rectified"])
def test_eval_window_wires_match(models, rectified):  # noqa: F811
    """One DSEC-protocol window sequence on the plain, packed and u32
    wires: the port's metrics bitwise equal across its wires, each within
    the pipeline-parity tolerance of the JAX pipeline on the same wire;
    ``flow_bw`` float32 on the plain wire, the u16 lattice on the packed
    ones. The u32 wire really ran (the staged events are its dict, the
    rectified one with the forward map)."""
    jm, params, tm = models
    vis = {"store": True, "show": ["flow_bw"]}
    if rectified:
        windows, ridx = _rectified_sequence(8)
        rect, _ = _maps(RES)
    else:
        windows, ridx, rect = _plain_sequence(8), None, None
    results = {}
    for wire, runtime in WIRES.items():
        config = dict(_config(vis), runtime=runtime)
        pipe = EvalPipeline(config, tm, device="cpu")
        results[wire] = _drive(pipe, windows, ridx, rect)
        if wire == "u32":
            staged = pipe.stage_window([pipe.ensure_bucket(b)
                                        for b in windows[0]])[1]
            assert isinstance(staged, dict)
            assert ("rect" in staged) == rectified
        jpipe = JaxEvalPipeline(config, jm, params, auto_shard=False)
        jpipe.cur_rect = None if rect is None else jnp.asarray(rect)
        ref = _drive(jpipe, windows,
                     None if ridx is None else jnp.asarray(ridx))
        for o, r in zip(results[wire], ref):
            for k in ("fwl", "rsat", "aee"):
                np.testing.assert_allclose(o[k], r[k], err_msg=k,
                                           **METRIC_TOL)
            assert o["flow_bw"].dtype == r["flow_bw"].dtype
    for wire in ("packed", "u32"):
        for o, p in zip(results[wire], results["plain"]):
            for k in ("fwl", "rsat", "aee"):
                assert o[k] == p[k], (wire, k)
            assert o["flow_bw"].dtype == np.uint16
            assert p["flow_bw"].dtype == np.float32
            np.testing.assert_allclose(u16_to_flow(o["flow_bw"]),
                                       p["flow_bw"], rtol=0, atol=1 / 128)


def test_probe_wire_sections(models):  # noqa: F811
    """``runtime.probe_wire`` adds its two sections to the pipeline's
    timer, once a window, and changes no metric."""
    _, _, tm = models
    windows = _plain_sequence(9)
    vis = {"store": True, "show": ["flow_bw"]}
    plain = _drive(EvalPipeline(_config(vis), tm, device="cpu"), windows)
    pipe = EvalPipeline(dict(_config(vis), runtime={"probe_wire": True}), tm,
                        device="cpu")
    probed = _drive(pipe, windows)
    for name in ("probe_prev_state_drain", "probe_staged_input_drain"):
        assert pipe.tm.counts[name] == len(windows), name
    for a, b in zip(probed, plain):
        for k in ("fwl", "rsat", "aee"):
            assert a[k] == b[k]


# ----------------------------------------------------------------- CLIs


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """A plain and a rectified file, written once."""
    root = tmp_path_factory.mktemp("wire_cli")
    ds = root / "data"
    write_synthetic_h5(str(ds / "seq0.h5"), n_events=3000, res=CLI_RES,
                       n_flow_frames=8, seed=1)
    rect = root / "data_rect"
    write_synthetic_h5(str(rect / "seq_rect.h5"), n_events=3000,
                       res=CLI_RES, n_flow_frames=8, seed=3, rectify=True)
    return root, str(ds), str(rect)


@pytest.fixture(scope="module")
def cli_run(cli_data):
    """A port training run of one epoch, for the eval A/B."""
    root, ds, _ = cli_data
    return _train(root, ds, True, "for_eval")[0]


def _train(root, ds, packed, tag):
    cfg = train_cfg(ds, n_epochs=1)
    cfg["runtime"] = {"packed_wire": packed}
    path = write_cfg(root / f"train_{tag}.yml", cfg)
    runid = train_flow_torch.train(argparse.Namespace(
        config=path, path_mlflow=str(root), path_cache="", prev_runid=""),
        YAMLParser(path), device="cpu")
    return runid, losses(root, runid)


@pytest.mark.parametrize("data", ["plain", "rectified"])
def test_train_cli_packed_wire_ab(cli_data, data):
    """``train_flow_torch.py`` with the packed wire on and off logs the
    same loss history, bit for bit (the wire is exact; on the rectified
    file the count input ships, since a lane is rectified)."""
    root, ds, rect = cli_data
    src = ds if data == "plain" else rect
    _, on = _train(root, src, True, f"{data}_on")
    _, off = _train(root, src, False, f"{data}_off")
    assert on and np.isfinite(on).all() and on == off


def _pngs(base):
    base = pathlib.Path(base)
    return {str(p.relative_to(base)): p.read_bytes()
            for p in sorted(base.rglob("*.png"))}


@pytest.mark.parametrize("data", ["plain", "rectified"])
def test_eval_cli_packed_wire_ab(cli_data, cli_run, data):
    """``eval_flow_torch.py`` with the packed wire on and off (the u32 wire
    rides the packed one) on a run of the training A/B: identical metrics
    and identical ``flow_bw`` PNG bytes, on a plain and on a rectified
    file."""
    root, ds, rect = cli_data
    runid = cli_run
    out = {}
    for packed in (True, False):
        cfg = eval_cfg(ds if data == "plain" else rect, store=True)
        cfg["loader"]["n_events_pad"] = 1001
        cfg["runtime"] = {"packed_wire": packed}
        tag = f"{data}_{packed}"
        path = write_cfg(root / f"eval_{tag}.yml", cfg)
        res_dir = root / f"res_{tag}"
        results = eval_flow_torch.test(argparse.Namespace(
            runid=runid, config=path, path_mlflow=str(root),
            path_results=str(res_dir) + "/"), YAMLParser(path), device="cpu")
        out[packed] = (results, _pngs(os.path.join(res_dir, runid,
                                                   "results")))
    (r_on, png_on), (r_off, png_off) = out[True], out[False]
    assert png_on and sorted(png_on) == sorted(png_off)
    for k in png_on:
        assert png_on[k] == png_off[k], f"PNG bytes differ: {k}"
    assert r_on == r_off and r_on["AEE"]
