"""The port's data layer against the JAX package's: the streaming
``H5Loader`` batch for batch and array for array (exact: the same numpy
operations on the same file bytes), across the windowing modes, rollover,
``ts_jump``, every augmentation, the grad-event subsample, the event cap,
voxel inputs, file sharding, a rectified file and the sample cache; plus
the synthetic writer, the window assembly, the prefetcher and the
in-memory loader that ``chip_smoke.py`` falls back to without h5py.

``tests/test_data.py`` is the model. The JAX loader remaps a rectified
file's representations with cv2 when it imports; the port keeps the numpy
nearest path, so the rectified cases patch cv2 off in the JAX loader's base
module, as ``tests/test_torch_rectify.py`` does. The rectification map
itself is cv2's in both.
"""

import os
import warnings

import h5py
import numpy as np
import pytest

from taming_event_flow_tpu.data import H5Loader as JaxLoader
from taming_event_flow_tpu.data import base as jbase
from taming_event_flow_tpu.data.prefetch import Prefetcher as JaxPrefetcher
from taming_event_flow_tpu.data.synthetic import (
    write_synthetic_h5 as jax_write,
)
from taming_event_flow_tpu.training import window as jwindow
from taming_event_flow_tpu_torch import data as tdata
from taming_event_flow_tpu_torch.data import H5Loader, Prefetcher
from taming_event_flow_tpu_torch.training import window as twindow

RES = (32, 40)
N_BATCHES = 24  # enough for several rollovers in every case


def make_config(path, mode="time", window=0.2, batch_size=1, augment=(),
                augment_prob=(), voxel=None, max_grad=None, cache=False,
                seed=7, n_events_pad=None):
    return {
        "data": {"path": path, "mode": mode, "window": window,
                 "voxel": voxel, "cache": cache},
        "loader": {"resolution": list(RES), "batch_size": batch_size,
                   "augment": list(augment),
                   "augment_prob": list(augment_prob),
                   "max_num_grad_events": max_grad, "seed": seed,
                   "n_events_pad": n_events_pad},
        "vis": {"bars": False},
    }


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Directories of synthetic sequences, written by the JAX writer."""
    root = tmp_path_factory.mktemp("data")
    spec = {
        "plain": [dict(n_events=3000, seed=1), dict(n_events=2500, seed=2)],
        "gt": [dict(n_events=4000, n_flow_frames=10, seed=3)],
        "gap": [dict(n_events=4000, n_flow_frames=10, seed=4,
                     gt_gap_after=0.5)],
        "four": [dict(n_events=1200, seed=10 + i) for i in range(4)],
        "rect": [dict(n_events=3000, seed=5, rectify=True),
                 dict(n_events=2000, seed=6, rectify=True)],
    }
    out = {}
    for name, files in spec.items():
        d = root / name
        d.mkdir()
        for i, kw in enumerate(files):
            jax_write(str(d / f"seq{i}.h5"), res=RES, **kw)
        out[name] = str(d)
    return out


def assert_batches_equal(ours, ref, where):
    assert sorted(ours) == sorted(ref), where
    for key in ref:
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype and a.shape == b.shape, (where, key)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {key}")


def drive_both(make_ours, make_ref, n=N_BATCHES):
    """Build both loaders and compare ``n`` batches, their warnings and the
    loaders' stream state after each batch."""
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        ref = make_ref()
        ref_batches = []
        for _ in range(n):
            ref_batches.append(ref.next_batch())
            ref_batches[-1]["_state"] = (ref.seq_num, ref.truncated_events,
                                         [l.path for l in ref.lanes])
    with warnings.catch_warnings(record=True) as w_ours:
        warnings.simplefilter("always")
        ours = make_ours()
        assert ours.files == ref.files
        for i, rb in enumerate(ref_batches):
            ob = ours.next_batch()
            state = rb.pop("_state")
            assert_batches_equal(ob, rb, f"batch {i}")
            assert (ours.seq_num, ours.truncated_events,
                    [l.path for l in ours.lanes]) == state, i
    assert [str(x.message) for x in w_ours] == [str(x.message) for x in w_ref]
    return ours, ref, ref_batches


# name -> (dataset, make_config kwargs, H5Loader kwargs)
CASES = {
    "time": ("plain", dict(mode="time", window=0.25), {}),
    "time_two_lanes_shuffled": ("plain", dict(mode="time", window=0.1,
                                              batch_size=2),
                                dict(shuffle=True)),
    "events": ("plain", dict(mode="events", window=500), {}),
    "events_rollover": ("plain", dict(mode="events", window=1400), {}),
    "gtflow": ("gt", dict(mode="gtflow", window=1), {}),
    "gtflow_fractional": ("gt", dict(mode="gtflow", window=0.5), {}),
    "gtflow_ts_jump": ("gap", dict(mode="gtflow", window=1), {}),
    "augment_every_flip_and_playback": (
        "plain", dict(mode="events", window=400,
                      augment=["Horizontal", "Vertical", "Polarity",
                               "Playback"],
                      augment_prob=[1.0, 1.0, 1.0, 1.0]), {}),
    "augment_rerolled_two_lanes": (
        "four", dict(mode="time", window=0.3, batch_size=2,
                     augment=["Horizontal", "Vertical", "Polarity",
                              "Playback"],
                     augment_prob=[0.5, 0.5, 0.5, 0.5]),
        dict(shuffle=True)),
    "playback_time_mode": ("plain", dict(mode="time", window=0.2,
                                         augment=["Playback"],
                                         augment_prob=[1.0]), {}),
    "gtflow_flipped": ("gt", dict(mode="gtflow", window=1,
                                  augment=["Horizontal", "Vertical"],
                                  augment_prob=[1.0, 1.0]), {}),
    "max_num_grad_events": ("plain", dict(mode="events", window=800,
                                          max_grad=100), {}),
    "n_events_pad_truncates": ("plain", dict(mode="events", window=500,
                                             n_events_pad=128), {}),
    "n_events_pad_fixed": ("plain", dict(mode="events", window=500,
                                         n_events_pad=1024), {}),
    "voxel": ("plain", dict(mode="events", window=700, voxel=5), {}),
    "file_shard": ("four", dict(mode="events", window=400),
                   dict(shuffle=True, file_shard=(1, 2))),
    "lane_offset": ("four", dict(mode="events", window=400, batch_size=2),
                    dict(lane_offset=1)),
    "rectified_flipped": ("rect", dict(mode="time", window=0.2,
                                       batch_size=2,
                                       augment=["Horizontal", "Vertical",
                                                "Polarity"],
                                       augment_prob=[0.5, 0.5, 0.5]),
                          dict(shuffle=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_matches_jax(datasets, monkeypatch, case):
    name, cfg_kw, loader_kw = CASES[case]
    monkeypatch.setattr(jbase, "cv2", None)  # the port's numpy remap
    cfg = make_config(datasets[name], **cfg_kw)
    ours, ref, batches = drive_both(lambda: H5Loader(cfg, **loader_kw),
                                    lambda: JaxLoader(cfg, **loader_kw))
    seen = {k for b in batches for k in b if b[k].any()}
    if case == "events_rollover":
        assert "new_seq" in seen and ours.seq_num >= 2
    if case == "gtflow_ts_jump":
        assert "ts_jump_reset" in seen
    if case == "n_events_pad_truncates":
        assert ours.truncated_events > 0
        assert batches[0]["event_list"].shape[1] == 128
    if case == "max_num_grad_events":
        assert int(batches[0]["grad_mask"].sum()) == 100
    if case == "voxel":
        assert batches[0]["net_input"].shape[-1] == 5
    if case.startswith("rectified"):
        assert ours.rectify and "event_raw_xy" in batches[0]
        np.testing.assert_array_equal(ours.remap_indices(),
                                      ref.remap_indices())
    ours.close()


def test_cache_round_trip_matches_jax(datasets, tmp_path):
    """The port's cache writes, reads back and is read by the JAX loader:
    every pass equal to the JAX loader's uncached batches."""
    cfg = make_config(datasets["plain"], mode="events", window=600)
    cached = dict(cfg, data=dict(cfg["data"], cache=True))
    path_cache = str(tmp_path / "cache")
    n = 8
    ref = JaxLoader(cfg)
    ref_batches = [ref.next_batch() for _ in range(n)]
    for make in (lambda: H5Loader(cached, path_cache=path_cache),  # writes
                 lambda: H5Loader(cached, path_cache=path_cache),  # reads
                 lambda: JaxLoader(cached, path_cache=path_cache)):
        loader = make()
        for i, rb in enumerate(ref_batches):
            assert_batches_equal(loader.next_batch(), rb, f"cached {i}")
    assert os.path.isfile(os.path.join(path_cache, "cache_train", "seq0.h5"))


def test_in_memory_loader_matches_files(tmp_path):
    """``chip_smoke.memory_loader``: the port's ``H5Loader`` with only its
    list and open methods overridden, serving ``synthetic_sequence`` arrays
    from memory, gives the batches of the same sequences' ``.h5`` files."""
    import chip_smoke

    d = str(tmp_path / "mem")
    kw = [dict(n_events=3000, res=RES, seed=1), dict(n_events=2000, res=RES,
                                                     seed=2)]
    paths = [os.path.join(d, f"seq{i}.h5") for i in range(2)]
    for p, k in zip(paths, kw):
        tdata.write_synthetic_h5(p, **k)
    seqs = {p: tdata.synthetic_sequence(**k) for p, k in zip(paths, kw)}
    cfg = make_config(d, mode="time", window=0.2, augment=["Playback",
                                                           "Horizontal"],
                      augment_prob=[0.5, 0.5], max_grad=50)
    mem = chip_smoke.memory_loader(seqs)
    drive_both(lambda: mem(cfg, shuffle=True),
               lambda: H5Loader(cfg, shuffle=True))


# ------------------------------------------------------------ writer, helpers


@pytest.mark.parametrize("kw", [
    dict(n_events=1500, seed=3),
    dict(n_events=1500, seed=4, n_flow_frames=5),
    dict(n_events=1500, seed=5, n_flow_frames=5, gt_gap_after=0.5),
    dict(n_events=1500, seed=6, rectify=True, duration=1.0, t_start=3.0),
], ids=["plain", "flow", "gap", "rectify"])
def test_write_synthetic_h5_matches_jax(tmp_path, kw):
    ours = tdata.write_synthetic_h5(str(tmp_path / "a" / "s.h5"), res=RES, **kw)
    ref = jax_write(str(tmp_path / "b" / "s.h5"), res=RES, **kw)

    def contents(path):
        out = {}
        with h5py.File(path, "r") as f:
            out["/"] = dict(f.attrs)

            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    out[name] = (obj[()], obj.dtype, dict(obj.attrs))

            f.visititems(visit)
        return out

    a, b = contents(ours), contents(ref)
    assert sorted(a) == sorted(b)
    assert a["/"] == b["/"]
    for name in b:
        if name == "/":
            continue
        (va, ta, aa), (vb, tb, ab) = a[name], b[name]
        assert ta == tb and aa == ab, name
        np.testing.assert_array_equal(va, vb, err_msg=name)


def test_encodings_and_padding_match_jax(rng):
    xs = rng.integers(0, RES[1], 500).astype(np.float32)
    ys = rng.integers(0, RES[0], 500).astype(np.float32)
    ts = np.sort(rng.uniform(0, 1, 500)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], 500).astype(np.float32)
    for name in ("events_to_image_np", "events_to_channels_np"):
        np.testing.assert_array_equal(getattr(tdata, name)(xs, ys, ps, RES),
                                      getattr(jbase, name)(xs, ys, ps, RES))
    np.testing.assert_array_equal(
        tdata.events_to_voxel_np(xs, ys, ts, ps, 5, RES),
        jbase.events_to_voxel_np(xs, ys, ts, ps, 5, RES))
    for n in (0, 1, 256, 257, 5000, 5_000_000):
        assert tdata.bucket_size(n) == jbase.bucket_size(n)
        assert tdata.bucket_size(n, 300) == jbase.bucket_size(n, 300)
    arr = rng.normal(size=(7, 3)).astype(np.float32)
    for n in (4, 7, 12):
        np.testing.assert_array_equal(tdata.pad_events(arr, n),
                                      jbase.pad_events(arr, n))


def test_find_ts_index_matches_bisect_getter(datasets):
    """The coarse-index timestamp search equals the exact per-element
    bisection for both raw and playback-virtual streams (incl. duplicate
    timestamps and out-of-range probes)."""
    data = H5Loader(make_config(datasets["plain"], window=0.05))
    lane = data.lanes[0]
    ts = np.asarray(lane.file["events/ts"])
    lane.ts_stride = 7  # a tiny stride, so the coarse path brackets
    lane.ts_coarse = ts[::7]

    t0, tk = float(ts[0]), float(ts[-1])
    probes = list(np.linspace(t0 - 0.1, tk + 0.1, 23)) + [
        t0, tk, float(ts[len(ts) // 2])
    ]
    for playback in (False, True):
        lane.playback = playback
        lane.t_min, lane.t_max = t0, tk
        get, n = data._virtual_ts(lane)
        for t in probes:
            assert data.find_ts_index(lane, t) == tdata.bisect_getter(
                get, n, t), (playback, t)
    data.close()


def test_file_shard_requires_seed_and_enough_files(tmp_path):
    d = tmp_path / "ds1"
    d.mkdir()
    tdata.write_synthetic_h5(str(d / "only.h5"), n_events=1200, res=RES,
                             seed=3)
    with pytest.raises(ValueError, match="seed"):
        H5Loader(make_config(str(d), seed=None), shuffle=True,
                 file_shard=(0, 2))
    with pytest.raises(ValueError, match="partitioned"):
        H5Loader(make_config(str(d)), shuffle=True, file_shard=(0, 2))
    with pytest.raises(ValueError, match="gtflow"):
        H5Loader(make_config(str(d), mode="gtflow", window=2))
    with pytest.raises(FileNotFoundError):
        H5Loader(make_config(str(tmp_path / "empty")))


def test_remap_matches_jax_numpy_path(rng, monkeypatch):
    """``BaseStreamLoader.remap`` and ``remap_index`` against the JAX
    loader's numpy path (cv2 patched off there), out-of-source map
    coordinates included."""
    monkeypatch.setattr(jbase, "cv2", None)
    res = (9, 11)
    cfg = {"data": {"voxel": None},
           "loader": {"resolution": list(res), "batch_size": 1, "augment": [],
                      "augment_prob": [], "seed": 0}}
    ours, ref = tdata.BaseStreamLoader(cfg), jbase.BaseStreamLoader(cfg)
    mapping = np.zeros(res + (2,), np.float32)
    mapping[..., 0] = rng.uniform(-1.5, res[1] + 0.5, res)
    mapping[..., 1] = rng.uniform(-1.5, res[0] + 0.5, res)
    img = rng.normal(size=res + (2,)).astype(np.float32)
    np.testing.assert_array_equal(ours.remap(img, mapping),
                                  ref.remap(img, mapping))
    np.testing.assert_array_equal(ours.remap_index(mapping),
                                  ref.remap_index(mapping))
    assert ours.remap(img, None) is img and ours.remap_index(None) is None


# ------------------------------------------------------------ window, prefetch


def _batches(rng, p, b, sizes):
    out = []
    for k in range(p):
        n = sizes[k]
        out.append({
            "net_input": rng.integers(0, 3, (b,) + RES + (2,)).astype(
                np.float32),
            "event_list": rng.normal(size=(b, n, 4)).astype(np.float32),
            "event_list_pol_mask": rng.integers(0, 2, (b, n, 2)).astype(
                np.float32),
            "grad_mask": rng.integers(0, 2, (b, n, 1)).astype(np.float32),
        })
    return out


def test_stack_window_matches_jax(rng):
    batches = _batches(rng, 3, 2, [256, 512, 256])
    ours = twindow.stack_window(batches)
    ref = jwindow.stack_window(batches, packed=False)
    assert_batches_equal(ours, ref, "stack_window")
    assert ours["event_list"].shape == (3, 2, 512, 4)
    # the packed wire, array for array, in each of its forms
    for kw in ({}, {"net_compact": True}, {"derive_net": True}):
        assert_batches_equal(twindow.stack_window(batches, packed=True, **kw),
                             jwindow.stack_window(batches, packed=True, **kw),
                             f"stack_window packed {kw}")
    padded = twindow.pad_batch_events(batches[0], 600)
    assert_batches_equal(padded, jwindow.pad_batch_events(batches[0], 600),
                         "pad_batch_events")


def test_window_grouper_matches_jax(rng):
    """Both groupers fed one random stream of resets and jumps hand out
    the same windows at the same batches."""
    for passes in (1, 2, 3, 5):
        ours, ref = twindow.WindowGrouper(passes), jwindow.WindowGrouper(
            passes)
        for i in range(400):
            new_seq = bool(rng.random() < 0.05)
            ts_jump = bool(rng.random() < 0.08)
            a, b = ours.feed(i, new_seq, ts_jump), ref.feed(i, new_seq,
                                                            ts_jump)
            assert a == b, (passes, i)
            assert (ours.pd, ours.buf) == (ref.pd, ref.buf)


@pytest.mark.parametrize("cls", [Prefetcher, JaxPrefetcher],
                         ids=["port", "jax"])
def test_prefetcher_order_and_exceptions(cls):
    """The prefetcher keeps the order exactly, re-raises a producer error
    at the consumer's ``next()``, and ``close`` releases a producer blocked
    on its full queue."""
    assert list(cls(iter(range(100)), depth=3)) == list(range(100))

    def boom():
        yield 1
        yield 2
        raise RuntimeError("producer died")

    it = iter(cls(boom(), depth=2))
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(RuntimeError, match="producer died"):
        next(it)

    blocked = cls(iter(range(10_000)), depth=2)
    assert next(iter(blocked)) == 0
    blocked.close()
    blocked._thread.join(timeout=5)
    assert not blocked._thread.is_alive()
