"""Synthetic event sequences with the reference's H5 schema (see
``data/h5.py``): the port's own copy of
``taming_event_flow_tpu/data/synthetic.py``.

:func:`synthetic_sequence` draws the arrays; :func:`write_synthetic_h5`
writes them to a file. For one seed both give the JAX package's
``write_synthetic_h5`` datasets, value for value.
"""

from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np


class SyntheticSequence(NamedTuple):
    """One sequence as its H5 file holds it: ``datasets`` by path
    (``events/xs``, ``flow/000000``, ...), the file's ``attrs``, and the
    attrs of each dataset that has some (``dataset_attrs[path]``)."""

    datasets: Dict[str, Any]
    attrs: Dict[str, float]
    dataset_attrs: Dict[str, Dict[str, float]]


def synthetic_sequence(
    n_events: int = 4000,
    res: Tuple[int, int] = (32, 40),
    duration: float = 2.0,
    t_start: float = 100.0,
    n_flow_frames: int = 0,
    seed: int = 0,
    flow_magnitude: float = 2.0,
    gt_gap_after: Optional[float] = None,
    rectify: bool = False,
) -> SyntheticSequence:
    """Draw one synthetic event sequence.

    :param n_flow_frames: if > 0, adds ``flow/<i>`` GT maps with
        ``timestamp_from/to`` attrs evenly tiling the duration.
    :param gt_gap_after: if set, inserts a temporal gap in the events after
        this fraction of the duration (exercises ``ts_jump`` detection).
    :param rectify: if True, adds a DSEC-style ``rectification/rectify_map``
        + ``calibration/*`` (stringified dicts) for a mildly distorted
        camera. Requires cv2.
    """
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, duration, n_events)) + t_start
    if gt_gap_after is not None:
        gap_t = t_start + duration * gt_gap_after
        ts = np.where(ts > gap_t, ts + duration, ts)
    ds: Dict[str, Any] = {
        "events/xs": rng.integers(0, res[1], n_events).astype(np.uint16),
        "events/ys": rng.integers(0, res[0], n_events).astype(np.uint16),
        "events/ts": ts.astype(np.float64),
        "events/ps": rng.integers(0, 2, n_events).astype(np.uint8),
    }
    attrs = {"t0": ts[0], "tk": ts[-1], "duration": float(ts[-1] - ts[0])}
    ds_attrs: Dict[str, Dict[str, float]] = {}

    if rectify:
        import cv2

        h, w = res
        fx = fy = float(max(h, w))
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        dist = [0.05, -0.02, 0.001, 0.001]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        # forward per-event map: undistort every integer pixel
        grid = np.stack(
            np.meshgrid(np.arange(w, dtype=np.float64),
                        np.arange(h, dtype=np.float64)),
            axis=-1,
        ).reshape(-1, 1, 2)
        rect = cv2.undistortPoints(
            grid, K, np.array(dist), R=np.eye(3), P=K
        ).reshape(h, w, 2)
        ds["rectification/rectify_map"] = rect.astype(np.float32)
        cam = {"camera_matrix": [fx, fy, cx, cy], "distortion_coeffs": dist}
        ds["calibration/intrinsics"] = str({"cam0": cam, "camRect0": cam})
        ds["calibration/extrinsics"] = str({"R_rect0": np.eye(3).tolist()})
        ds["calibration/disparity_to_depth"] = str(
            {"cams_03": np.eye(4).tolist()})

    if n_flow_frames > 0:
        if gt_gap_after is None:
            edges = np.linspace(ts[0], ts[-1], n_flow_frames + 1)
        else:
            # GT frames follow the data across a recording discontinuity:
            # the gap shows as a timestamp jump between consecutive frames
            edges = np.quantile(ts, np.linspace(0, 1, n_flow_frames + 1))
        for i in range(n_flow_frames):
            name = f"flow/{i:06d}"
            ds[name] = rng.normal(size=(res[0], res[1], 2)).astype(
                np.float32) * flow_magnitude
            ds_attrs[name] = {"timestamp_from": edges[i],
                              "timestamp_to": edges[i + 1]}
    return SyntheticSequence(ds, attrs, ds_attrs)


def write_synthetic_h5(path: str, **kwargs) -> str:
    """Write :func:`synthetic_sequence` ``(**kwargs)`` to ``path``."""
    import h5py

    seq = synthetic_sequence(**kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for name, data in seq.datasets.items():
            d = f.create_dataset(name, data=data)
            for key, val in seq.dataset_attrs.get(name, {}).items():
                d.attrs[key] = val
        for key, val in seq.attrs.items():
            f.attrs[key] = val
    return path
