"""Streaming HDF5 event loader: the port's own copy of
``taming_event_flow_tpu/data/h5.py``.

B independent sequential lanes stream event windows from ``*.h5`` files in
one of three modes:

  * ``events``: fixed event-count windows,
  * ``time``:   fixed seconds windows (binary-searched timestamp index),
  * ``gtflow``: ground-truth-frame-aligned windows (fractional windows
    linearly rescale event indices).

``new_seq`` and ``ts_jump_reset`` are per lane; the ``Playback``
(time-reversal) augmentation reverses reads virtually; calibration strings
are parsed with ``ast.literal_eval``.

h5py is touched in one place, :meth:`H5Loader.open_file`, and the file list
comes from :meth:`H5Loader.list_files`: a subclass that overrides the two
can serve the same arrays from elsewhere. cv2 is imported only where a
rectified file's backward map is built (:meth:`H5Loader.
_rectification_mapping`), and raises there without it.

H5 schema (the reference's): ``events/{xs,ys,ts,ps}``; attrs ``t0``,
``tk``, ``duration``; optional ``rectification/rectify_map``; optional
``flow/<name>`` maps with ``timestamp_from/to`` attrs; optional
``calibration/{intrinsics,extrinsics,disparity_to_depth}``.
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .base import BaseStreamLoader
from .cache import CacheDataset


def bisect_getter(get, length: int, value) -> int:
    """Insertion-point binary search over an indexable getter."""
    lo, hi = 0, length
    while lo < hi:
        mid = (lo + hi) // 2
        if get(mid) < value:
            lo = mid + 1
        else:
            hi = mid
    return lo


class FlowMapsIndex:
    """Index of the GT flow maps in a file (reference ``h5.py:20-34``)."""

    def __init__(self, h5file):
        self.names: List[str] = []
        self.ts_from: List[float] = []
        self.ts_to: List[float] = []
        if "flow" in h5file:
            def visit(name, obj):
                if hasattr(obj, "dtype") and name not in self.names:
                    self.names.append(name)
                    self.ts_from.append(obj.attrs["timestamp_from"])
                    self.ts_to.append(obj.attrs["timestamp_to"])

            h5file["flow"].visititems(visit)


class _Lane:
    """Per-lane stream state."""

    def __init__(self):
        self.file: Any = None
        self.path: str = ""
        self.row: float = 0.0
        self.file_idx: int = 0
        self.pass_idx: int = 0
        self.playback: bool = False
        self.rectify_map = None
        self.rect_mapping = None
        self.remap_idx = None
        self.K_rect = None
        self.inv_K_rect = None
        self.Q_rect = None
        self.flowmaps: Optional[FlowMapsIndex] = None
        self.flow_group = None
        self.new_seq: bool = False
        self.ts_jump_reset: bool = False
        self.gt_avg_dt: Optional[float] = None
        self.gt_avg_idx: int = 0
        self.last_proc_timestamp: float = 0.0
        # playback ts endpoints
        self.t_min: float = 0.0
        self.t_max: float = 0.0
        # coarse in-memory ts index (built lazily per file)
        self.ts_coarse: Optional[np.ndarray] = None
        self.ts_stride: int = 1
        self.ds: Dict = {}
        self.attrs: Dict = {}


class H5Loader(BaseStreamLoader):
    def __init__(self, config: Dict, shuffle: bool = False,
                 path_cache: str = "", lane_offset: int = 0,
                 file_shard: Optional[Tuple[int, int]] = None):
        """``lane_offset`` maps this loader's lanes onto global lane ids
        ``[offset, offset + batch_size)``. ``file_shard=(shard_idx,
        n_shards)`` partitions the file list round-robin after the seeded
        permutation (identical for every shard, so the shards are disjoint
        and cover the dataset); rollover and the epoch boundary then stay
        inside the shard, and the augmentation rng is re-derived from
        ``(seed, shard_idx)``."""
        super().__init__(config)
        self.lane_offset = lane_offset
        self.mode = config["data"]["mode"]
        self.window = config["data"]["window"]
        if self.mode == "gtflow" and self.window > 1:
            raise ValueError("gtflow mode cannot be used with window > 1")

        self.files: List[str] = self.list_files(config["data"]["path"])
        if not self.files:
            raise FileNotFoundError(
                f"no .h5 files under {config['data']['path']}"
            )
        if shuffle:
            perm = self.rng.permutation(len(self.files))
            self.files = [self.files[i] for i in perm]
        if file_shard is not None:
            shard, n_shards = file_shard
            if config["loader"].get("seed") is None:
                raise ValueError(
                    "file_shard needs loader.seed: the (identical) seeded "
                    "file permutation is what makes the shards disjoint"
                )
            if len(self.files) < n_shards:
                raise ValueError(
                    f"{len(self.files)} h5 files cannot be partitioned "
                    f"across {n_shards} shards (need >= 1 file per shard)"
                )
            self.files = self.files[shard::n_shards]
            # decorrelate augmentation draws across shards; not
            # reroll_augmentation, which would advance seq_num
            self.rng = np.random.default_rng(
                (config["loader"].get("seed"), shard)
            )
            self.roll_augmentation()

        self.cache = None
        if config["data"].get("cache"):
            self.cache = CacheDataset(config, path_cache)

        self.lanes = [_Lane() for _ in range(self.batch_size)]
        for i, lane in enumerate(self.lanes):
            lane.file_idx = i if file_shard is not None else lane_offset + i
            self._open(lane)

    # ----------------------------------------------------------- file mgmt

    def list_files(self, root: str) -> List[str]:
        """The ``.h5`` files under ``root``, walked in sorted order."""
        files = []
        for d, _, names in os.walk(root):
            for f in sorted(names):
                if f.endswith(".h5"):
                    files.append(os.path.join(d, f))
        return files

    def open_file(self, path: str):
        """Open one sequence for reading: an ``h5py.File``."""
        import h5py

        return h5py.File(path, "r")

    def _open(self, lane: _Lane):
        lane.ts_jump_reset = False
        lane.gt_avg_dt = None
        lane.gt_avg_idx = 0
        lane.last_proc_timestamp = 0.0
        lane.path = self.files[lane.file_idx % len(self.files)]
        lane.file = self.open_file(lane.path)
        lane.ts_coarse = None  # rebuilt lazily for the new file
        # dataset handles and scalar attrs, looked up once per file
        lane.ds = {k: lane.file["events/" + k] for k in ("xs", "ys", "ts", "ps")}
        lane.attrs = dict(lane.file.attrs)

        lane.playback = bool(
            self.batch_augmentation["Playback"][self.lanes.index(lane)]
        ) if "Playback" in self.batch_augmentation else False
        if lane.playback:
            ts = lane.file["events/ts"]
            lane.t_min = float(ts[0])
            lane.t_max = float(ts[-1])

        if "rectification" in lane.file:
            self.rectify = True
            lane.rectify_map = lane.file["rectification/rectify_map"][:]
            K_rect, mapping, Q_rect = self._rectification_mapping(lane)
            lane.K_rect, lane.rect_mapping, lane.Q_rect = K_rect, mapping, Q_rect
            lane.remap_idx = self.remap_index(mapping)
        else:
            lane.rectify_map = None
            lane.rect_mapping = None
            lane.remap_idx = None

        lane.flowmaps = (
            FlowMapsIndex(lane.file) if self.mode == "gtflow" else None
        )
        lane.flow_group = lane.file.get("flow")

    @staticmethod
    def _calibration(lane: _Lane, key: str):
        raw = lane.file["calibration/" + key][()]
        return ast.literal_eval(raw.decode() if isinstance(raw, bytes)
                                else raw)

    def _rectification_mapping(self, lane: _Lane):
        """Backward rectification map + intrinsics from in-file calibration
        (reference ``dataloader/base.py:60-127``; safe parsing)."""
        intr = self._calibration(lane, "intrinsics")
        extr = self._calibration(lane, "extrinsics")
        d2d = self._calibration(lane, "disparity_to_depth")

        k = intr["cam0"]["camera_matrix"]
        kr = intr["camRect0"]["camera_matrix"]
        K_dist = np.array([[k[0], 0, k[2]], [0, k[1], k[3]], [0, 0, 1]])
        K_rect = np.array([[kr[0], 0, kr[2]], [0, kr[1], kr[3]], [0, 0, 1]])
        R_rect = np.array(extr["R_rect0"])
        dist = np.array(intr["cam0"]["distortion_coeffs"][:4])

        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(
                "cv2 required for DSEC rectification maps") from e
        mapping = cv2.initUndistortRectifyMap(
            K_dist, dist, R_rect, K_rect, (self.res[1], self.res[0]),
            cv2.CV_32FC2,
        )[0]
        Q_rect = np.array(d2d["cams_03"], np.float32)

        lane_idx = self.lanes.index(lane) if lane in self.lanes else 0
        for m in self.augment:
            if m == "Horizontal" and self.batch_augmentation["Horizontal"][lane_idx]:
                K_rect[0, 2] = self.res[1] - 1 - K_rect[0, 2]
                mapping[:, :, 0] = self.res[1] - 1 - mapping[:, :, 0]
                mapping = np.flip(mapping, axis=1)
                Q_rect[0, 3] = -K_rect[0, 2]
            elif m == "Vertical" and self.batch_augmentation["Vertical"][lane_idx]:
                K_rect[1, 2] = self.res[0] - 1 - K_rect[1, 2]
                mapping[:, :, 1] = self.res[0] - 1 - mapping[:, :, 1]
                mapping = np.flip(mapping, axis=0)
                Q_rect[1, 3] = -K_rect[1, 2]

        # 4x4 homogeneous intrinsics (reference ``base.py:129-145``)
        K4h = np.concatenate([K_rect, np.zeros((3, 1))], axis=1)
        K4h = np.concatenate([K4h, np.array([[0, 0, 0, 1.0]])], axis=0)
        lane.inv_K_rect = np.linalg.pinv(K4h).astype(np.float32)
        return K4h.astype(np.float32), np.ascontiguousarray(mapping), Q_rect

    def remap_indices(self) -> Optional[np.ndarray]:
        """Current per-lane backward-rectification gather indices, stacked
        ``[B, H, W]`` int32 (1-based; 0 = out-of-source, see
        ``base.remap_index``), or ``None`` when no lane is rectified.
        Non-rectified lanes in a mixed batch get the identity index. Valid
        for the batches produced since the last lane rollover."""
        if all(lane.remap_idx is None for lane in self.lanes):
            return None
        h, w = self.res
        identity = np.arange(1, h * w + 1, dtype=np.int32).reshape(h, w)
        return np.stack([
            lane.remap_idx if lane.remap_idx is not None else identity
            for lane in self.lanes
        ])

    def rectify_values(self) -> Optional[np.ndarray]:
        """Current per-lane forward rectification maps, stacked ``[B, H,
        W, 2]`` float32 in the file's layout ``map[y_raw, x_raw] = (x_rect,
        y_rect)``: the table of the u32 event wire's lookup
        (``ops.unpack_event_wire``), the one the host's
        ``base.rectify_events`` reads. ``None`` when any lane has no map.
        Valid since the last lane rollover, like :meth:`remap_indices`.
        Coordinate flips transform the looked-up values after this table,
        so a producer must not use it under Horizontal/Vertical flips."""
        if any(lane.rectify_map is None for lane in self.lanes):
            return None
        return np.stack([lane.rectify_map.astype(np.float32)
                         for lane in self.lanes])

    # -------------------------------------------------------- event access

    def _num_events(self, lane):
        return lane.ds["xs"].shape[0]

    def _virtual_ts(self, lane):
        """Timestamp getter honoring the virtual Playback reversal."""
        ts = lane.ds["ts"]
        n = ts.shape[0]
        if not lane.playback:
            return (lambda i: ts[i]), n
        off = lane.t_max + lane.t_min
        return (lambda i: off - ts[n - 1 - i]), n

    def _ts_coarse(self, lane: _Lane):
        """Coarse in-memory timestamp index: every K-th raw ts (sequences
        up to 2M events load fully; larger ones keep <= ~64k points and
        read one slice per probe)."""
        if lane.ts_coarse is None:
            ts = lane.ds["ts"]
            n = ts.shape[0]
            lane.ts_stride = 1 if n <= 2_000_000 else max(1, n // 65536)
            lane.ts_coarse = np.asarray(ts[:: lane.ts_stride])
        return lane.ts_coarse, lane.ts_stride

    def _bisect_raw(self, lane: _Lane, value, side: str) -> int:
        """searchsorted over the raw on-disk ts via coarse index + slice."""
        n = self._num_events(lane)
        if n == 0:
            return 0
        coarse, k = self._ts_coarse(lane)
        j = int(np.searchsorted(coarse, value, side=side))
        if k == 1:
            return j
        lo = max(0, (j - 1) * k)
        hi = min(n, j * k + 1)
        seg = np.asarray(lane.ds["ts"][lo:hi])
        return lo + int(np.searchsorted(seg, value, side=side))

    def find_ts_index(self, lane: _Lane, timestamp: float) -> int:
        """Leftmost insertion point of ``timestamp`` in the (virtual) ts
        stream: ``bisect_getter`` over ``_virtual_ts``, through the coarse
        index."""
        n = self._num_events(lane)
        if not lane.playback:
            return self._bisect_raw(lane, timestamp, "left")
        # virtual stream: get(i) = off - ts[n-1-i] (increasing in i).
        # bisect_left == smallest i with get(i) >= t; with r = rightmost raw
        # index where ts[r] <= off - t this is n-1-r (n if none qualify).
        off = lane.t_max + lane.t_min
        r = self._bisect_raw(lane, off - timestamp, "right") - 1
        return n - 1 - r

    def _read_events(self, lane: _Lane, idx0: int, idx1: int):
        """Read a window, honoring virtual playback reversal."""
        ds = lane.ds
        n = self._num_events(lane)
        idx0 = max(0, min(idx0, n))
        idx1 = max(idx0, min(idx1, n))
        if not lane.playback:
            xs = ds["xs"][idx0:idx1]
            ys = ds["ys"][idx0:idx1]
            ts = ds["ts"][idx0:idx1]
            ps = ds["ps"][idx0:idx1]
        else:
            a, b = n - idx1, n - idx0
            xs = ds["xs"][a:b][::-1]
            ys = ds["ys"][a:b][::-1]
            ps = ds["ps"][a:b][::-1]
            ts = (lane.t_max + lane.t_min) - ds["ts"][a:b][::-1]
        # a fresh float64 array: get_events shifts it in place
        return xs, ys, np.array(ts, np.float64), ps

    def get_events(self, lane: _Lane, idx0: int, idx1: int):
        """Window read + t0 shift + gt temporal-discontinuity detection
        (reference ``h5.py:127-162``)."""
        xs, ys, ts, ps = self._read_events(lane, idx0, idx1)
        ts -= lane.attrs["t0"]

        ts_jump = False
        if self.mode == "gtflow" and ts.shape[0] > 0:
            dt = ts[-1] - lane.last_proc_timestamp
            if lane.gt_avg_dt is None:
                lane.gt_avg_dt = dt
                lane.gt_avg_idx = 1
            elif dt >= 2 * lane.gt_avg_dt / lane.gt_avg_idx:
                ts_jump = True
                lane.ts_jump_reset = True
            else:
                lane.gt_avg_dt += dt
                lane.gt_avg_idx += 1

        if ts.shape[0] > 0:
            lane.last_proc_timestamp = float(ts[-1])
        return xs, ys, ts, ps, ts_jump

    def get_iters(self, lane: _Lane) -> int:
        """Number of forward passes in this lane's sequence
        (reference ``h5.py:108-125``)."""
        if self.mode == "events":
            total = self._num_events(lane)
        elif self.mode == "time":
            total = lane.attrs["duration"]
        elif self.mode == "gtflow":
            total = len(lane.flowmaps.ts_to) - 1
        else:
            raise ValueError(f"unknown mode {self.mode}")
        return int(total // self.window)

    def _gt_index(self, lane: _Lane) -> int:
        idx = int(np.ceil(lane.row + self.window))
        if np.isclose(lane.row + self.window, idx - 1):
            idx -= 1
        return idx

    def _event_index_range(self, lane: _Lane):
        """Window -> (idx0, idx1, restart) (reference ``h5.py:164-201``)."""
        restart = False
        if self.mode == "events":
            idx0 = int(lane.row)
            idx1 = int(lane.row) + int(self.window)
        elif self.mode == "time":
            t0 = lane.attrs["t0"]
            idx0 = self.find_ts_index(lane, lane.row + t0)
            idx1 = self.find_ts_index(lane, lane.row + t0 + self.window)
        elif self.mode == "gtflow":
            idx = self._gt_index(lane)
            idx0 = self.find_ts_index(lane, lane.flowmaps.ts_from[idx])
            idx1 = self.find_ts_index(lane, lane.flowmaps.ts_to[idx])
            if lane.flowmaps.ts_to[idx] > lane.attrs["tk"]:
                restart = True
            if self.window < 1.0:
                floor_row = int(np.floor(lane.row))
                if np.isclose(lane.row, floor_row + 1):
                    floor_row += 1
                idx0_change = lane.row - floor_row
                idx1_change = lane.row + self.window - floor_row
                delta = idx1 - idx0
                idx1 = int(idx0 + idx1_change * delta)
                idx0 = int(idx0 + idx0_change * delta)
        else:
            raise ValueError(f"unknown mode {self.mode}")
        return idx0, idx1, restart

    def _restart_lane(self, lane_idx: int):
        """Sequence rollover (reference ``h5.py:331-339``)."""
        lane = self.lanes[lane_idx]
        lane.new_seq = True
        self.reroll_augmentation(lane_idx)
        lane.row = 0.0
        lane.pass_idx = 0
        lane.file_idx = max(l.file_idx for l in self.lanes) + 1
        lane.file.close()
        self._open(lane)

    def _load_gt(self, lane: _Lane) -> Dict[str, np.ndarray]:
        gt: Dict[str, np.ndarray] = {}
        if self.mode == "gtflow":
            idx = self._gt_index(lane)
            fm = lane.flow_group[lane.flowmaps.names[idx]][:]
            gt["gtflow"] = fm.astype(np.float32, copy=False)  # [H, W, 2]
            gt["gtflow_dt"] = np.float32(
                lane.flowmaps.ts_to[idx] - lane.flowmaps.ts_from[idx]
            )
        return gt

    # ------------------------------------------------------------ iteration

    def lane_sample(self, lane_idx: int) -> Dict[str, np.ndarray]:
        """Produce the next window for one lane
        (reference ``h5.py:268-431`` main loop)."""
        lane = self.lanes[lane_idx]
        while True:
            if self.cache is not None:
                out, ok = self.cache.load(lane.path, lane.pass_idx)
                if ok:
                    lane.row += self.window
                    lane.pass_idx += 1
                    return out

            restart = False
            if self.mode == "gtflow":
                if int(np.ceil(lane.row + self.window)) >= len(
                    lane.flowmaps.ts_to
                ):
                    restart = True

            xs = ys = ts = ps = np.zeros((0,))
            ts_jump = False
            if not restart:
                idx0, idx1, restart = self._event_index_range(lane)
                if not restart:
                    xs, ys, ts, ps, ts_jump = self.get_events(lane, idx0, idx1)

            if self.mode == "gtflow" and ts_jump:
                lane.row += self.window
                lane.pass_idx += 1
                continue

            if (self.mode == "events" and xs.shape[0] < self.window) or (
                self.mode == "time"
                and lane.row + self.window >= lane.attrs["duration"]
            ):
                restart = True

            if restart:
                self._restart_lane(lane_idx)
                continue

            if xs.shape[0] <= 10:
                xs = ys = ts = ps = np.empty((0,))

            gt = self._load_gt(lane)
            gt = self.augment_gt(gt, lane_idx)

            out = self.assemble_sample(
                lane_idx, xs, ys, ts, ps, lane.rectify_map,
                lane.rect_mapping, gt,
            )
            if lane.K_rect is not None:  # per lane: a mixed batch emits
                # no None rows
                out["K_rect"] = lane.K_rect
                out["inv_K_rect"] = lane.inv_K_rect

            lane.row += self.window
            lane.pass_idx += 1

            if self.cache is not None:
                self.cache.update(lane.path, out)
            return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        """One collated batch: a window from every lane, padded static."""
        samples = [self.lane_sample(i) for i in range(self.batch_size)]
        batch = self.collate(samples)
        batch["new_seq"] = np.array(
            [lane.new_seq for lane in self.lanes], bool
        )
        batch["ts_jump_reset"] = np.array(
            [lane.ts_jump_reset for lane in self.lanes], bool
        )
        for lane in self.lanes:
            lane.new_seq = False
        self.samples += self.batch_size
        return batch

    def clear_ts_jump(self):
        for lane in self.lanes:
            lane.ts_jump_reset = False

    def close(self):
        """Close every lane's open file."""
        for lane in self.lanes:
            if lane.file is not None:
                lane.file.close()
                lane.file = None

    def __iter__(self):
        while True:
            yield self.next_batch()

    @property
    def new_seq(self) -> bool:
        return any(lane.new_seq for lane in self.lanes)

    @property
    def last_proc_timestamp(self) -> float:
        return self.lanes[0].last_proc_timestamp

    @property
    def seq_name(self) -> str:
        return os.path.basename(self.lanes[0].path).rsplit(".", 1)[0]
