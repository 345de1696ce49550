"""Host-side data plumbing of the loader: the port's own copy of
``taming_event_flow_tpu/data/base.py`` (encodings, padding, and the
streaming loader base with its augmentation, sample assembly and collate).

Every batch has static shapes: ragged event windows are zero-padded to a
bucketed length, and padding rows carry zero polarity masks so they vanish
from every splat. One event tensor carries a ``grad_mask`` column in place
of the reference's two ragged grad/detached lists.

Only numpy: the nearest-neighbour :func:`remap` is the numpy path of the
JAX loader and never calls cv2.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Res = Tuple[int, int]  # (H, W)


# ------------------------------------------------------------------ encodings


def _flat_idx(xs, ys, res: Res):
    return ys.astype(np.int64) * res[1] + xs.astype(np.int64)


def _bincount_image(idx, weights, res: Res):
    # weights accumulate in f64: exact for the integer-valued counts
    img = np.bincount(idx, weights=weights, minlength=res[0] * res[1])
    return img.reshape(res).astype(np.float32)


def events_to_image_np(xs, ys, ps, res: Res):
    """``[H, W]`` float32 sum of ``ps`` per pixel."""
    return _bincount_image(_flat_idx(xs, ys, res), ps, res)


def events_to_channels_np(xs, ys, ps, res: Res):
    """``[H, W, 2]`` float32 per-polarity counts: positive events in
    channel 0 with weight ``ps``, negative in channel 1 with weight
    ``-ps``, zeros (padding) contribute nothing. One bincount over a
    polarity-offset index."""
    hw = res[0] * res[1]
    idx = _flat_idx(xs, ys, res)
    idx += hw * (ps < 0)
    img = np.bincount(idx, weights=np.abs(ps), minlength=2 * hw)
    return np.transpose(
        img.reshape(2, res[0], res[1]), (1, 2, 0)
    ).astype(np.float32)


def events_to_voxel_np(xs, ys, ts, ps, num_bins, res: Res):
    """``[H, W, num_bins]`` bilinear-in-time voxel grid (reference
    ``encodings.py:32-56``)."""
    idx = _flat_idx(xs, ys, res)
    tb = ts * (num_bins - 1)
    bins = []
    for b in range(num_bins):
        w = np.maximum(0.0, 1.0 - np.abs(tb - b))
        bins.append(_bincount_image(idx, ps * w, res))
    return np.stack(bins, axis=-1)


# ------------------------------------------------------------ rectification


def rectify_events(rectify_map, xs, ys):
    """Per-event rectified coordinates from the file's forward lookup map
    ``rectify_map[y_raw, x_raw] = (x_rect, y_rect)`` (reference
    ``dataloader/base.py:173-188``). Returns float32 ``(xs, ys)``."""
    rect = rectify_map[ys.astype(np.int64), xs.astype(np.int64)]
    return rect[:, 0].astype(np.float32), rect[:, 1].astype(np.float32)


def remap(img_hwc, mapping, res: Res):
    """Backward-rectify an image-like ``[H, W, ...]`` array by nearest
    lookup: output pixel ``(y, x)`` reads ``img[rint(mapping[y, x, 1]),
    rint(mapping[y, x, 0])]`` (reference ``dataloader/base.py:290-298``).

    This is the numpy path of the JAX loader. It clips a source outside the
    frame to the border, where cv2's ``remap`` fills 0; so a
    :func:`remap_index` built here has no ``0`` entries, and the ``0``
    (out-of-source) entries that a cv2-built index carries are made by
    hand in the tests.
    """
    if mapping is None:
        return img_hwc
    mx = np.clip(np.rint(mapping[..., 0]), 0, res[1] - 1).astype(int)
    my = np.clip(np.rint(mapping[..., 1]), 0, res[0] - 1).astype(int)
    return img_hwc[my, mx]


def remap_index(mapping, res: Res) -> Optional[np.ndarray]:
    """:func:`remap`'s pixel lookup as a gather index: an index image
    remapped through the same path, ``[H, W]`` int32, 1-based (``0``
    marks an out-of-source pixel), or ``None`` without a mapping. A device
    gather with it (``ops.derive_count_input``) is element for element the
    host remap of any image."""
    if mapping is None:
        return None
    h, w = res
    idx_img = np.arange(1, h * w + 1, dtype=np.float32).reshape(h, w)
    return remap(idx_img, mapping, res).astype(np.int32)


# ------------------------------------------------------------------ padding


_BUCKETS = [256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072,
            262144, 524288, 1048576, 2097152, 4194304]


def bucket_size(n: int, fixed: Optional[int] = None) -> int:
    """Static event-axis length: the fixed cap, or the next power-of-two
    bucket (few distinct shapes)."""
    if fixed is not None:
        return fixed
    for b in _BUCKETS:
        if n <= b:
            return b
    return int(2 ** math.ceil(math.log2(max(n, 1))))


def pad_events(arr: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad ``[k, C]`` event rows to ``[n, C]`` (truncates if k > n)."""
    k = arr.shape[0]
    if k >= n:
        return arr[:n]
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    out[:k] = arr
    return out


# ------------------------------------------------------------------ loader


class BaseStreamLoader:
    """Per-lane streaming loader base: augmentation + sample assembly.

    A "lane" is one independent sequential file stream; a batch stacks one
    window from each lane (reference ``dataloader/h5.py:53-55,268-270``).
    """

    def __init__(self, config: Dict):
        self.config = config
        self.epoch = 0
        self.seq_num = 0
        self.samples = 0
        self.rectify = False
        self.res: Res = tuple(config["loader"]["resolution"])
        self.batch_size: int = config["loader"]["batch_size"]
        self.augment: Sequence[str] = config["loader"].get("augment", [])
        self.augment_prob: Sequence[float] = config["loader"].get(
            "augment_prob", []
        )
        self.voxel_bins = config["data"].get("voxel", None)
        self.max_grad_events = config["loader"].get("max_num_grad_events")
        self.fixed_n = config["loader"].get("n_events_pad")
        self.truncated_events = 0
        self.rng = np.random.default_rng(config["loader"].get("seed"))

        # per-lane augmentation flags, re-rolled per sequence
        self.batch_augmentation: Dict[str, List[bool]] = {
            m: [False] * self.batch_size for m in self.augment
        }
        self.roll_augmentation()

    def roll_augmentation(self):
        """Draw every lane's augmentation flags from ``self.rng``."""
        for i, m in enumerate(self.augment):
            for lane in range(self.batch_size):
                self.batch_augmentation[m][lane] = (
                    self.rng.random() < self.augment_prob[i]
                )

    def reroll_augmentation(self, lane: int):
        """Re-roll one lane's augmentation flags on sequence change
        (reference ``dataloader/base.py:45-58``)."""
        self.seq_num += 1
        for i, m in enumerate(self.augment):
            self.batch_augmentation[m][lane] = (
                self.rng.random() < self.augment_prob[i]
            )

    # ------------------------------------------------------------- events

    def format_events(self, xs, ys, ts, ps):
        """float32 arrays; polarity to ±1; ts normalized to [0, 1]
        (reference ``dataloader/base.py:147-171``)."""
        xs = xs.astype(np.float32)
        ys = ys.astype(np.float32)
        ts = ts.astype(np.float32)
        ps = ps.astype(np.float32)
        ps *= 2
        ps -= 1
        if ts.shape[0] > 0:
            t0, denom = ts[0], ts[-1] - ts[0]
            ts -= t0
            ts /= denom if denom != 0 else 1.0
        return xs, ys, ts, ps

    rectify_events = staticmethod(rectify_events)

    def augment_events(self, xs, ys, ps, rec_xs, rec_ys, lane):
        """Horizontal/Vertical/Polarity flips (reference ``base.py:190-224``)."""
        h, w = self.res
        for m in self.augment:
            if m == "Horizontal" and self.batch_augmentation["Horizontal"][lane]:
                xs = w - 1 - xs
                if rec_xs is not None:
                    rec_xs = w - 1 - rec_xs
            elif m == "Vertical" and self.batch_augmentation["Vertical"][lane]:
                ys = h - 1 - ys
                if rec_ys is not None:
                    rec_ys = h - 1 - rec_ys
            elif m == "Polarity" and self.batch_augmentation["Polarity"][lane]:
                ps = -ps
        return xs, ys, ps, rec_xs, rec_ys

    def augment_gt(self, gt: Dict[str, np.ndarray], lane: int):
        """Flip GT maps (HWC); flow components change sign accordingly
        (reference ``base.py:226-249``)."""
        for m in self.augment:
            if m == "Horizontal" and self.batch_augmentation["Horizontal"][lane]:
                for key in gt:
                    if gt[key].ndim < 2:
                        continue
                    gt[key] = np.flip(gt[key], axis=1).copy()
                    if key == "gtflow":
                        gt[key][..., 0] *= -1
            elif m == "Vertical" and self.batch_augmentation["Vertical"][lane]:
                for key in gt:
                    if gt[key].ndim < 2:
                        continue
                    gt[key] = np.flip(gt[key], axis=0).copy()
                    if key == "gtflow":
                        gt[key][..., 1] *= -1
        return gt

    # -------------------------------------------------------- representations

    def remap(self, img_hwc, mapping):
        """:func:`remap` at this loader's resolution."""
        return remap(img_hwc, mapping, self.res)

    def remap_index(self, mapping) -> Optional[np.ndarray]:
        """:func:`remap_index` at this loader's resolution."""
        return remap_index(mapping, self.res)

    def assemble_sample(self, lane, xs, ys, ts, ps, rect_map, rect_mapping,
                        gt: Dict[str, np.ndarray]):
        """One lane window -> output dict (unpadded, HWC numpy), as
        reference ``dataloader/h5.py:349-431`` builds it."""
        xs, ys, ts, ps = self.format_events(xs, ys, ts, ps)

        rec_xs = rec_ys = None
        if rect_map is not None:
            rec_xs, rec_ys = self.rectify_events(rect_map, xs, ys)

        xs, ys, ps, rec_xs, rec_ys = self.augment_events(
            xs, ys, ps, rec_xs, rec_ys, lane
        )

        lx = rec_xs if rec_xs is not None else xs
        ly = rec_ys if rec_ys is not None else ys
        n_ev = ts.shape[0]
        event_list = np.empty((n_ev, 4), np.float32)
        event_list[:, 0] = ts
        event_list[:, 1] = ly
        event_list[:, 2] = lx
        event_list[:, 3] = ps
        pol_mask = np.empty((n_ev, 2), np.float32)
        pol_mask[:, 0] = ps > 0
        pol_mask[:, 1] = ps < 0

        event_cnt = events_to_channels_np(xs, ys, ps, self.res)
        event_cnt = self.remap(event_cnt, rect_mapping)
        event_mask = (
            (event_cnt[..., 0] + event_cnt[..., 1]) > 0
        ).astype(np.float32)[..., None]

        if self.voxel_bins is not None:
            voxel = events_to_voxel_np(xs, ys, ts, ps, self.voxel_bins,
                                       self.res)
            net_input = self.remap(voxel, rect_mapping)
        else:
            net_input = event_cnt  # an alias: collate copies each key

        # grad-event subsample as a mask (reference splits two ragged lists,
        # ``base.py:347-377``)
        grad_mask = np.ones((n_ev, 1), np.float32)
        if self.max_grad_events is not None and n_ev > self.max_grad_events:
            keep = self.rng.choice(n_ev, self.max_grad_events, replace=False)
            grad_mask[:] = 0.0
            grad_mask[keep] = 1.0

        out = {
            "net_input": net_input.astype(np.float32, copy=False),
            "event_cnt": event_cnt.astype(np.float32, copy=False),
            "event_mask": event_mask,
            "event_list": event_list,
            "event_list_pol_mask": pol_mask,
            "grad_mask": grad_mask,
        }
        if rect_map is not None:
            # raw (pre-rectification, post-augmentation) integer coords:
            # with them and remap_index the count input derives on the
            # device (ops/encodings.derive_count_input)
            raw_xy = np.empty((n_ev, 2), np.uint16)
            raw_xy[:, 0] = ys
            raw_xy[:, 1] = xs
            out["event_raw_xy"] = raw_xy
        out.update(gt)
        return out

    # ------------------------------------------------------------- collate

    def collate(self, samples: List[Dict[str, np.ndarray]]):
        """Stack lane samples into a static-shape batch
        (reference ``dataloader/base.py:391-434``). Only the keys every
        lane produced are batched."""
        ragged = {"event_list", "event_list_pol_mask", "grad_mask",
                  "event_raw_xy"}
        keys = set(samples[0])
        for s in samples[1:]:
            keys &= set(s)
        max_n = max(s["event_list"].shape[0] for s in samples)
        n_pad = bucket_size(max_n, self.fixed_n)
        if self.fixed_n is not None and max_n > self.fixed_n:
            self.truncated_events += sum(
                max(0, s["event_list"].shape[0] - self.fixed_n)
                for s in samples
            )
            warnings.warn(
                f"event window of {max_n} exceeds n_events_pad="
                f"{self.fixed_n}; truncating "
                f"({self.truncated_events} events dropped so far)",
                stacklevel=2,
            )
        batch = {}
        for key in (k for k in samples[0] if k in keys):
            if key in ragged:
                first = samples[0][key]
                out = np.zeros(
                    (len(samples), n_pad) + first.shape[1:], first.dtype
                )
                for i, s in enumerate(samples):
                    v = s[key][:n_pad]
                    out[i, : v.shape[0]] = v
                batch[key] = out
            elif len(samples) == 1:
                batch[key] = samples[0][key][None]
            else:
                batch[key] = np.stack([s[key] for s in samples])
        return batch
