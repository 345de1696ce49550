"""Rendering and storage of the eval pipeline's imagery: the port's own copy
of ``taming_event_flow_tpu/utils/visualization.py``.

Percentile-normalised event images, the HSV flow colour wheel, the Viridis
AEE error map, and the DSEC 16-bit PNG flow encoding
``uint16(flow * 128 + 2**15)``, stored three-channel and channel-flipped
(reference ``visualization.py:146-149``). Inputs are NHWC numpy arrays or
torch tensors (batch 1); a tensor on the card goes to the host where it is
rendered, on the writeback thread for a store-only protocol.

The HSV conversion is numpy's own (no matplotlib), in the arithmetic of
``matplotlib.colors.hsv_to_rgb``, so the PNGs are the same on every
machine. cv2 is imported only where a PNG is written, the error map
coloured or a window shown; a storing protocol without it raises.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

# ------------------------------------------------------------- DSEC encoding


def encode_dsec_flow(flow_xy: np.ndarray) -> np.ndarray:
    """[H, W, 2] float flow (x, y) -> DSEC benchmark uint16 PNG pixels.

    ``uint16(flow * 128 + 2**15)``, zero third channel, channels reversed so
    that ``cv2.imwrite``'s BGR order puts the x component where the DSEC
    tooling expects it (reference ``visualization.py:146-149``).
    """
    enc = flow_xy * 128.0 + 2**15
    enc = enc.astype(np.uint16)
    enc = np.pad(enc, ((0, 0), (0, 0), (0, 1)), constant_values=0)
    return np.flip(enc, axis=-1)


def decode_dsec_flow(png_pixels: np.ndarray) -> np.ndarray:
    """Inverse of :func:`encode_dsec_flow`."""
    enc = np.flip(png_pixels, axis=-1)[:, :, :2].astype(np.float32)
    return (enc - 2**15) / 128.0


def flow_to_u16(flow):
    """Quantize a flow map to the DSEC 16-bit PNG lattice on the device:
    ``uint16(flow * 128 + 2**15)``, clamped to the lattice. Halves the
    bytes of the ``flow_bw`` readback; the PNG store re-encodes
    :func:`u16_to_flow`'s output to these exact values."""
    return torch.clamp(flow * 128.0 + 2.0**15, 0.0, 65535.0).to(torch.uint16)


def u16_to_flow(enc: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`flow_to_u16` (exact on the lattice)."""
    return (enc.astype(np.float32) - 2.0**15) / 128.0


def _host(val) -> np.ndarray:
    """A slot's value as a numpy array (a tensor on the card is copied to
    the host here)."""
    if torch.is_tensor(val):
        return val.detach().cpu().numpy()
    return np.asarray(val)


# ------------------------------------------------------------- color maps


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``[..., 3]`` HSV in [0, 1] -> RGB in the arithmetic of
    ``matplotlib.colors.hsv_to_rgb``: sector ``i = int(6h)`` (6 is sector
    0), ``f = 6h - i`` before the wrap, each channel selected from
    ``v, p, q, t`` cast back to the input's dtype."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = (v * (1.0 - s)).astype(hsv.dtype)
    q = (v * (1.0 - s * f)).astype(hsv.dtype)
    t = (v * (1.0 - s * (1.0 - f))).astype(hsv.dtype)
    sector = [i % 6 == 0, i == 1, i == 2, i == 3, i == 4, i == 5]
    grey = s == 0
    rgb = [np.where(grey, v, np.select(sector, choices))
           for choices in ([v, q, p, p, t, v], [t, v, v, q, p, p],
                           [p, p, t, v, v, q])]
    return np.stack(rgb, axis=-1).astype(hsv.dtype)


def flow_to_image(flow_xy: np.ndarray) -> np.ndarray:
    """[H, W, 2] flow -> BGR uint8 via the HSV angle/magnitude wheel
    (reference ``visualization.py:232-256``)."""
    mag = np.linalg.norm(flow_xy, axis=2)
    min_mag = mag.min()
    mag_range = mag.max() - min_mag

    ang = np.arctan2(flow_xy[..., 1], flow_xy[..., 0]) + np.pi
    ang = ang / (2.0 * np.pi)

    hsv = np.zeros(flow_xy.shape[:2] + (3,), np.float32)
    hsv[..., 0] = ang
    hsv[..., 1] = 1.0
    hsv[..., 2] = mag - min_mag
    if mag_range != 0.0:
        hsv[..., 2] /= mag_range

    rgb = _hsv_to_rgb(hsv)
    return (255 * rgb[..., ::-1]).astype(np.uint8)


def events_to_image(event_cnt_hw2: np.ndarray,
                    color_scheme: str = "green_red") -> np.ndarray:
    """[H, W, 2] (pos, neg) counts -> BGR uint8 event image with percentile
    normalization (reference ``visualization.py:259-332``)."""
    pos = event_cnt_hw2[..., 0]
    neg = event_cnt_hw2[..., 1]
    pos_max, pos_min = np.percentile(pos, 99), np.percentile(pos, 1)
    neg_max, neg_min = np.percentile(neg, 99), np.percentile(neg, 1)
    vmax = max(pos_max, neg_max)

    pos = (pos - pos_min) / (vmax - pos_min) if pos_min != vmax else pos
    neg = (neg - neg_min) / (vmax - neg_min) if neg_min != vmax else neg
    pos = np.clip(pos, 0, 1)
    neg = np.clip(neg, 0, 1)

    h, w = pos.shape
    img = np.zeros((h, w, 3), np.float64)
    if color_scheme == "gray":
        g = 0.5 + 0.5 * pos - 0.5 * neg
        img = np.repeat(g[..., None], 3, axis=2)
    elif color_scheme == "green_red":
        mask_pos, mask_neg = pos > 0, neg > 0
        img[..., 1][mask_pos] = pos[mask_pos]
        img[..., 2][mask_neg] = neg[mask_neg]
    elif color_scheme == "rpg":
        img[:] = 1.0
        mask_pos, mask_neg = pos > 0, neg > 0
        img[mask_neg] = (1.0, 0.0, 0.0)  # blue (BGR)
        img[mask_pos] = (0.0, 0.0, 1.0)  # red
    elif color_scheme == "prophesee":
        img[:] = 1.0
        mask_pos, mask_neg = pos > 0, neg > 0
        img[mask_neg] = (0.243137, 0.117647, 0.047059)
        img[mask_pos] = (0.635294, 0.423529, 0.235294)
    else:
        raise ValueError(f"unknown color scheme {color_scheme!r}")
    return (255 * img).astype(np.uint8)


def error_to_image(error_hw: np.ndarray, cap: float = 30.0) -> np.ndarray:
    """AEE error map -> Viridis, capped (reference
    ``visualization.py:152-163``). Needs cv2."""
    import cv2

    e = np.clip(error_hw / cap, 0, 1)
    e8 = (255 * e).astype(np.uint8)
    return cv2.applyColorMap(e8, cv2.COLORMAP_VIRIDIS)


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "storing or showing eval imagery needs cv2 (opencv-python): "
            "without it no PNG, and so no DSEC submission, can be "
            "written") from e
    return cv2


# ------------------------------------------------------------- orchestrator


KEYS = [
    "events", "events_window", "events_dynamic",
    "flow", "flow_window", "flow_dynamic", "flow_bw",
    "iwe", "iwe_fw_window", "iwe_bw_window",
    "iwe_fw_dynamic", "iwe_bw_dynamic",
    # depth_gt: a slot of the reference's (its ``visualization.py:43,102``
    # copies ``inputs["gtdepth"]``, which no loader produces)
    "flow_gt", "depth_gt", "error_flow",
]


class Visualization:
    """Render/update/store workflow (reference ``visualization.py:64-229``).

    ``data`` slots take NHWC numpy arrays or torch tensors (batch 1).
    ``store`` writes per-sequence ``<key>/%09d.png`` trees plus
    ``timestamps.txt``: the layout the DSEC submission formatter reads.

    Store-only protocols (``vis.enabled: false, store: true``, the DSEC
    submission configuration) render and PNG-encode on a single writeback
    thread, so the host's ``cv2.imwrite`` and the copies of device slots to
    the host overlap the next window's dispatch. Ordering and output are
    the synchronous path's (one worker, FIFO queue); ``close()`` flushes
    and re-raises any worker error.

    :raises RuntimeError: at construction, for a storing or displaying
        protocol on a machine without cv2.
    """

    def __init__(self, config: Dict, eval_id: int = -1,
                 path_results: Optional[str] = None):
        self.px = config["vis"].get("px", 400)
        self.show_rendered = config["vis"].get("enabled", False)
        self.store_rendered = config["vis"].get("store", False)
        if self.show_rendered or self.store_rendered:
            _cv2()
        self.img_idx = 0
        self.store_dir = None
        self.store_file = None
        if eval_id >= 0 and path_results is not None:
            self.store_dir = os.path.join(
                path_results, "results", f"eval_{eval_id}"
            )
            os.makedirs(self.store_dir, exist_ok=True)
        self.data: Dict[str, Optional[object]] = {}
        self.reset_image_ph()
        # writeback thread: only on the store-only path (a live display
        # must render on the main thread)
        self._async = bool(self.store_rendered and not self.show_rendered)
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._worker_err: Optional[BaseException] = None

    def reset_image_ph(self):
        for key in KEYS:
            self.data[key] = None

    # ------------------------------------------------------------ writeback

    def _ensure_worker(self):
        if self._worker is None:
            # depth-bounded: a slow disk throttles the producer instead of
            # accumulating a window of un-encoded frames per step
            self._queue = queue.Queue(maxsize=8)
            self._worker = threading.Thread(
                target=self._drain, name="vis-writeback", daemon=True
            )
            self._worker.start()

    def _drain(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            if self._worker_err is not None:
                # keep consuming after a failure so a blocked producer
                # always unblocks; the error re-raises in step()/close()
                continue
            data, inputs, sequence, ts, show = item
            try:
                self.render(inputs, show, data=data)
                self.store(sequence, ts, show, data=data)
            except BaseException as e:  # re-raised by close()/next step()
                self._worker_err = e

    def _put(self, item):
        """Bounded put that cannot deadlock: bails out (and re-raises) the
        moment the worker records an error, instead of blocking forever on
        a full queue whose consumer has stopped making progress."""
        while True:
            if self._worker_err is not None:
                self.close()  # re-raises
            try:
                self._queue.put(item, timeout=0.5)
                return
            except queue.Full:
                if self._worker is not None and not self._worker.is_alive():
                    raise RuntimeError("vis-writeback worker died")

    def close(self):
        """Flush the writeback queue and surface any worker error.
        Idempotent; a no-op for synchronous/displaying configurations."""
        if self._worker is not None:
            while True:
                try:
                    self._queue.put(None, timeout=0.5)
                    break
                except queue.Full:
                    if not self._worker.is_alive():
                        break
            self._worker.join()
            self._worker = None
        if self.store_file is not None:
            self.store_file.close()
            self.store_file = None
        if self._worker_err is not None:
            err, self._worker_err = self._worker_err, None
            raise err

    def step(self, inputs: Dict, sequence: Optional[str] = None,
             ts: Optional[float] = None, show: Optional[Sequence[str]] = None):
        if self._worker_err is not None:
            self.close()  # re-raises
        if self._async and sequence is not None:
            # snapshot by reference: the loop assigns fresh values into
            # self.data each step (never mutates in place), so a shallow
            # dict copy pins this step's panels. Device tensors go to the
            # host on the worker, off the dispatch loop.
            self._ensure_worker()
            # snapshot only what render() reads for the requested panels: a
            # show=['flow_bw'] store must not copy the net input every pass
            # nor pin unused tensors in the queue
            want = None if show is None else set(show)
            if want is not None and "error_flow" in want:
                want |= {"flow_bw", "flow_gt"}
            snap_keys = []
            if want is None or "events" in want:
                snap_keys += ["event_cnt", "net_input"]
            if want is None or want & {"flow_gt", "error_flow"}:
                snap_keys.append("gtflow")
            if want is None or "depth_gt" in want:
                snap_keys.append("gtdepth")
            snap_inputs = {
                k: inputs.get(k) for k in snap_keys
                if inputs.get(k) is not None
            }
            snap_data = {
                k: v for k, v in self.data.items()
                if want is None or k in want
            }
            self._put((snap_data, snap_inputs, sequence, ts, show))
            self.reset_image_ph()
            return
        self.render(inputs, show)
        if self.show_rendered:
            self.update(show)
        if self.store_rendered and sequence is not None:
            self.store(sequence, ts, show)
        self.reset_image_ph()

    def render(self, inputs: Dict, show=None, data: Optional[Dict] = None):
        if data is None:
            data = self.data
        want = None if show is None else set(show)
        if want is not None and "error_flow" in want:
            want |= {"flow_gt"}
        if data.get("events") is None and (want is None or "events" in want):
            src = inputs.get("event_cnt", inputs.get("net_input"))
            data["events"] = None if src is None else _host(src)
        if ((want is None or "flow_gt" in want)
                and inputs.get("gtflow") is not None):
            data["flow_gt"] = _host(inputs["gtflow"])
        if ((want is None or "depth_gt" in want)
                and inputs.get("gtdepth") is not None):
            data["depth_gt"] = _host(inputs["gtdepth"])

        # AEE error panel
        if data.get("flow_bw") is not None and data.get("flow_gt") is not None:
            fb = _host(data["flow_bw"])
            if fb.dtype == np.uint16:  # the u16 lattice readback
                fb = u16_to_flow(fb)
            fb = fb[0]
            fg = _host(data["flow_gt"])[0]
            err = np.sqrt(((fb - fg) ** 2).sum(-1))
            invalid = (fg[..., 0] == 0) & (fg[..., 1] == 0)
            err[invalid] = 0.0
            data["error_flow"] = err

        for key in list(data.keys()):
            if show is not None and key not in show:
                continue
            val = data[key]
            if val is None:
                continue
            val = _host(val)
            if val.ndim == 4:
                val = val[0]
            group = key.split("_")[0]
            if group in ("events", "iwe"):
                data[key] = events_to_image(val[..., :2])
            elif key == "flow_bw":
                if val.dtype == np.uint16:
                    # the device's u16 lattice (flow_to_u16): encode
                    # re-quantizes to these exact values
                    val = u16_to_flow(val)
                data[key] = encode_dsec_flow(val[..., :2])
            elif group == "flow":
                data[key] = flow_to_image(val[..., :2])
            elif key == "error_flow":
                data[key] = error_to_image(val)

    def update(self, show=None):  # pragma: no cover - needs a display
        cv2 = _cv2()
        for key in KEYS:
            if show is not None and key not in show:
                continue
            if key != "flow_bw" and self.data.get(key) is not None:
                cv2.namedWindow(key, cv2.WINDOW_NORMAL)
                cv2.resizeWindow(key, int(self.px), int(self.px))
                cv2.imshow(key, self.data[key])
        cv2.waitKey(1)

    def store(self, sequence: str, ts=None, show=None,
              data: Optional[Dict] = None):
        cv2 = _cv2()
        if data is None:
            data = self.data
        path_to = os.path.join(self.store_dir, sequence)
        if not os.path.exists(path_to):
            os.makedirs(path_to, exist_ok=True)
            for key in KEYS:
                os.makedirs(os.path.join(path_to, key), exist_ok=True)
            if self.store_file is not None:
                self.store_file.close()
            self.store_file = open(
                os.path.join(path_to, "timestamps.txt"), "w"
            )
            self.img_idx = 0

        for key in list(data.keys()):
            if show is not None and key not in show:
                continue
            if data.get(key) is None:
                continue
            kdir = os.path.join(path_to, key)
            os.makedirs(kdir, exist_ok=True)
            fname = os.path.join(kdir, "%09d.png" % self.img_idx)
            if not cv2.imwrite(fname, data[key]):
                raise RuntimeError(f"cv2.imwrite could not write {fname}")

        if ts is not None and self.store_file is not None:
            self.store_file.write(f"{ts}\n")
            self.store_file.flush()
        self.img_idx += 1
