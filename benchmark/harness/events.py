"""The one traffic generator: synthetic event-camera data from a traffic
mix's parameters (``benchmark/traffic/<mix>.json``) and a seed.

Events lie on the edges of seeded textured shapes (a disc whose radius
ripples with the angle) that move at a constant velocity, plus a share of
uniform noise. A shape's leading edge fires positive events and its
trailing edge negative ones. Coordinates are integer pixels, wrapped into
the frame; timestamps are normalised to the open interval (0, 1) within a
pass and sorted, as a loader formats them.

The work is the same for every seed: the real-event counts of the cells
(pass x lane) are a fixed ladder from the mix's ``events_per_pass`` range,
and the shape counts a ladder from its ``shapes`` range; the seed only
permutes them and draws the scenes. So runs with different seeds time the
same amount of work.

Training mixes (``"kind": "train"``) give a pool of windows in the training
CLI's packed wire (``training.window.stack_window``); eval mixes
(``"kind": "eval"``) a pool of GT windows of one sequence, each pass a
batch as the eval CLI's loader yields it, with a GT flow map and, for a
rectified mix, the raw coordinates, the forward rectification map and the
backward index.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

MAX_SEED = 2 ** 63 - 1


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one named stream of a seed (any integer up to
    2**63 - 1)."""
    return np.random.default_rng([int(seed) & MAX_SEED, *stream])


def ladder(lo: float, hi: float, n: int, rng) -> np.ndarray:
    """``n`` integers evenly spaced over ``[lo, hi]``, in a seeded order."""
    return rng.permutation(np.round(np.linspace(lo, hi, n)).astype(np.int64))


@dataclasses.dataclass
class Scene:
    """Shapes of one lane: centre at t = 0, velocity in px a pass, base
    radius, texture lobes, amplitude and phase."""

    cy: np.ndarray
    cx: np.ndarray
    vy: np.ndarray
    vx: np.ndarray
    r0: np.ndarray
    lobes: np.ndarray
    amp: np.ndarray
    phase: np.ndarray

    @property
    def n(self) -> int:
        return self.cy.shape[0]


def make_scene(n_shapes: int, res, speed, rng) -> Scene:
    h, w = res
    ang = rng.uniform(0, 2 * np.pi, n_shapes)
    sp = rng.uniform(speed[0], speed[1], n_shapes)
    return Scene(
        cy=rng.uniform(0, h, n_shapes), cx=rng.uniform(0, w, n_shapes),
        vy=sp * np.sin(ang), vx=sp * np.cos(ang),
        r0=rng.uniform(4.0, max(6.0, min(h, w) / 6.0), n_shapes),
        lobes=rng.integers(3, 8, n_shapes).astype(np.float64),
        amp=rng.uniform(0.05, 0.25, n_shapes),
        phase=rng.uniform(0, 2 * np.pi, n_shapes))


def pass_events(scene: Scene, active: int, counts, t0: float, res,
                noise_share: float, rng) -> List[np.ndarray]:
    """Events ``(ts, y, x, p)`` float32 of consecutive passes from global
    time ``t0`` (in passes), ``counts[i]`` of them in pass ``i``, from the
    first ``active`` shapes of ``scene``: one array a pass, ts normalised to
    (0, 1) and sorted within it."""
    h, w = res
    counts = np.asarray(counts, np.int64)
    n = int(counts.sum())
    pid = np.repeat(np.arange(len(counts)), counts)
    # stratified timestamps: sorted within each pass by construction
    start = np.repeat(np.cumsum(counts) - counts, counts)
    rank = np.arange(n) - start
    ts = (rank + rng.random(n, np.float32)) / np.repeat(counts, counts)
    ts = np.clip(ts, 1e-4, 1 - 1e-4).astype(np.float32)
    k = rng.integers(0, active, n)
    theta = rng.random(n, np.float32) * np.float32(2 * np.pi)
    t = (t0 + pid).astype(np.float32) + ts
    sc = {f: getattr(scene, f).astype(np.float32)[k]
          for f in ("cy", "cx", "vy", "vx", "r0", "amp", "lobes", "phase")}
    r = sc["r0"] * (1 + sc["amp"] * np.sin(sc["lobes"] * theta
                                           + sc["phase"]))
    ny, nx = np.sin(theta), np.cos(theta)
    y = sc["cy"] + sc["vy"] * t + r * ny
    x = sc["cx"] + sc["vx"] * t + r * nx
    p = np.where(ny * sc["vy"] + nx * sc["vx"] >= 0, 1.0, -1.0)
    noise = rng.random(n, np.float32) < noise_share
    n_noise = int(noise.sum())
    y[noise] = rng.random(n_noise, np.float32) * h
    x[noise] = rng.random(n_noise, np.float32) * w
    p[noise] = np.where(rng.random(n_noise) < 0.5, -1.0, 1.0)
    ev = np.empty((n, 4), np.float32)
    ev[:, 0] = ts
    ev[:, 1] = np.mod(np.floor(y), h)
    ev[:, 2] = np.mod(np.floor(x), w)
    ev[:, 3] = p
    return np.split(ev, np.cumsum(counts)[:-1])


def gt_flow(scene: Scene, active: int, t0: float, passes: int,
            res) -> np.ndarray:
    """``[H, W, 2]`` (x, y) displacement over a GT window of ``passes``
    passes from ``t0``: each active shape's disc moves by ``v * passes``;
    pixels outside every disc are zero (no GT)."""
    h, w = res
    out = np.zeros((h, w, 2), np.float32)
    for i in range(active):
        cy = np.mod(scene.cy[i] + scene.vy[i] * t0, h)
        cx = np.mod(scene.cx[i] + scene.vx[i] * t0, w)
        r = scene.r0[i]
        y0, y1 = int(max(0, cy - r)), int(min(h, cy + r + 1))
        x0, x1 = int(max(0, cx - r)), int(min(w, cx + r + 1))
        yy, xx = np.mgrid[y0:y1, x0:x1]
        inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        out[y0:y1, x0:x1][inside] = (scene.vx[i] * passes,
                                     scene.vy[i] * passes)
    return out


def pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


# ----------------------------------------------------------------- train


@dataclasses.dataclass
class TrainWindow:
    host: Dict[str, np.ndarray]  # the packed wire, as stack_window gives it
    real: int  # real (unpadded) events of the window, all lanes
    counts: np.ndarray  # [P, B] real events a pass and lane
    events: np.ndarray  # [P, B, N, 4] the plain event list (padded)
    grad: np.ndarray  # [P, B, N, 1] 1 on the real rows


def train_pool(mix: Dict, seed: int, stack_window=None,
               first: Optional[int] = None) -> List[TrainWindow]:
    """The training mix's pool of windows (its ``first`` ones only, when
    given). ``stack_window`` is the program's wire (``training.window.
    stack_window``), called as the training CLI's producer calls it;
    without it ``host`` is ``None``."""
    res = tuple(mix["resolution"])
    b, p, slots, pool = mix["batch"], mix["passes"], mix["slots"], mix["pool"]
    order = rng_for(seed, 0)
    counts = ladder(*mix["events_per_pass"], pool * p * b, order)
    counts = counts.reshape(pool, p, b)
    shapes = ladder(*mix["shapes"], pool * b, order).reshape(pool, b)
    out = []
    for wi in range(pool if first is None else first):
        rng = rng_for(seed, 1, wi)
        scenes = [make_scene(int(shapes[wi, lane]), res,
                             mix["speed_px_per_pass"], rng)
                  for lane in range(b)]
        ev = np.zeros((p, b, slots, 4), np.float32)
        grad = np.zeros((p, b, slots, 1), np.float32)
        for lane in range(b):
            sc = scenes[lane]
            per_pass = pass_events(sc, sc.n, counts[wi, :, lane], 0.0, res,
                                   mix["noise_share"], rng)
            for pi, e in enumerate(per_pass):
                ev[pi, lane, : e.shape[0]] = e
                grad[pi, lane, : e.shape[0]] = 1.0
        batches = [{"event_list": ev[pi], "grad_mask": grad[pi]}
                   for pi in range(p)]
        host = None if stack_window is None else stack_window(
            batches, packed=True, net_compact=True, derive_net=True)
        out.append(TrainWindow(host, int(counts[wi].sum()), counts[wi], ev,
                               grad))
    return out


# ------------------------------------------------------------------ eval


@dataclasses.dataclass
class Rectification:
    rect_map: np.ndarray  # [H, W, 2] float32 (x_rect, y_rect) at raw pixel
    mapping: np.ndarray  # [H, W, 2] float32 (x_src, y_src) at rect pixel
    remap_idx: np.ndarray  # [H, W] int32, 1-based backward index


def radial_rectification(res, k: float) -> Rectification:
    """A mild radial distortion of strength ``k`` (barrel for k < 0): the
    forward map moves raw pixel ``c + d`` to ``c + d (1 + k |d / W|^2)``;
    the backward map is its first-order inverse, and the index is its
    nearest lookup (``rint``, clipped to the frame, 1-based), as a loader
    builds both from a DSEC calibration."""
    h, w = res
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dy, dx = (yy - cy) / w, (xx - cx) / w
    r2 = dy * dy + dx * dx
    fw = 1.0 + k * r2
    bw = 1.0 - k * r2
    rect_map = np.stack([cx + dx * w * fw, cy + dy * w * fw],
                        -1).astype(np.float32)
    mapping = np.stack([cx + dx * w * bw, cy + dy * w * bw],
                       -1).astype(np.float32)
    mx = np.clip(np.rint(mapping[..., 0]), 0, w - 1).astype(np.int64)
    my = np.clip(np.rint(mapping[..., 1]), 0, h - 1).astype(np.int64)
    remap_idx = (my * w + mx + 1).astype(np.int32)
    return Rectification(rect_map, mapping, remap_idx)


@dataclasses.dataclass
class EvalSequence:
    batches: List[Dict[str, np.ndarray]]  # one a pass, loader format
    counts: np.ndarray  # [windows, P] real events a pass
    raw: List[np.ndarray]  # per pass [n, 4] (ts, y_raw, x_raw, p), unpadded
    gt: List[np.ndarray]  # per GT window [H, W, 2]
    rect: Optional[Rectification]
    meta_ts: float  # the timestamp a window's meta carries


def eval_sequence(mix: Dict, seed: int) -> EvalSequence:
    """The eval mix's sequence of ``pool`` GT windows of ``passes`` passes,
    each pass a batch padded to ``slots`` rows as the loader collates it,
    with the keys the mix's wire reads."""
    res = tuple(mix["resolution"])
    p, slots, pool = mix["passes"], mix["slots"], mix["pool"]
    order = rng_for(seed, 0)
    counts = ladder(*mix["events_per_pass"], pool * p, order).reshape(pool, p)
    active = ladder(*mix["shapes"], pool, order)
    rng = rng_for(seed, 2)
    scene = make_scene(int(max(mix["shapes"])), res,
                       mix["speed_px_per_pass"], rng)
    rect = None
    if mix.get("rectify") is not None:
        rect = radial_rectification(res, mix["rectify"]["k"])
    # the polarity masks ship only on the plain wire; the packed and u32
    # wires derive them on the device
    runtime = mix.get("pipeline", {}).get("runtime") or {}
    plain_wire = not runtime.get("packed_wire", True)
    batches, raw, gts = [], [], []
    for wi in range(pool):
        t_win = float(wi * p)
        gts.append(gt_flow(scene, int(active[wi]), t_win, p, res))
        for pi, ev in enumerate(pass_events(
                scene, int(active[wi]), counts[wi], t_win, res,
                mix["noise_share"], rng)):
            raw.append(ev)
            b = {}
            lst = ev.copy()
            if rect is not None:
                yi = ev[:, 1].astype(np.int64)
                xi = ev[:, 2].astype(np.int64)
                lst[:, 1] = rect.rect_map[yi, xi, 1]
                lst[:, 2] = rect.rect_map[yi, xi, 0]
                raw_yx = np.stack([ev[:, 1], ev[:, 2]], -1).astype(np.uint16)
                b["event_raw_xy"] = pad_rows(raw_yx, slots)[None]
            b["event_list"] = pad_rows(lst, slots)[None]
            if plain_wire:
                pol = np.stack([lst[:, 3] > 0, lst[:, 3] < 0],
                               -1).astype(np.float32)
                b["event_list_pol_mask"] = pad_rows(pol, slots)[None]
            if pi == p - 1:
                b["gtflow"] = gts[-1][None]
            batches.append(b)
    return EvalSequence(batches, counts, raw, gts, rect,
                        float(mix.get("meta_ts", 0.0)))
