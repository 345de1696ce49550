"""The eval pipeline: the PyTorch counterpart of
``taming_event_flow_tpu/pipeline/eval.py``.

It streams GT-aligned windows at batch 1, runs the model (any of the
registry's four; a stateless one carries ``()``), feeds the Iterative or
Linear validation state (``metrics.warping``) and, at every ``passes_loss``
boundary, computes AEE on the window's backward flow (the DSEC submission
quantity), RSAT and FWL (reference ``eval_flow.py:16-207``).

Under ``torchrun`` (a process group of more than one rank) the slot state's
event axis is sharded over the ranks, as the JAX pipeline shards it over its
devices (``parallel/eval.py``): every rank streams the same batches, runs the
model on the whole input and ingests its N / E events; the window reducers
merge their partial images over the ranks. Every rank runs every collective
in the same order; the caller reads the metrics back on one rank.

The wires follow the JAX pipeline's ``runtime`` keys, each exact by
construction:

* ``packed_wire`` (default on): the count network input, the polarity masks
  and the event masks derive on the device from the event list (a
  rectified sequence's from its raw coordinates and :attr:`EvalPipeline.
  cur_ridx`; voxel batches, and rectified ones without an index, ship their
  net input and event mask), and the ``flow_bw`` map comes back on the DSEC
  u16 lattice. Off, every input ships as the loader built it and
  ``flow_bw`` comes back float32.
* ``u32_wire`` (default on, under ``packed_wire``): a window's events ship
  as float32 ts and one u32 word for (y, x, p) (``ops.encodings.
  pack_event_wire_np``), when the first window's coordinates are integers
  in the format's range; a rectified window (batch 1, a forward map in
  :attr:`EvalPipeline.cur_rect`, no coordinate flips) ships its raw
  coordinates and looks the rectified ones up on the device, a row gather
  of the map.
* ``probe_wire``: two ``SectionTimer`` sections before each window call,
  ``probe_prev_state_drain`` (the previous window's device work) and
  ``probe_staged_input_drain`` (this window's uploads), each waiting on a
  CUDA event.

The JAX pipeline's producer staging of windows is left out: ported and
measured on the card, it gained nothing (ROADMAP.md).

On the card the window step replays a CUDA graph from the second window of
a bucket on (``training/graphed.py``; a sharded step stays eager): the
slot state it hands back is the graph's own buffers, which the next window
resets and rewrites, and the carry, flow and metrics are clones, so the
reader thread may still hold them while the next window replays.

The windowed path stages each window in the next slot of a ring of two
slots of host buffers (:class:`.staging.StagingRing`: page-locked on the
card) and uploads it without blocking, so the host packs window k+1 while
the device runs window k; the only wait, before a slot is filled again,
is for that slot's last uploads. The per-pass path uploads each array
with a blocking copy.

While a ``torch.profiler`` profile is active, every ``SectionTimer``
section is a span of the GT window it serves (its rid is
:attr:`EvalPipeline.window_id`), and the pipeline counts ``h2d_bytes`` (each
host array it uploads), ``h2d_async_bytes`` (those the ring uploads),
``stage_slot_waits`` (slots taken while their last uploads were pending),
``slots`` (the event rows a pass or window stages) and ``events`` (those
with a nonzero polarity; padding rows carry zero). A
replayed window step records ``eval.replay`` (and ``eval.capture``) inside
``window_call``, and the counters ``eval_graph_replays`` and
``eval_graph_captures``.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..metrics import METRIC_REGISTRY, ValConfig, compute_aee, grow_val_state
from ..ops.encodings import pack_event_wire_np
from ..parallel import make_eval_mesh, make_sharded_reducers, world_size
from ..tracking.loggers import initialize_quant_results
from ..training import make_eval_step, make_eval_window_step
from ..training.window import pad_batch_events
from ..utils.device import resolve_device
from ..utils.diagnostics import SectionTimer, count, tracing
from ..utils.visualization import flow_to_u16, u16_to_flow
from .staging import StagingRing


class VisPolicy:
    """Which visualization quantities the protocol consumes: gates the
    tracked-state knobs (``ValConfig.track_fw_prop``/``track_bw``) and the
    windowed path."""

    def __init__(self, config: Dict):
        vis = config.get("vis", {}) or {}
        self.enabled = bool(vis.get("enabled"))
        self.store = bool(vis.get("store"))
        self.show = vis.get("show")
        self.dynamic = bool(vis.get("dynamic"))
        self.mask_output = bool(vis.get("mask_output"))
        self.bars = bool(vis.get("bars"))
        self.verbose = bool(vis.get("verbose"))
        self.on = self.enabled or self.store

    def want(self, key: str) -> bool:
        """Is this visualization quantity displayed or stored?"""
        if not self.on:
            return False
        if self.show is None or key in self.show:
            return True
        # error_flow is derived from flow_bw + GT
        return key == "flow_bw" and "error_flow" in self.show


def _u32_exact(yx: np.ndarray) -> bool:
    """Do the ``[..., 2]`` (y, x) coordinates fit the u32 wire: integers,
    ``0 <= y < 65536``, ``0 <= x < 16384``?"""
    return bool(np.all(yx == np.floor(yx))
                and yx.min(initial=0.0) >= 0.0
                and yx[..., 1].max(initial=0.0) < 16384
                and yx[..., 0].max(initial=0.0) < 65536)


def _to_host(mets: Dict) -> Dict:
    return {k: v.cpu().numpy() if torch.is_tensor(v) else v
            for k, v in mets.items()}


def consume_mets(host_mets: Dict, val_results: Dict, sequence: str,
                 metric_names) -> Optional[np.ndarray]:
    """Fold one window boundary's (host) metric values into the
    per-sequence accumulators. Returns the (decoded) ``flow_bw`` map when
    the metrics carried one."""
    flow_bw = host_mets.get("flow_bw")
    if flow_bw is not None and flow_bw.dtype == np.uint16:  # DSEC lattice
        flow_bw = u16_to_flow(flow_bw)
    if "aee" in host_mets:
        val_results[sequence]["AEE"]["metric"] += float(host_mets["aee"])
        val_results[sequence]["AEE"]["it"] += 1
    for metric in metric_names:
        if metric == "RSAT" and "rsat" in host_mets:
            val_results[sequence][metric]["metric"] += float(
                host_mets["rsat"])
            val_results[sequence][metric]["it"] += 1
        elif metric == "FWL" and "fwl" in host_mets:
            val_results[sequence][metric]["metric"] += float(
                host_mets["fwl"])
            val_results[sequence][metric]["it"] += 1
    return flow_bw


class MetricsConsumer:
    """Boundary-metric readback on a reader thread, so that waiting for a
    window's device work overlaps the next window's dispatch. FIFO with the
    same arithmetic as :func:`consume_mets`, so the results are identical.

    The thread owns ``val_results``; ``close()`` drains the queue,
    re-raises any worker error and hands the dict back.
    """

    def __init__(self, metric_names, depth: int = 4):
        self.metric_names = metric_names
        self.val_results: Dict = {}
        # depth-bounded: each queued item pins one window's metric tensors
        self._q = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._drain, name="metrics-reader", daemon=True)
        self._thread.start()

    def put(self, dev_mets: Dict, sequence: str) -> None:
        if self._err is not None:
            self.close()  # re-raises
        self._q.put((dev_mets, sequence))

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                continue  # keep consuming so the producer never blocks
            dev_mets, sequence = item
            try:
                host = _to_host(dev_mets)
                self.val_results = initialize_quant_results(
                    self.val_results, sequence, self.metric_names)
                consume_mets(host, self.val_results, sequence,
                             self.metric_names)
            except BaseException as e:  # re-raised by close()
                self._err = e

    def close(self) -> Dict:
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        return self.val_results


class EvalPipeline:
    """Owns the eval steps and the loop's mutable device state.

    :param config: the merged eval config (``configs/eval_*.yml`` layout).
    :param model: a model of the registry (``models.build_model``) with its
        weights.
    :param device: the card unless the caller asks for the CPU; raises when
        no card is found.

    The slot state's event axis is sharded over the ranks of the process
    group when there are several, the bucket divides by their number and
    ``round_ts`` is off (the JAX pipeline's rule).
    """

    def __init__(self, config: Dict, model, device="cuda"):
        self.device = resolve_device(device)
        # the steps run an eval-mode copy; the caller's mode stays its own
        self.model = model.to(self.device)
        self.vis = VisPolicy(config)

        self.res = tuple(config["loader"]["resolution"])
        self.passes = config["data"]["passes_loss"]
        self.flow_scaling = config["loss"].get("flow_scaling", 32)
        self.metrics_cfg = config.get("metrics", {})
        self.metric_names = self.metrics_cfg.get("name", ["FWL", "RSAT"])
        self.voxel = config["data"].get("voxel")
        self.gtflow_mode = config["data"]["mode"] == "gtflow"

        self.val_cls = METRIC_REGISTRY[
            self.metrics_cfg.get("warping", "Iterative")]
        want = self.vis.want
        self.val_cfg = ValConfig(
            res=self.res, passes=self.passes,
            round_ts=config["loss"].get("round_ts", False),
            track_fw_prop=want("flow_dynamic") or want("flow_window"),
            track_bw=want("iwe_bw_dynamic") or want("iwe_bw_window"),
        )
        n_slots = config["loader"].get("n_events_pad") or 4096
        self.eval_mesh = None
        world = world_size()
        if world > 1 and n_slots % world == 0 and not self.val_cfg.round_ts:
            self.eval_mesh = make_eval_mesh()
            if self.eval_mesh.rank == 0:
                print(f"Event-sharded eval over {world} devices")
        self.n_slots = n_slots  # the bucket; a rank holds n_slots / E slots
        self._set_criteria()

        self.inference_dtype = None
        if self.metrics_cfg.get("inference_dtype") in ("bfloat16", "bf16"):
            self.inference_dtype = torch.bfloat16

        runtime = config.get("runtime") or {}
        self.packed_wire = bool(runtime.get("packed_wire", True))
        self.u32_wire = self.packed_wire and bool(
            runtime.get("u32_wire", True))
        self.probe_wire = bool(runtime.get("probe_wire", False))
        # the host flips coordinates after the forward-map lookup, so a
        # flipped rectified window cannot use the device's lookup
        self.coord_flips = bool(
            {"Horizontal", "Vertical"} & set(
                config["loader"].get("augment") or []))
        self._u32_ok = None  # the first u32 window's format probe
        self._ring = StagingRing(self.device)  # the windowed path's uploads
        self._window_done = None  # CUDA event after the last window call

        # windowed path: protocols whose displayed/stored quantities are all
        # window-level (the DSEC submission config, flow_bw only) run one
        # window step per GT window; any per-pass quantity keeps the
        # per-pass path
        _dyn_keys = ("events_dynamic", "iwe_fw_dynamic", "iwe_bw_dynamic",
                     "flow_dynamic")
        per_pass_vis = (
            want("events") or want("flow") or want("iwe")
            or (self.passes > 1 and self.vis.dynamic
                and any(want(k) for k in _dyn_keys))
        )
        self.windowed = (self.passes > 1 and not per_pass_vis
                         and not self.vis.enabled)
        # window-boundary metrics inside the window step, unless the
        # protocol gates metrics on eval_time
        self.aee_in_program = self.gtflow_mode and "AEE" in self.metric_names
        self.use_extras = self.windowed and "eval_time" not in self.metrics_cfg

        self._eval_step = self._make_step()
        self._window_step = self._make_window_step()

        # mutable loop state
        self._ridx = None
        self._rect = None
        self.reset_carry()
        self.vstate = self.criteria.init()
        self.passes_done = 0  # host mirror of vstate.pass_idx
        self.vstate_stale = False  # last window's state awaits its reset
        self.window_mets = None  # in-step metrics of the last window
        self.wbuf = []  # buffered batches of the in-flight window
        self.window_id = 0  # GT windows closed: the rid of the sections
        self.tm = SectionTimer()

    # --------------------------------------------------------- programs

    def _set_criteria(self):
        """The validation scheme for this rank's share of the bucket, and
        its window reducers (merging over the event mesh, when sharded)."""
        n_ranks = 1 if self.eval_mesh is None else self.eval_mesh.n_event
        self.criteria = self.val_cls(self.val_cfg, 1, self.n_slots // n_ranks,
                                     self.device)
        self.reducers = make_sharded_reducers(self.criteria, self.eval_mesh)

    def _make_step(self):
        return make_eval_step(
            self.model, self.criteria, self.flow_scaling,
            inference_dtype=self.inference_dtype,
            extras=self.window_metrics, mesh=self.eval_mesh)

    def _make_window_step(self):
        if not self.windowed:
            return None
        return make_eval_window_step(
            self.model, self.criteria, self.flow_scaling,
            inference_dtype=self.inference_dtype, reset_first=True,
            extras=self.window_metrics if self.use_extras else None,
            mesh=self.eval_mesh)

    # ------------------------------------------------------------ state

    @property
    def cur_ridx(self) -> Optional[torch.Tensor]:
        """The current sequence's backward-rectification index on the
        device (``[H, W]`` or ``[1, H, W]`` int32, 1-based, ``0`` out of
        source: ``data.remap_index``), or ``None``. The caller sets it on
        each new sequence, from the loader's ``remap_idx``; a host array is
        uploaded once, on assignment."""
        return self._ridx

    @cur_ridx.setter
    def cur_ridx(self, value):
        self._ridx = (None if value is None
                      else torch.as_tensor(value, device=self.device))

    @property
    def cur_rect(self) -> Optional[torch.Tensor]:
        """The current sequence's forward rectification map on the device
        (``[H, W, 2]`` float32, ``(x_rect, y_rect)`` at the raw pixel:
        ``data.rectify_values`` of a batch-1 loader), or ``None``: the u32
        wire's lookup table. Set per sequence as :attr:`cur_ridx` is."""
        return self._rect

    @cur_rect.setter
    def cur_rect(self, value):
        self._rect = (None if value is None else torch.as_tensor(
            value, dtype=torch.float32, device=self.device).contiguous())

    def reset_carry(self):
        # the carry starts in the compute dtype (zeros are exact in either)
        self.carry = self.model.init_state(
            1, self.res[0], self.res[1],
            dtype=self.inference_dtype or torch.float32, device=self.device)

    def start_sequence(self):
        """Sequence rollover: fresh carry and slot state; buffered passes
        of the old sequence are dropped."""
        self.reset_carry()
        if self.windowed:
            self.vstate_stale = True  # the next window step resets it
        else:
            self.vstate = self.criteria.reset(self.vstate)
        self.passes_done = 0
        self.wbuf.clear()

    def ts_jump_flush(self):
        """Mid-window ts jump: buffered passes land before the carry reset
        (the validation window continues across the jump); the window's
        remaining passes then run per pass."""
        for b in list(self.wbuf):
            self.run_pass(b)
        self.wbuf.clear()
        self.reset_carry()

    def in_eval_time(self, ts) -> bool:
        if "eval_time" not in self.metrics_cfg:
            return True
        lo, hi = self.metrics_cfg["eval_time"]
        return lo <= ts <= hi

    # ------------------------------------------------------ bucket size

    def ensure_bucket(self, batch):
        """Fit a batch to the static event bucket: pad short batches; grow
        the bucket (rebuilding the steps, which drops the window step's
        graphs: the new bucket warms up anew, and reallocating the staging
        ring's buffers at the next window) when a batch overflows it. The
        decision reads the whole batch, which every rank streams, so every
        rank grows alike; a sharded bucket grows to a multiple of the
        ranks."""
        n_batch = batch["event_list"].shape[1]
        if n_batch > self.n_slots:
            n_new = n_batch
            if self.eval_mesh is not None:
                n_new = -(-n_batch // self.eval_mesh.n_event) \
                    * self.eval_mesh.n_event
            warnings.warn(
                f"event bucket grew {self.n_slots} -> {n_new}."
                " Set loader.n_events_pad to a static per-dataset cap.",
                stacklevel=2,
            )
            self.n_slots = n_new
            self._set_criteria()
            self.vstate = grow_val_state(self.vstate, self.criteria.n_events)
            self._eval_step = self._make_step()
            self._window_step = self._make_window_step()
            self.wbuf[:] = [pad_batch_events(b, n_new) for b in self.wbuf]
        if n_batch < self.n_slots:
            return pad_batch_events(batch, self.n_slots)
        return batch

    # -------------------------------------------------------- dispatch

    def _dev(self, a):
        """The per-pass path's upload: a blocking copy of a host array."""
        count("h2d_bytes", a.nbytes)
        return torch.as_tensor(a, device=self.device)

    def _count_events(self, bufs):
        """The ``slots`` and ``events`` counters of the staged batches."""
        if tracing():
            evs = [b["event_list"] for b in bufs]
            count("slots", sum(e.shape[0] * e.shape[1] for e in evs))
            count("events", sum(int(np.count_nonzero(e[..., 3]))
                                for e in evs))

    def _derive_on_device(self, batch) -> bool:
        """Packed count mode: the net input and the event mask derive from
        the event list (exact), a rectified batch's from its raw
        coordinates and :attr:`cur_ridx`; a rectified batch without an
        index ships its net input and event mask."""
        return self.packed_wire and self.voxel is None and (
            "event_raw_xy" not in batch or self.cur_ridx is not None)

    def window_metrics(self, vstate, gtflow):
        """Window-boundary quantities (the ``extras`` hook of the steps);
        AEE and ``flow_bw`` need ``gtflow``."""
        out, red = {}, self.reducers
        if "RSAT" in self.metric_names and "FWL" in self.metric_names:
            # both from RSAT's two splats (FWL bitwise equal)
            rsat, fwl = red["rsat_fwl"](vstate)
            out["rsat"] = rsat[0]
            out["fwl"] = fwl
        elif "RSAT" in self.metric_names:
            out["rsat"] = red["rsat"](vstate)[0]
        elif "FWL" in self.metric_names:
            out["fwl"] = red["fwl"](vstate)
        if self.aee_in_program and gtflow is not None:
            flow_bw = self.criteria.window_flow(
                vstate, mode="backward", mask=False) * self.passes
            if self.vis.want("flow_bw"):
                # the packed wire reads back the DSEC lattice (half the
                # bytes; the store re-encodes to these exact values)
                out["flow_bw"] = (flow_to_u16(flow_bw) if self.packed_wire
                                  else flow_bw)
            mask = None
            if self.metrics_cfg.get("mask_aee"):
                mask = red["window_events"](vstate)
            out["aee"] = compute_aee(
                flow_bw, gtflow, event_mask=mask,
                res_aee=self.metrics_cfg.get("res_aee"),
                vertical_crop_aee=self.metrics_cfg.get("vertical_crop_aee"),
            )
        return out

    def run_pass(self, b, meta=None):
        """One forward + update (the per-pass path). On an in-``eval_time``
        boundary pass the window metrics come with it."""
        if self.vstate_stale:
            self.vstate = self.criteria.reset(self.vstate)
            self.vstate_stale = False
        self._count_events([b])
        ev = self._dev(b["event_list"])
        x = emask = raw = pol = None
        if self._derive_on_device(b):
            if "event_raw_xy" in b:
                raw = self._dev(b["event_raw_xy"])
        else:
            x = self._dev(b["net_input"])
            emask = self._dev(b["event_mask"])
        if not self.packed_wire:
            pol = self._dev(b["event_list_pol_mask"])
        want = (meta is not None and self.passes_done + 1 == self.passes
                and self.in_eval_time(meta["ts"]))
        aux = (self._dev(b["gtflow"]) if (want and self.aee_in_program)
               else None)
        with self.tm("pass_call", rid=self.window_id):
            out = self._eval_step(self.vstate, self.carry, x, ev, pol, emask,
                                  n_active=self.passes_done + 1, aux=aux,
                                  with_extras=want, raw=raw,
                                  ridx=self.cur_ridx)
        if want:
            self.vstate, self.carry, flow_fine, self.window_mets = out
        else:
            self.vstate, self.carry, flow_fine = out
        self.passes_done += 1
        return flow_fine

    def stage_window(self, bufs):
        """Stack a clean P-pass window onto the device on the configured
        wire: ``(xs, evs, emasks, aux, raw)``, with ``None`` for what the
        step derives; ``evs`` is the u32 wire's dict where
        :meth:`_stage_events` packs it, and ``raw`` a rectified window's
        raw coordinates when its input derives from the float32 event
        list. The polarity masks ship only on the plain wire
        (:meth:`stage_pols`). The window takes the next slot of the
        staging ring (:class:`.staging.StagingRing`): its arrays are
        stacked and packed into the slot's host buffers, then uploaded
        together, without blocking on the card."""
        self._count_events(bufs)
        ring = self._ring
        ring.next_slot()
        aux = None
        if self.use_extras and self.aee_in_program:
            gt = bufs[-1]["gtflow"]
            np.copyto(ring.buffer("gtflow", gt.shape, gt.dtype), gt)
            aux = ring.upload("gtflow")
        if not self._derive_on_device(bufs[0]):
            staged = (self._stack(bufs, "net_input"),
                      self._stack(bufs, "event_list"),
                      self._stack(bufs, "event_mask"), aux, None)
        else:
            evs, raw = self._stage_events(bufs)
            staged = None, evs, None, aux, raw
        ring.flush()
        return staged

    def stage_pols(self, bufs):
        """The plain wire's polarity masks of a window (bool), ``None`` on
        the packed wire, where the step derives them."""
        if self.packed_wire:
            return None
        pols = self._stack(bufs, "event_list_pol_mask", bool)
        self._ring.flush()
        return pols

    def _stack(self, bufs, key, dtype=None):
        """The passes' ``key`` arrays stacked into the staging ring's
        buffer of that name (cast to ``dtype``), its upload pending."""
        first = bufs[0][key]
        host = self._ring.buffer(key, (len(bufs),) + first.shape,
                                 dtype or first.dtype)
        np.stack([b[key] for b in bufs], out=host, casting="unsafe")
        return self._ring.upload(key)

    def _stage_events(self, bufs):
        """A derived window's events: the u32 wire when it is exact and
        on, else the float32 list (and a rectified window's raw
        coordinates). Returns ``(evs, raw)``."""
        rectified = "event_raw_xy" in bufs[0]
        if self.u32_wire and self.eval_mesh is None:
            if rectified:
                if self.cur_rect is not None and not self.coord_flips:
                    return dict(self._stage_u32(bufs, "event_raw_xy"),
                                rect=self.cur_rect), None
            else:
                if self._u32_ok is None:
                    # the format's rule, checked on the first window:
                    # integer coordinates, y < 65536, x < 16384
                    self._u32_ok = all(_u32_exact(b["event_list"][..., 1:3])
                                       for b in bufs)
                if self._u32_ok:
                    return self._stage_u32(bufs, None), None
        evs = self._stack(bufs, "event_list")
        raw = self._stack(bufs, "event_raw_xy") if rectified else None
        return evs, raw

    def _stage_u32(self, bufs, yx_key):
        """The u32 wire's ``{"ts", "yxp"}`` of a window, copied and packed
        pass by pass into the staging ring, their uploads pending; (y, x)
        from the event list, or a rectified window's raw ``yx_key``."""
        ring = self._ring
        ev0 = bufs[0]["event_list"]
        shape = (len(bufs),) + ev0.shape[:-1]
        ts = ring.buffer("ts", shape, ev0.dtype)
        yxp = ring.buffer("yxp", shape, np.int32).view(np.uint32)
        for i, b in enumerate(bufs):
            ev = b["event_list"]
            yx = ev[..., 1:3] if yx_key is None else b[yx_key]
            np.copyto(ts[i], ev[..., 0])
            pack_event_wire_np(yx[..., 0], yx[..., 1], ev[..., 3],
                               out=yxp[i])
        return {"ts": ring.upload("ts"), "yxp": ring.upload("yxp")}

    def _drain_event(self):
        """A CUDA event recorded on the current stream now (``None`` on
        the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def run_window(self):
        """Run the buffered GT window as one window step (the step resets
        the stale slot state itself)."""
        self.vstate_stale = False
        with self.tm("window_assemble"):
            xs, evs, emasks, aux, raw = self.stage_window(self.wbuf)
            pols = self.stage_pols(self.wbuf)
        if self.probe_wire:
            # what a window call waits on: the previous window still
            # running, or this window's uploads still in flight
            with self.tm("probe_prev_state_drain"):
                if self._window_done is not None:
                    self._window_done.synchronize()
            with self.tm("probe_staged_input_drain"):
                staged = self._drain_event()
                if staged is not None:
                    staged.synchronize()
        with self.tm("window_call"):
            out = self._window_step(self.vstate, self.carry, xs, evs, pols,
                                    emasks, aux, raw=raw, ridx=self.cur_ridx)
        if self.probe_wire:
            self._window_done = self._drain_event()
        if self.use_extras:
            self.vstate, self.carry, flow_fine, self.window_mets = out
        else:
            self.vstate, self.carry, flow_fine = out
        self.passes_done = self.passes
        self.wbuf.clear()
        return flow_fine

    def ingest(self, batch, meta) -> Optional[torch.Tensor]:
        """Feed one loader batch: window buffering on the windowed path, a
        per-pass step otherwise. Returns the finest-scale flow of the pass
        or window that ran, or ``None`` while buffering."""
        if self.windowed and self.passes_done == 0:
            self.wbuf.append(batch)
            if len(self.wbuf) == self.passes:
                with self.tm("window_dispatch", rid=self.window_id):
                    return self.run_window()
            return None
        with self.tm("pass_dispatch", rid=self.window_id):
            return self.run_pass(batch, meta)

    # ------------------------------------------------- boundary metrics

    def boundary_outputs(self, batch, meta):
        """At a window boundary (``passes_done == passes``): this window's
        metric outputs as device tensors, then mark the slot state for
        reset. Returns ``(dev_mets, flow_bw)``, both ``None`` when the
        ``eval_time`` gate skips the window."""
        dev_mets = None
        if self.in_eval_time(meta["ts"]):
            if self.window_mets is not None:
                dev_mets = dict(self.window_mets)
            else:
                # eval_time-gated protocols: the metrics outside a step
                with self.tm("mets_dispatch", rid=self.window_id), \
                        torch.inference_mode():
                    gt = (self._dev(batch["gtflow"])
                          if "gtflow" in batch else None)
                    dev_mets = self.window_metrics(self.vstate, gt)
        self.window_mets = None
        if self.windowed:
            self.vstate_stale = True  # the next window step resets it
        else:
            self.vstate = self.criteria.reset(self.vstate)
        self.passes_done = 0
        self.window_id += 1
        flow_bw = dev_mets.pop("flow_bw", None) if dev_mets else None
        return dev_mets, flow_bw

    def boundary_metrics(self, batch, meta) -> Optional[Dict]:
        """Synchronous :meth:`boundary_outputs`: one host readback of the
        window's metrics (with ``flow_bw`` when the vis path wants it)."""
        rid = self.window_id
        dev_mets, flow_bw = self.boundary_outputs(batch, meta)
        if dev_mets is None:
            return None
        if flow_bw is not None:
            dev_mets["flow_bw"] = flow_bw
        with self.tm("mets_readback", rid=rid):
            return _to_host(dev_mets)

    # ----------------------------------------------------- vis readouts

    @torch.inference_mode()
    def vis_window_images(self) -> Dict[str, torch.Tensor]:
        """The window and dynamic visualization slots the protocol asks
        for, as tensors on the pipeline's device (the vis store copies
        them to the host)."""
        out = {}
        if not self.vis.on:
            return out
        want, red, vs = self.vis.want, self.reducers, self.vstate
        num = self.passes_done
        panels = (
            ("events", lambda: red["window_events"](vs)),
            ("iwe_fw", lambda: red["window_iwe_fw"](vs)),
            ("iwe_bw", lambda: red["window_iwe_bw"](vs)),
            ("flow", lambda: self.criteria.window_flow(vs, mode="forward")),
        )
        if self.passes > 1 and self.vis.dynamic:
            for name, image in panels:
                if want(name + "_dynamic"):
                    out[name + "_dynamic"] = image()
        if num > 1 and num == self.passes:
            for name, image in panels:
                if want(name + "_window"):
                    out[name + "_window"] = image()
        return out


def batch_stream(data, pipe: EvalPipeline):
    """Produce ``(batch, meta)`` with all loader state snapshotted at
    production time, so that a prefetch thread can run the stateful loader
    ahead of the device (the consumer loop never touches ``data``).

    ``ts_jump_reset`` is sticky on the lane until cleared; clearing it here
    makes the flag batch-scoped, the timing of the reference evaluator's
    consumer-side clear (reference ``eval_flow.py:75-88``).

    The sequence's rectification index (``data.remap_indices()``) goes to
    the pipeline's device once per sequence, as ``meta["remap_idx"]``, and
    on the u32 wire without coordinate flips its forward map
    (``data.rectify_values()``, batch 1) as ``meta["rect_map"]``. Windows
    are stacked on the consumer (:meth:`EvalPipeline.run_window`).
    """
    ridx = rect = None
    first = True
    while True:
        b = data.next_batch()
        if b["ts_jump_reset"].any():
            data.clear_ts_jump()
        if first or b["new_seq"].any():
            # a lane's rectification changes only when it rolls over
            r = data.remap_indices()
            ridx = (None if r is None
                    else torch.as_tensor(r, device=pipe.device))
            rect = None
            if pipe.u32_wire and not pipe.coord_flips:
                rv = data.rectify_values()
                if rv is not None and rv.shape[0] == 1:
                    rect = torch.as_tensor(rv[0], device=pipe.device)
            first = False
        meta = {
            "sequence": data.seq_name,
            "ts": data.last_proc_timestamp,
            "end_test": data.seq_num >= len(data.files),
            "bar_iters": data.get_iters(data.lanes[0]),
            "remap_idx": ridx,
            "rect_map": rect,
        }
        yield b, meta
        if meta["end_test"]:
            return
