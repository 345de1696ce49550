"""Driver of the eval cells: the port's ``EvalPipeline`` fed as the eval
CLI's loop feeds it.

Set-up builds the pipeline on the benchmark's seeded weights, hands it the
sequence's rectification tables as the CLI hands it the loader's
(``cur_ridx``, ``cur_rect``), and warms it up on the first GT windows of
the sequence. The measured window then runs the sequence from its start,
over and over (a fresh carry at each start, as at a sequence rollover),
with the CLI's calls in its order: ``start_sequence`` at a rollover,
``ensure_bucket``, ``ingest``, and ``boundary_outputs`` at each GT window's
last pass. A reader thread copies each window's metrics and u16
``flow_bw`` to the host, as ``MetricsConsumer`` and the PNG writeback
thread do, and stamps when they arrived. The loop starts no GT window after
the window's end; the rate counts every started window's passes over the
time until the last window's outputs were on the host.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from typing import Dict

import numpy as np
import torch

from harness import events, trace as tr, work
from harness.trace import span
from harness.weights import make_weights

WARM_WINDOWS = 2
TRACED_SECONDS = 1.0


class Reader:
    """The readback thread: ``put(j, dev_mets, flow_bw)``; the host outputs
    land in ``results[j]`` with their arrival time."""

    def __init__(self, depth: int = 4):
        self.q = queue.Queue(maxsize=depth)
        self.results: Dict[int, Dict] = {}
        self.err = None
        self.thread = threading.Thread(target=self._drain, daemon=True,
                                       name="bench-readback")
        self.thread.start()

    def put(self, j, dev_mets, flow_bw):
        self.q.put((j, dev_mets, flow_bw))

    def _drain(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            j, dev_mets, flow_bw = item
            try:
                # as MetricsConsumer reads them: to the host, then a float
                host = {k: float(v.cpu().numpy())
                        for k, v in (dev_mets or {}).items()}
                if flow_bw is not None:
                    host["flow_bw"] = flow_bw.cpu().numpy()
                host["t_host"] = time.perf_counter()
                self.results[j] = host
            except Exception as e:  # re-raised by close()
                self.err = e

    def close(self):
        self.q.put(None)
        self.thread.join(timeout=600)
        if self.thread.is_alive():
            raise RuntimeError("the readback thread did not finish")
        if self.err is not None:
            raise self.err


def pipeline_config(mix: Dict, cfg: Dict) -> Dict:
    proto = mix["pipeline"]
    return {
        "loader": {"resolution": list(mix["resolution"]),
                   "n_events_pad": mix["slots"], "augment": []},
        "data": {"passes_loss": mix["passes"], "mode": "gtflow",
                 "voxel": None},
        "loss": {"flow_scaling": cfg["loss"]["flow_scaling"],
                 "round_ts": False},
        "metrics": dict(proto["metrics"]),
        "vis": dict(proto.get("vis") or {}),
        "runtime": dict(proto.get("runtime") or {}),
    }


def run(cfg: Dict, mix: Dict, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> Dict:
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.ops import set_deterministic, set_tf32
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    mcfg = cfg["model"]
    res = tuple(mix["resolution"])
    passes = mix["passes"]
    parts = {"imports": time.time() - t_start}
    set_tf32(False)
    set_deterministic()
    if device.type == "cuda":
        from taming_event_flow_tpu_torch.ops import kernel_build
        kernel_build.load()
    parts["kernels"] = time.time() - t_start

    seq = events.eval_sequence(mix, seed)
    parts["traffic"] = time.time() - t_start
    n_seq = len(seq.batches)
    weights = make_weights(mcfg, seed, device)
    model = build_model(dict(mcfg), num_bins=mcfg.get("num_bins", 2),
                        device=device)
    model.load_state_dict(weights)
    pipe = EvalPipeline(pipeline_config(mix, cfg), model, device=device)
    if seq.rect is not None:
        # what batch_stream hands the loop once per sequence
        pipe.cur_ridx = seq.rect.remap_idx
        if pipe.u32_wire:
            pipe.cur_rect = seq.rect.rect_map
    meta = {"sequence": "bench", "ts": seq.meta_ts}
    reader = Reader()
    parts["build"] = time.time() - t_start

    pos = 0  # pass position in the sequence
    j = 0  # GT window index since the window opened

    def feed_window(index):
        """One GT window: its passes through the CLI's calls."""
        nonlocal pos
        for _ in range(passes):
            if pos == 0:
                pipe.start_sequence()
            batch = seq.batches[pos]
            with span("ingest"):
                batch = pipe.ensure_bucket(batch)
                pipe.ingest(batch, meta)
            pos = (pos + 1) % n_seq
        with span("boundary"):
            dev_mets, flow_bw = pipe.boundary_outputs(batch, meta)
        if index is not None:
            reader.put(index, dev_mets, flow_bw)

    with torch.inference_mode():
        for _ in range(WARM_WINDOWS):
            feed_window(None)
        pos = 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.time() - t_start

        from taming_event_flow_tpu_torch.utils.diagnostics import \
            SectionTimer
        pipe.tm = SectionTimer()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while j == 0 or time.perf_counter() < deadline:
            feed_window(j)
            j += 1
        n_windows = j
        reader.close()
        results = dict(reader.results)
        t_end = max(r["t_host"] for r in results.values())
        window_s = t_end - t0
        sections = {k: (pipe.tm.totals[k], pipe.tm.counts[k])
                    for k in pipe.tm.totals}

        dtype = pipe.inference_dtype
        peak = "bfloat16" if dtype == torch.bfloat16 else "float32"
        parts["warm_windows"] = setup_s
        out = {
            "setup_parts": parts,
            "e2e": {"setup_s": setup_s,
                    "eval_ms_per_pass": window_s * 1e3 / (n_windows * passes)},
            "attempted": n_windows,
            "ctx": {"kind": "eval", "cfg": cfg, "mix": mix,
                    "windows": n_windows, "window_s": window_s,
                    "sections": sections,
                    "flops_per_window": passes * work.pass_flops(
                        mcfg, res[0], res[1], 1, train=False),
                    "peak": peak, "rectified": seq.rect is not None},
        }

        if trace:
            reader = Reader()
            traced_ids = []

            def stretch():
                nonlocal j
                t1 = time.perf_counter() + TRACED_SECONDS
                while not traced_ids or time.perf_counter() < t1:
                    feed_window(j)
                    traced_ids.append(j)
                    j += 1
                reader.close()

            out["ctx"]["trace"] = tr.traced(stretch, device)
            results.update(reader.results)
            out["ctx"]["trace_counts"] = [
                seq.counts[k % len(seq.gt)] for k in traced_ids]

    prog = [results.get(k) for k in range(j)]
    out["failed"] = sum(
        1 for k in range(n_windows)
        if prog[k] is None or not np.isfinite(
            [prog[k][m] for m in ("fwl", "rsat", "aee")]).all())
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)

    del pipe, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    from reference.eval import replay

    t_ref = time.perf_counter()
    ref = replay(seq, weights, mcfg, mix, cfg["loss"]["flow_scaling"],
                 device)
    out["reference_s"] = time.perf_counter() - t_ref
    out["program"] = prog
    out["reference"] = ref
    return out
