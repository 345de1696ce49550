#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``taming_event_flow_tpu_torch``):
the counterpart of ``bench.py``, on one NVIDIA card.

    python3 bench_torch.py [--device cuda|cpu]

Headline: the training window step (RecEVFlowNet over P = 10 passes, the
iterative warp table, the IWE splats, backward and the clipped Adam
update) at the reference's training configuration, batch 8, 128x128,
8,192 events a pass and lane (reference ``README.md:147``), as warped
events per second in Mevents/s, as ``bench.py`` counts them.

Beside it, as in ``bench.py``: the batch-1 step, the DSEC-Flow inference
protocol (480x640, P = 10, bf16 forward) without and with the window's
metrics computed with it (AEE, RSAT, FWL, the u16 ``flow_bw``), the MVSEC
protocol (260x346, P = 1), and two gates that must pass: the kernels
against their plain versions (:func:`kernel_correctness_check`) and the
multi-device programs in a world of one (:func:`sharded_check`).

The step's share of the card: ``mfu`` is the FLOPs one B = 8 step
executes (``torch.utils.flop_counter``: its convolutions, forward and
backward) over its wall time, over the card's float32 peak, since the step
runs float32 with TF32 off, so its convolutions run outside the tensor
cores. ``bandwidth_util`` is the bytes every aten op of one step reads and
writes (views excluded) over its wall time, over the card's memory rate:
an unfused count, so an upper estimate of the step's DRAM traffic. The
four warp kernels launch through ctypes, which aten does not see, so
their bytes are not in it. The peaks come from :data:`CARD_PEAKS`; a card
not in it raises.

Prints ONE JSON line, ``bench.py``'s form::

    {"metric": ..., "value": N, "unit": "Mevents/s", "vs_baseline": N,
     "detail": {...}}

``vs_baseline`` is value / 100 Mevents/s, the target ``BASELINE.json``
names (the same denominator ``bench.py`` uses). Exits 1 when a gate fails.
Runs on the card unless ``--device cpu`` is given (the plain versions on
the CPU, where no time or share of a card is printed).
"""

from __future__ import annotations

import argparse
import json
import math
import socket
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from taming_event_flow_tpu_torch.ops import (
    LAUNCHES,
    kernel_build,
    reset_launches,
    set_deterministic,
    set_tf32,
)
from taming_event_flow_tpu_torch.ops.cuda_warp import (
    gather_bilinear_plain,
    splat_bilinear_plain,
)
from taming_event_flow_tpu_torch.utils.device import resolve_device

# NVIDIA's H100 datasheet (SXM5), dense rates without sparsity, at the
# 700 W limit; keyed by torch.cuda.get_device_name()
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_tflops": 66.9, "tf32_tflops": 494.7,
                              "bf16_tflops": 989.4, "hbm_gbps": 3350.0},
}

# main's iterations, bench.py's defaults
EVAL_ITERS = 30
TRAIN_ITERS = 10
TIMING_LOOPS = 3  # best-of loops of the eval protocols

# kernel_correctness_check: bench.py's (res, m, c) cases, its limit, and
# what one case launches on the card: the splat and the gather forward,
# the splat's backward (one fused gather) and the gather's (the d_maps
# splat and one fused gather)
KERNEL_CASES = [((128, 128), 4096, 4), ((480, 640), 4096, 2),
                ((200, 300), 1000, 2)]
KERNEL_RTOL = 1e-4
KERNEL_CASE_LAUNCHES = {"splat_bilinear": 2, "gather_bilinear": 1,
                        "gather_fused": 2, "row_gather": 0}

MODEL = {"name": "RecEVFlowNet"}
TRAIN_MODEL = {"name": "RecEVFlowNet", "final_w_scale": 0.01}
TRAIN_OPT = {"name": "Adam", "lr": 1e-5}
TRAIN_CLIP = 100.0
FLOW_SCALING = 32.0


def _sync(device):
    """Wait for the card (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _synthetic_events(rng, shape, res, device="cuda"):
    """``[..., N, 4]`` (ts, y, x, p) event tensor and ``[..., N, 2]``
    polarity mask on ``device``, from ``bench.py``'s numpy draws."""
    dev = resolve_device(device)
    ev = np.zeros(shape + (4,), np.float32)
    ev[..., 0] = rng.uniform(0, 1, shape)
    ev[..., 1] = rng.integers(0, res[0], shape)
    ev[..., 2] = rng.integers(0, res[1], shape)
    ev[..., 3] = rng.choice([-1.0, 1.0], shape)
    pol = np.stack([(ev[..., 3] > 0), (ev[..., 3] < 0)], -1)
    return (torch.from_numpy(ev).to(dev),
            torch.from_numpy(pol.astype(np.float32)).to(dev))


def card_peaks(name):
    """The :data:`CARD_PEAKS` entry of the card ``name``; raises for any
    other card: no peak is guessed."""
    if name not in CARD_PEAKS:
        raise KeyError(f"no peaks known for {name!r}: add the card's "
                       f"datasheet rates to CARD_PEAKS")
    return CARD_PEAKS[name]


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- programs


def eval_program(res, passes, n_events, full_vis=True, inference_dtype=None,
                 with_metrics=False, device="cuda", model=None):
    """The program :func:`bench_eval_protocol` times: the eval window step
    (``make_eval_window_step(reset_first=True)``, the eval CLI's recorded
    protocol path) of ``model`` (default: a full-width RecEVFlowNet from
    seed 0) and the Iterative validation at one protocol's shapes, with
    ``bench.py``'s inputs (zero count inputs, unit event masks, synthetic
    events and a normal GT flow from ``default_rng(0)``).
    ``with_metrics`` adds the window's RSAT, FWL, u16 ``flow_bw`` and AEE
    as ``extras``. Returns ``(run, vstate, carry)``, ``run(vstate, carry)
    -> (vstate, carry, metrics or None)`` one window."""
    from taming_event_flow_tpu_torch.metrics import (
        IterativeValidation,
        ValConfig,
        compute_aee,
    )
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.training import make_eval_window_step
    from taming_event_flow_tpu_torch.utils.visualization import flow_to_u16

    dev = resolve_device(device)
    if model is None:
        model = build_model(MODEL, num_bins=2, device=dev, seed=0)
    carry = model.init_state(1, res[0], res[1], device=dev)
    val = IterativeValidation(
        ValConfig(res=res, passes=passes, track_fw_prop=full_vis,
                  track_bw=full_vis),
        1, n_events, device=dev)

    extras = None
    if with_metrics:
        def extras(vstate, gtflow):
            rsat, fwl = val.rsat_fwl(vstate)
            flow_bw = val.window_flow(
                vstate, mode="backward", mask=False) * passes
            return {"rsat": rsat[0], "fwl": fwl,
                    "flow_bw": flow_to_u16(flow_bw),
                    "aee": compute_aee(flow_bw, gtflow)}

    step = make_eval_window_step(model, val, flow_scaling=FLOW_SCALING,
                                 reset_first=True,
                                 inference_dtype=inference_dtype,
                                 extras=extras)
    rng = np.random.default_rng(0)
    ev, pol = _synthetic_events(rng, (passes, 1, n_events), res, dev)
    xs = torch.zeros(passes, 1, res[0], res[1], 2, device=dev)
    emasks = torch.ones(passes, 1, res[0], res[1], 1, device=dev)
    gt = torch.from_numpy(
        rng.normal(size=(1, res[0], res[1], 2)).astype(np.float32)).to(dev)

    def run(vstate, carry):
        if with_metrics:
            vstate, carry, _, mets = step(vstate, carry, xs, ev, pol, emasks,
                                          gt)
            return vstate, carry, mets
        vstate, carry, _ = step(vstate, carry, xs, ev, pol, emasks)
        return vstate, carry, None

    return run, val.init(), carry


def bench_eval_protocol(res, passes, n_events, iters=EVAL_ITERS,
                        full_vis=True, inference_dtype=None,
                        with_metrics=False, device="cuda", model=None):
    """Model forward and Iterative validation update at an eval protocol's
    shapes, one window program a GT window (:func:`eval_program`), as
    ``bench.py`` times it: one warm-up window, then the best of
    ``TIMING_LOOPS`` loops of ``max(1, iters // passes)`` windows, each
    loop ended by a synchronise. The inputs lie on the card already, so no
    upload is timed. Covers DSEC (480x640, 10 passes) and MVSEC (260x346,
    1 pass).

    ``full_vis=False`` is the DSEC submission configuration
    (``configs/eval_dsec.yml`` stores only ``flow_bw``);
    ``inference_dtype`` (``torch.bfloat16`` there) casts the model's
    forward only, the warp and the metrics stay float32;
    ``with_metrics=True`` times the protocol's whole window, the metrics
    the eval CLI computes at its boundary included."""
    dev = resolve_device(device)
    run, vstate, carry = eval_program(res, passes, n_events, full_vis,
                                      inference_dtype, with_metrics, dev,
                                      model)
    vstate, carry, _ = run(vstate, carry)  # warm-up
    _sync(dev)
    n_windows = max(1, iters // passes)
    per_pass = math.inf
    for _ in range(TIMING_LOOPS):
        t0 = time.perf_counter()
        for _ in range(n_windows):
            vstate, carry, _ = run(vstate, carry)
        _sync(dev)
        per_pass = min(per_pass,
                       (time.perf_counter() - t0) / (n_windows * passes))
    out = {
        "pass_ms": round(per_pass * 1e3, 4),
        "gt_frames_per_s": round(1.0 / (passes * per_pass), 2),
        "model_passes_per_s": round(1.0 / per_pass, 1),
        "events_per_pass": n_events,
    }
    if with_metrics:
        out["window_ms"] = round(per_pass * passes * 1e3, 4)
        out["in_program_metrics"] = ["AEE", "RSAT", "FWL", "flow_bw_u16"]
    if inference_dtype is not None:
        out["inference_dtype"] = str(inference_dtype).replace("torch.", "")
    return out


def train_program(batch, res=(128, 128), passes=10, n_events=8192,
                  device="cuda", model=None):
    """The program :func:`bench_train` times: ``make_train_step`` of
    ``model`` (default: a full-width RecEVFlowNet with ``final_w_scale``
    0.01 from seed 0) with the Iterative loss ("two" mode, one scale), Adam
    at lr 1e-5 after the global-norm clip at 100 and flow scaling 32, as
    ``bench.py`` builds it, and ``bench.py``'s window: synthetic events and
    a normal net input from ``default_rng(0)``, every event on the
    gradient path. Returns ``(step, state, window)``."""
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.objectives import LossConfig
    from taming_event_flow_tpu_torch.training import (
        build_optimizer,
        init_train_state,
        make_train_step,
    )

    dev = resolve_device(device)
    if model is None:
        model = build_model(TRAIN_MODEL, num_bins=2, device=dev, seed=0)
    opt = build_optimizer(TRAIN_OPT, model.parameters(),
                          clip_grad=TRAIN_CLIP, device=dev)
    cfg = LossConfig(res=res, passes_loss=passes, scales_loss=1,
                     iterative_mode="two")
    step = make_train_step(model, opt, cfg, "Iterative",
                           flow_scaling=FLOW_SCALING, res=res)
    state = init_train_state(model, batch, res[0], res[1], device=dev)

    rng = np.random.default_rng(0)
    ev, pol = _synthetic_events(rng, (passes, batch, n_events), res, dev)
    window = {
        "net_input": torch.from_numpy(
            rng.normal(size=(passes, batch, res[0], res[1], 2))
            .astype(np.float32)).to(dev),
        "event_list": ev,
        "pol_mask": pol,
        "grad_mask": torch.ones(passes, batch, n_events, 1, device=dev),
    }
    return step, state, window


def warps_per_step(batch, passes, n_events):
    """Events warped a step, ``bench.py``'s count: P windows of N events,
    each warped through ~P flow maps (forward and backward), across 4
    flow scales."""
    return passes * n_events * batch * passes * 4


# ------------------------------------------------------------ the shares


def _is_view(func):
    """An aten op that returns a view of an input (no bytes move)."""
    if func.__name__.split(".")[0] in ("_unsafe_view", "_reshape_alias"):
        return True
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


# allocations that write nothing
_NO_WRITE = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided")


def _tensor_bytes(tree):
    from torch.utils._pytree import tree_flatten

    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Bytes every aten op reads (its tensor arguments) and writes (its
    tensor results), views and allocations without writes excluded."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (_is_view(func) or func.__name__.split(".")[0] in _NO_WRITE):
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def count_step_work(step, state, window):
    """The work of one call ``step(state, window)``, run once (it trains
    the model one step): ``(flops, bytes, state)``. FLOPs are what
    ``torch.utils.flop_counter`` counts, the convolutions and matrix
    products, forward and backward, as executed: PyTorch runs eagerly, so
    every pass is counted (``bench.py``'s ``unrolled_twin`` exists because
    XLA counts a ``while`` body once; it has no counterpart here). Bytes
    are :class:`_ByteCounter`'s: unfused, an upper estimate of DRAM
    traffic, without the warp kernels' (ctypes launches aten does not
    see)."""
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with flops, nbytes:
        state, _ = step(state, window)
    return flops.get_total_flops(), nbytes.bytes, state


def bench_train(batch, res=(128, 128), passes=10, n_events=8192,
                iters=TRAIN_ITERS, device="cuda", model=None):
    """The training window step (:func:`train_program`): its work counted
    on one step first (:func:`count_step_work`), then one warm-up step and
    ``iters`` steps timed, one synchronise at the end, as ``bench.py``
    times them. Returns ``(seconds a step, Mevents/s, flops, bytes)``."""
    dev = resolve_device(device)
    step, state, window = train_program(batch, res, passes, n_events, dev,
                                        model)
    flops, nbytes, state = count_step_work(step, state, window)
    state, loss = step(state, window)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, loss = step(state, window)
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    if not math.isfinite(float(loss)):
        raise RuntimeError(f"bench_train: loss {float(loss)}")
    return (dt, warps_per_step(batch, passes, n_events) / dt / 1e6, flops,
            nbytes)


# ---------------------------------------------------------------- gates


def _kernel_loss_and_grads(splat, gather, loc, vals, maps, res):
    """``sum(splat(loc, vals)^2) + sum(gather(maps, loc)^2)`` and its
    gradients in ``loc``, ``vals`` and ``maps``."""
    leaves = [t.detach().clone().requires_grad_() for t in (loc, vals, maps)]
    s = splat(leaves[0], leaves[1], res)
    g = gather(leaves[2], leaves[0])
    val = (s * s).sum() + (g * g).sum()
    return val.detach(), torch.autograd.grad(val, leaves)


def kernel_correctness_check(device="cuda"):
    """The warp kernels on ``device`` against their plain versions, at
    ``bench.py``'s three shape classes (a small map at C = 4, the DSEC map
    at C = 2, an odd shape): strictly fractional locations, some out of
    frame, and ``loss = sum splat^2 + sum gather^2``, its value and its
    gradients in the locations, values and maps within ``KERNEL_RTOL`` of
    the largest. On the card the differentiable splat and gather
    (``ops.splat_values``, ``ops.gather_values``) run the kernels, the
    fused gather and the ``d_maps`` splat through autograd, and each case
    must launch ``KERNEL_CASE_LAUNCHES``; the plain versions run under
    autograd beside them. On the CPU the wrappers take the plain versions
    and their backward the plain fused gather. Returns ``"ok"`` or the
    failure."""
    from taming_event_flow_tpu_torch.ops import gather_values, splat_values

    dev = resolve_device(device)
    try:
        rng = np.random.default_rng(1)
        for res, m, c in KERNEL_CASES:
            # strictly fractional coordinates: at an integer one the
            # kernels take jax's tie rule, autograd of the plain
            # versions another subgradient
            base_y = rng.integers(-2, res[0], (2, m))
            base_x = rng.integers(-2, res[1], (2, m))
            fy = rng.uniform(0.05, 0.95, (2, m))
            fx = rng.uniform(0.05, 0.95, (2, m))
            loc = torch.from_numpy(np.stack(
                [base_y + fy, base_x + fx], -1).astype(np.float32)).to(dev)
            vals = torch.from_numpy(
                rng.normal(size=(2, m, c)).astype(np.float32)).to(dev)
            maps = torch.from_numpy(rng.normal(
                size=(2, res[0], res[1], c)).astype(np.float32)).to(dev)
            reset_launches()
            vk, gk = _kernel_loss_and_grads(splat_values, gather_values, loc,
                                            vals, maps, res)
            _sync(dev)
            launched = dict(LAUNCHES)
            want = (KERNEL_CASE_LAUNCHES if dev.type == "cuda"
                    else dict.fromkeys(LAUNCHES, 0))
            if launched != want:
                return (f"{res} C={c}: launches {launched}, expected "
                        f"{want}")
            vp, gp = _kernel_loss_and_grads(splat_bilinear_plain,
                                            gather_bilinear_plain, loc, vals,
                                            maps, res)
            dv = float((vk - vp).abs() / (vp.abs() + 1e-9))
            dg = max(float((a - b).abs().max() / (b.abs().max() + 1e-9))
                     for a, b in zip(gk, gp))
            if not (dv <= KERNEL_RTOL and dg <= KERNEL_RTOL):
                return (f"{res} C={c}: numerical divergence dv={dv:.2e} "
                        f"dg={dg:.2e}")
        return "ok"
    except Exception as e:  # a build or launch failure fails the gate
        return f"{type(e).__name__}: {e}"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_check(device="cuda"):
    """The multi-device programs on ``device`` in a world of one process
    (NCCL on the card, gloo on the CPU; the group is torn down after), at
    ``bench.py``'s tiny shapes: the event-parallel train step on the
    ``(data=1, event=1)`` mesh (RecEVFlowNet at base 8, two encoders,
    32x32, P = 2, 256 events), then the event-sharded eval update and
    ``make_sharded_reducers`` (48x64, P = 2, 128 events). The loss, FWL
    and RSAT must be finite. Returns ``"ok"`` or the failure."""
    import torch.distributed as dist

    from taming_event_flow_tpu_torch.metrics import (
        IterativeValidation,
        ValConfig,
    )
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.objectives import LossConfig
    from taming_event_flow_tpu_torch.parallel import (
        init_distributed,
        make_eval_mesh,
        make_event_mesh,
        make_event_parallel_train_step,
        make_sharded_reducers,
        replicate,
        shard_eval_batch,
        shard_state_2d,
        shard_val_state,
        shard_window_2d,
    )
    from taming_event_flow_tpu_torch.training import (
        build_optimizer,
        init_train_state,
    )

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        return "a process group exists already: run in a world of its own"
    try:
        init_distributed({"coordinator": f"127.0.0.1:{_free_port()}",
                          "num_processes": 1, "process_id": 0}, device=dev)
        try:
            rng = np.random.default_rng(0)
            res, passes, n_ev, batch = (32, 32), 2, 256, 1
            model = build_model({"name": "RecEVFlowNet", "base_channels": 8,
                                 "num_encoders": 2}, num_bins=2, device=dev)
            opt = build_optimizer(TRAIN_OPT, model.parameters(),
                                  clip_grad=TRAIN_CLIP, device=dev)
            mesh = make_event_mesh(1, 1)
            replicate(model, opt)
            cfg = LossConfig(res=res, passes_loss=passes, scales_loss=1,
                             iterative_mode="two")
            step = make_event_parallel_train_step(
                model, opt, cfg, mesh, "Iterative",
                flow_scaling=FLOW_SCALING, res=res)
            ev, pol = _synthetic_events(rng, (passes, batch, n_ev), res, dev)
            window = {
                "net_input": torch.from_numpy(
                    rng.normal(size=(passes, batch, res[0], res[1], 2))
                    .astype(np.float32)).to(dev),
                "event_list": ev,
                "pol_mask": pol,
                "grad_mask": torch.ones(passes, batch, n_ev, 1, device=dev),
            }
            state = shard_state_2d(
                init_train_state(model, batch, *res, device=dev), mesh)
            _, loss = step(state, shard_window_2d(window, mesh))
            if not math.isfinite(float(loss)):
                return f"train step loss not finite: {float(loss)}"

            vres, vpasses, n = (48, 64), 2, 128
            val = IterativeValidation(ValConfig(res=vres, passes=vpasses),
                                      1, n, device=dev)
            emesh = make_eval_mesh(1)
            vstate = shard_val_state(val.init(), emesh)
            evv, polv = _synthetic_events(rng, (1, n), vres, dev)
            flow = torch.from_numpy(rng.normal(size=(1, *vres, 2)).astype(
                np.float32)).to(dev) * 2.0
            emask = torch.ones(1, *vres, 1, device=dev)
            for _ in range(vpasses):
                ev_s, pol_s = shard_eval_batch(evv, polv, emesh)
                vstate = val.update(vstate, flow, ev_s, pol_s, emask)
            red = make_sharded_reducers(val, emesh)
            fwl = float(red["fwl"](vstate))
            rsat = float(red["rsat"](vstate)[0])
            if not (math.isfinite(fwl) and math.isfinite(rsat)):
                return f"eval reducers not finite: fwl={fwl} rsat={rsat}"
            return "ok"
        finally:
            dist.destroy_process_group()
    except Exception as e:  # a failure in either program fails the gate
        return f"{type(e).__name__}: {e}"


def _launched(fn, *args, **kwargs):
    """``fn``'s result and the kernel launches it made."""
    reset_launches()
    out = fn(*args, **kwargs)
    return out, dict(LAUNCHES)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the card (default), or cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"

    # the training CLI's precision and determinism, before anything runs
    set_tf32(False)
    set_deterministic()
    if on_card:
        kernel_build.load()

    # gates: the kernels against their plain versions on this device, and
    # the multi-device programs in a world of one
    kernel_ok = kernel_correctness_check(dev)
    sharded_ok = sharded_check(dev)

    # eval protocols first, as bench.py runs them (before the training
    # steps' allocations). DSEC-Flow inference: the submission path
    # (flow_bw only, bf16 forward, configs/eval_dsec.yml), then its whole
    # window with the boundary metrics
    launches = {}
    dsec, launches["dsec_480x640_inference"] = _launched(
        bench_eval_protocol, (480, 640), passes=10, n_events=32768,
        full_vis=False, inference_dtype=torch.bfloat16, device=dev)
    dsec_proto, launches["dsec_480x640_protocol"] = _launched(
        bench_eval_protocol, (480, 640), passes=10, n_events=32768,
        full_vis=False, inference_dtype=torch.bfloat16, with_metrics=True,
        device=dev)
    mvsec, launches["mvsec_260x346_eval"] = _launched(
        bench_eval_protocol, (260, 346), passes=1, n_events=16384,
        device=dev)

    # headline: the reference's training configuration (batch 8)
    (dt8, mev8, flops8, bytes8), launches["train_b8"] = _launched(
        bench_train, batch=8, device=dev)
    (dt1, mev1, _, _), launches["train_b1"] = _launched(
        bench_train, batch=1, device=dev)

    if on_card:
        peaks = card_peaks(torch.cuda.get_device_name(dev))
        device = card_line()
        mfu = flops8 / dt8 / (peaks["fp32_tflops"] * 1e12)
        bandwidth_util = bytes8 / dt8 / (peaks["hbm_gbps"] * 1e9)
    else:
        peaks, device, mfu, bandwidth_util = None, "cpu", None, None

    guard = {
        "prev_round_mevents": None,  # the port has no floor until a
        "throughput_ok": None,       # benchmark sets one
        "kernel_correctness_ok": kernel_ok == "ok",
        "sharded_check_ok": sharded_ok == "ok",
    }
    guard["ok"] = guard["kernel_correctness_ok"] and guard["sharded_check_ok"]

    print(json.dumps({
        "metric": "iterative_cm_train_warp_throughput",
        "value": round(mev8, 3),
        "unit": "Mevents/s",
        "vs_baseline": round(mev8 / 100.0, 4),
        "detail": {
            "kernel_correctness": kernel_ok,
            "sharded_check": sharded_ok,
            "regression_guard": guard,
            "train_step_ms": round(dt8 * 1e3, 4),
            "mfu": None if mfu is None else round(mfu, 5),
            "bandwidth_util": (None if bandwidth_util is None
                               else round(bandwidth_util, 5)),
            "achieved_tflops": round(flops8 / dt8 / 1e12, 4),
            "achieved_gbps": round(bytes8 / dt8 / 1e9, 2),
            "step_work": {
                "flops": flops8, "bytes": bytes8,
                "flops_are": "convolutions forward and backward, as "
                             "executed (torch.utils.flop_counter); mfu "
                             "against the float32 peak, TF32 off",
                "bytes_are": "every aten op's tensor arguments and "
                             "results, views excluded, unfused: an upper "
                             "estimate of DRAM traffic, without the four "
                             "warp kernels' bytes",
            },
            "hw_peaks": peaks,
            "warps_per_step": warps_per_step(8, 10, 8192),
            "res": [128, 128],
            "passes": 10,
            "batch": 8,
            "events_per_window": 8192,
            "samples_per_s": round(8.0 / dt8, 3),
            "train_b1": {
                "train_step_ms": round(dt1 * 1e3, 4),
                "mevents_per_s": round(mev1, 3),
            },
            "device": device,
            "torch": torch.__version__,
            "dsec_480x640_inference": dsec,
            "dsec_480x640_protocol": dsec_proto,
            "mvsec_260x346_eval": mvsec,
            "kernel_launches": launches,
        },
    }))
    return 0 if guard["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
