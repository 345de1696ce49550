"""Driver of the training cells: the port's ``make_train_step`` fed as the
training CLI feeds it.

Set-up builds one step object (model, clipped Adam, loss) on the
benchmark's seeded weights, and drives it through the first three windows
of the pool with the window's own call and feed, keeping what the
comparison needs (the parameters before, each step's loss, the model's
flows in step 1, the parameters after step 3). The same object then runs the measured
window: each step places its window on the device as the CLI's
``window_place`` does (``torch.from_numpy(v).to(device)``), calls the step
and reads the loss back one step late. The rate counts the real events of
every step dispatched before the window's end, over the time until the
last of them finished.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import torch

from harness import events, trace as tr, work
from harness.trace import span
from harness.weights import make_weights

COMPARED_STEPS = 3
TRACED_STEPS = 3


def _place(host: Dict, device):
    with span("place"):
        return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def run(cfg: Dict, mix: Dict, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> Dict:
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.objectives import LossConfig
    from taming_event_flow_tpu_torch.ops import set_deterministic, set_tf32
    from taming_event_flow_tpu_torch.training import (
        build_optimizer,
        init_train_state,
        make_train_step,
    )
    from taming_event_flow_tpu_torch.training.window import stack_window

    mcfg, lcfg = cfg["model"], cfg["loss"]
    res = tuple(mix["resolution"])
    b, p = mix["batch"], mix["passes"]
    parts = {"imports": time.time() - t_start}
    set_tf32(False)
    set_deterministic()
    if device.type == "cuda":
        from taming_event_flow_tpu_torch.ops import kernel_build
        kernel_build.load()
    parts["kernels"] = time.time() - t_start

    pool = events.train_pool(mix, seed, stack_window)
    parts["traffic"] = time.time() - t_start
    weights = make_weights(mcfg, seed, device)
    model = build_model(dict(mcfg), num_bins=mcfg.get("num_bins", 2),
                        device=device)
    model.load_state_dict(weights)
    opt = build_optimizer(cfg["optimizer"], model.parameters(),
                          clip_grad=lcfg.get("clip_grad"), device=device)
    loss_cfg = LossConfig(res=res, passes_loss=p,
                          scales_loss=lcfg["scales_loss"],
                          iterative_mode=lcfg.get("iterative_mode", "two"),
                          round_ts=lcfg.get("round_ts", False))
    step = make_train_step(model, opt, loss_cfg, lcfg["warping"],
                           flow_scaling=lcfg["flow_scaling"], res=res)
    state = init_train_state(model, b, res[0], res[1], device=device)
    parts["build"] = time.time() - t_start

    # the compared steps, through the window's own call and feed
    losses, first_flows = [], []
    # the model's own outputs in step 1, read by a hook removed after it
    hook = model.register_forward_hook(
        lambda mod, args, out: first_flows.append(out[0].detach().clone()))
    for i in range(COMPARED_STEPS):
        state, loss = step(state, _place(pool[i].host, device))
        losses.append(loss)
        if i == 0:
            hook.remove()
    change = {n: p.detach() - weights[n] for n, p in
              model.named_parameters()}
    losses = [float(x) for x in losses]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start

    # the measured window
    i = COMPARED_STEPS
    host_ms, n_steps, n_events, failed = [], 0, 0, 0
    pending = None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while n_steps == 0 or time.perf_counter() < deadline:
        win = pool[i % len(pool)]
        dev_win = _place(win.host, device)
        th = time.perf_counter()
        with span("step"):
            state, loss = step(state, dev_win)
        host_ms.append((time.perf_counter() - th) * 1e3)
        if pending is not None:
            with span("loss_readback"):
                failed += not math.isfinite(float(pending))
        pending = loss
        n_steps += 1
        n_events += win.real
        i += 1
    failed += not math.isfinite(float(pending))
    window_s = time.perf_counter() - t0

    peak_name = "float32"
    parts["compared_steps"] = setup_s
    out = {
        "setup_parts": parts,
        "e2e": {"setup_s": setup_s,
                "train_events_per_s": n_events / window_s / 1e6},
        "attempted": n_steps, "failed": failed,
        "ctx": {"kind": "train", "cfg": cfg, "mix": mix,
                "step_host_ms": host_ms, "steps": n_steps,
                "window_s": window_s,
                "flops_per_step": p * work.pass_flops(mcfg, res[0], res[1],
                                                      b, train=True),
                "peak": peak_name},
    }

    if trace:
        counts = []

        def stretch():
            # the window's loop: the loss read back one step late
            nonlocal state, i
            prev = None
            for _ in range(TRACED_STEPS):
                win = pool[i % len(pool)]
                dev_win = _place(win.host, device)
                with span("step"):
                    state, loss = step(state, dev_win)
                if prev is not None:
                    with span("loss_readback"):
                        float(prev)
                prev = loss
                counts.append(win.counts)
                i += 1
            with span("loss_readback"):
                float(prev)

        out["ctx"]["trace"] = tr.traced(stretch, device)
        out["ctx"]["trace_counts"] = counts

    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)

    # free the program's state before the reference runs
    del model, opt, step, state, dev_win, loss, pending
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    from reference.train import run_steps

    windows = [{"event_list": torch.from_numpy(pool[k].events).to(device),
                "grad_mask": torch.from_numpy(pool[k].grad).to(device),
                "res": res} for k in range(COMPARED_STEPS)]
    ref_cfg = {"model": mcfg, "optimizer": cfg["optimizer"],
               "loss": dict(lcfg, passes_loss=p)}
    t_ref = time.perf_counter()
    ref = run_steps(weights, ref_cfg, windows)
    out["reference_s"] = time.perf_counter() - t_ref
    out["program"] = (losses, torch.stack(first_flows), change)
    out["reference"] = ref
    return out
