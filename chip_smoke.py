#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``taming_event_flow_tpu_torch``) on
one NVIDIA card.

    python3 chip_smoke.py [--seed S] [--profile DIR]

1. Prints the card (``nvidia-smi`` name and power limit), sets both TF32
   flags off, builds the CUDA kernels from
   ``taming_event_flow_tpu_torch/csrc``.
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   with its time by CUDA events, on the device (the profiler's time of all
   the call runs there) and on the host (issuing the call), the plain
   version's, a library yardstick's and its memory bound:
   the splat and the gather at the DSEC eval path's shapes, the fused
   dual-stencil gather at the training path's (the splat backward, C=4, at
   10 and 5 windows, and the gather backward, C=2, at 10 and 2 windows;
   both at 10 windows with a training step's shares of zero-valued rows),
   bitwise against its plain version there and at C = 1..4 with
   misaligned pointers, and the autograd Functions' location gradients
   running the fused kernel alone (no stack after it). The splat also on a
   clustered input (events on a few hundred edges, a generator of its
   own), each input beside the splat of its real rows alone (no zero rows
   at (0, 0)); the splat and the gather at C = 1..4 with aligned and
   misaligned pointers.
3. Eval phase: the DSEC eval protocol (``configs/eval_dsec.yml``: 480x640,
   P=10, 65,536-event bucket, FWL/RSAT/AEE, Iterative warping, bf16
   forward, flow_bw store) through ``EvalPipeline`` with a full-width
   RecEVFlowNet (seeded weights) on synthetic event windows; the launch
   counters must show the splat and the gather ran (and the backward kernel
   did not). Then one window in float32 on the card and on the CPU (plain
   versions), whose metrics must agree.
4. Row-gather phase: the row gather kernel against its plain version
   (bitwise) at the study's four shapes (``tools/bench_dma_gather.py``:
   307,200 x W rows, W = 8 and 128, 655,360 scattered and contiguous
   indices), at the rectified remap's (a DSEC window's P*H*W = 3,072,000
   rows of W = 2, a 1-based index with a zeroed border) and at W = 1, an
   unaligned W = 3 and a W = 4 table at a 4-byte offset (the scalar path),
   timed beside ``torch.index_select`` and its bytes bound.
5. Rectified DSEC phase: the eval protocol of step 3 on a synthetic
   rectified sequence (raw integer events, a radial forward map giving the
   list's fractional coordinates through ``data.rectify_events``, a
   backward mapping turned into ``remap_idx`` by ``data.remap_index`` with
   a zeroed border). Three windows derive the count input on the card from
   the raw coordinates and ``EvalPipeline.cur_ridx`` (the row gather must
   launch on each), three more ship the host-built input; on one window
   the derived input and event mask must equal the host-built ones
   bitwise, and float32 metrics card against CPU must agree. Then
   ``compute_pol_iwe`` on that window's flow under both rounding settings,
   card against CPU.
6. Training phase: the training configuration (``configs/train_flow.yml``
   at the batch ``bench.py`` measures: 128x128, P=10, B=8, 8,192 events per
   pass and lane, Iterative loss, Adam after clip 100) through
   ``make_train_step`` for one warm-up and five timed steps; losses must be
   finite and change, every parameter must get a finite non-zero gradient,
   and the launch counters must show 124 splats, 80 gathers and 116 fused
   gathers per step. One more step counts the fused gathers' zero-valued
   rows and their bytes bound; the profiled step (``--profile``) prints the
   fused gathers' and the stack/cat kernels' launches and device time.
   Then float32 on the card
   against the CPU at B=1 (:func:`card_vs_cpu`): the step's loss, the loss's
   flow gradient on identical flows and the model's parameter gradients
   for one flow cotangent must agree.
7. Prints the ``kernels`` JSON line and, last, ``{"ok": true, ...}``.

Any failure raises, and the script exits non-zero without the last line.
It imports nothing of JAX or the JAX package.
"""

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RES = (480, 640)
PASSES = 10
N_PAD = 65536
SPLAT_M = PASSES * N_PAD  # RSAT/FWL splat over the window's event slots
GATHER_M = PASSES * N_PAD + RES[0] * RES[1]  # last pass: events + grid
METRIC_RTOL, METRIC_ATOL = 2e-3, 2e-4  # the JAX suite's pipeline parity
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-5
N_WINDOWS = 3  # the first one warms cuDNN up and is not timed
CLUSTER_SEGMENTS = 300  # edges of the clustered splat input
DEVICE = "cuda"

# training slice: configs/train_flow.yml at bench.py's bench_train batch
TRAIN_RES = (128, 128)
TRAIN_B = 8
TRAIN_N = 8192  # events per pass and lane
TRAIN_STEPS = 5  # timed, after one warm-up step
# kernel launches per training step (10 passes, Iterative loss "two")
TRAIN_LAUNCHES = {"splat_bilinear": 124, "gather_bilinear": 80,
                  "gather_fused": 116, "row_gather": 0}
FUSED_M = PASSES * TRAIN_N  # the IWE splat at tref 5 holds all ten windows
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU, float32
TRAIN_GRAD_TOL = 1e-3  # max abs error per tensor, x that tensor's max |g|
JITTER = 1e-6  # relative move of weights or flows for the CPU's own gap
# rectified slice: a mild radial distortion and a border of out-of-source
# pixels, as cv2's remap leaves around a rectified DSEC frame
RECT_K = 0.05
RECT_BORDER = 4
TIMING_ROUNDS = 3  # more timed passes over the eval windows (per route)
TRAIN_LOSS = {"res": TRAIN_RES, "passes_loss": PASSES, "scales_loss": 1,
              "iterative_mode": "two", "round_ts": False}
TRAIN_OPT = {"name": "Adam", "lr": 1e-5}
TRAIN_CLIP = 100.0
FLOW_SCALING = 32.0

# configs/eval_dsec.yml, with the training config's loss keys
# (configs/train_flow.yml) that the eval CLI merges in
DSEC_CONFIG = {
    "data": {"mode": "gtflow", "window": 0.1, "passes_loss": PASSES,
             "voxel": None},
    "loader": {"resolution": list(RES), "augment": [],
               "n_events_pad": N_PAD},
    "loss": {"flow_scaling": 32, "round_ts": False},
    "metrics": {"warping": "Iterative", "name": ["FWL", "RSAT", "AEE"],
                "inference_dtype": "bfloat16"},
    "vis": {"enabled": False, "store": True, "bars": True,
            "mask_output": False, "dynamic": True, "show": ["flow_bw"]},
}
MODEL_CONFIG = {"name": "RecEVFlowNet", "final_w_scale": 0.01}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, reps=50, warmup=5):
    """Mean time per call of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after warm-up; inputs stay L2-warm between calls): the device's
    time, or the host's launch time where that is longer."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel=None):
    """Device time per call of ``fn`` from a profiler trace, all its
    kernels or those whose name holds ``kernel``
    (``tools/bench_dma_gather.py:device_ms``)."""
    from taming_event_flow_tpu_torch.tools import bench_dma_gather

    return bench_dma_gather.device_ms(fn, kernel=kernel)


def host_us(fn, reps=50):
    """Host time per call of ``fn`` in microseconds: the time to issue
    ``reps`` back-to-back calls without waiting for the device (for a
    kernel wrapper: its checks, output allocation and launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def bound_ms(nbytes, nops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def n_taps(loc, h, w, skip_integer):
    """In-frame taps the kernels work on for ``loc [M, 2]``; the splat
    (``skip_integer``) has one tap per axis at an integer coordinate."""
    import torch

    y, x = loc[..., 0], loc[..., 1]
    y0, x0 = torch.floor(y), torch.floor(x)
    every = torch.ones_like(y, dtype=torch.bool)
    second_y = (y != y0) if skip_integer else every
    second_x = (x != x0) if skip_integer else every
    total = 0
    for ty, has_y in ((y0, every), (y0 + 1, second_y)):
        ok_y = has_y & (ty >= 0) & (ty <= h - 1)
        for tx, has_x in ((x0, every), (x0 + 1, second_x)):
            total += int((ok_y & has_x & (tx >= 0) & (tx <= w - 1)).sum())
    return total


def window_points(rng, n_slots):
    """``n_slots`` event slots of ``N_PAD`` rows as the eval path holds
    them: ~40k real events per slot at fractional locations (some out of
    frame, a quarter exactly integer), then zero padding rows at (0, 0).
    Returns ``(loc [n_slots * N_PAD, 2] float32, real [n_slots * N_PAD])``.
    """
    h, w = RES
    loc = np.zeros((n_slots, N_PAD, 2), np.float32)
    real = np.zeros((n_slots, N_PAD), np.float32)
    for s in range(n_slots):
        n = int(N_PAD * rng.uniform(0.58, 0.64))  # 38k-42k of 65,536
        pts = np.stack([rng.uniform(-2, h + 1, n), rng.uniform(-2, w + 1, n)],
                       -1)
        pts[: n // 4] = np.round(pts[: n // 4])
        loc[s, :n] = pts
        real[s, :n] = 1.0
    return loc.reshape(-1, 2), real.reshape(-1)


# -------------------------------------------------------------- kernel phase


def clustered_points(rng, n_slots):
    """``window_points``' slot layout with the real events drawn within
    +-1 px of ``CLUSTER_SEGMENTS`` random line segments (10-120 px long,
    the same in every slot), as edges fill a real recording; the rest zero
    padding rows at (0, 0). Returns ``(loc, real)`` like ``window_points``.
    """
    h, w = RES
    a = np.stack([rng.uniform(0, h, CLUSTER_SEGMENTS),
                  rng.uniform(0, w, CLUSTER_SEGMENTS)], -1)
    d = rng.normal(size=(CLUSTER_SEGMENTS, 2))
    d *= (rng.uniform(10, 120, CLUSTER_SEGMENTS)
          / np.linalg.norm(d, axis=-1))[:, None]
    loc = np.zeros((n_slots, N_PAD, 2), np.float32)
    real = np.zeros((n_slots, N_PAD), np.float32)
    for s in range(n_slots):
        n = int(N_PAD * rng.uniform(0.58, 0.64))
        seg = rng.integers(0, CLUSTER_SEGMENTS, n)
        t = rng.uniform(0, 1, (n, 1))
        loc[s, :n] = a[seg] + t * d[seg] + rng.uniform(-1, 1, (n, 2))
        real[s, :n] = 1.0
    return loc.reshape(-1, 2), real.reshape(-1)


def splat_inputs(rng, loc, real):
    """The splat's values as RSAT's splat holds them, (pos, neg, pos*ts,
    neg*ts) per event and zero on the padding rows; ``(loc [1, M, 2],
    values [1, M, 4], real [M] bool)`` on the card."""
    import torch

    m = loc.shape[0]
    p = rng.choice([-1.0, 1.0], m)
    ts = rng.uniform(0, PASSES, m)
    vals = np.stack([p > 0, p < 0, (p > 0) * ts, (p < 0) * ts],
                    -1).astype(np.float32) * real[:, None]
    return (torch.from_numpy(loc)[None].to(DEVICE),
            torch.from_numpy(vals)[None].to(DEVICE),
            torch.from_numpy(real > 0).to(DEVICE))


def check_splat(name, loc, values, counts_exact):
    """The splat kernel against its plain version: within the kernel
    tolerance, and the count planes bitwise where ``counts_exact`` (integer
    locations: sums of 0/1 values, exact in any order)."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    out_k = cuda_warp.splat_bilinear(loc, values, RES)
    out_p = cuda_warp.splat_bilinear_plain(loc, values, RES)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    check(torch.allclose(out_k, out_p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
          f"splat kernel disagrees with its plain version ({name}): "
          f"max abs err {err}")
    if counts_exact:
        check(torch.equal(out_k[..., :2], out_p[..., :2]),
              f"splat count planes not exact ({name})")
    print(f"splat {name}: max_abs_err {err:.3e} "
          f"(max |out| {float(out_p.abs().max()):.3f})")
    return err


def splat_times(loc, values):
    """``(event ms, device ms of splat_kernel alone)`` on these inputs (the
    call's zero fill, the same for every input, left out)."""
    from taming_event_flow_tpu_torch.ops import cuda_warp

    call = lambda: cuda_warp.splat_bilinear(loc, values, RES)  # noqa: E731
    return time_ms(call), device_ms(call, "splat_kernel")


def check_widths(rng):
    """Splat and gather at C = 1..4 on small inputs, with pointers aligned
    (the vector instances for C = 2 and 4) and one float off (the scalar
    instances), against their plain versions."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    h, w, m = 37, 53, 5000
    for c in (1, 2, 3, 4):
        for off in (0, 1):
            def arr(shape, scale, low=0.0):
                n = int(np.prod(shape))
                buf = torch.from_numpy((rng.uniform(low, scale, n + off))
                                       .astype(np.float32)).to(DEVICE)
                return buf[off:].view(shape)

            loc = arr((2, m, 2), 1.0)
            loc.mul_(torch.tensor([h + 3.0, w + 3.0], device=DEVICE)).sub_(2)
            loc[:, : m // 3] = torch.round(loc[:, : m // 3])
            vals = arr((2, m, c), 1.0, -1.0)
            vals[:, -m // 4:] = 0.0
            maps = arr((2, h, w, c), 1.0, -1.0)
            got = cuda_warp.splat_bilinear(loc, vals, (h, w))
            ref = cuda_warp.splat_bilinear_plain(loc, vals, (h, w))
            g_got = cuda_warp.gather_bilinear(maps, loc)
            g_ref = cuda_warp.gather_bilinear_plain(maps, loc)
            torch.cuda.synchronize()
            check(torch.allclose(got, ref, rtol=KERNEL_RTOL,
                                 atol=KERNEL_ATOL),
                  f"splat C={c}, offset {4 * off} B: "
                  f"{float((got - ref).abs().max())}")
            check(torch.equal(g_got, g_ref),
                  f"gather C={c}, offset {4 * off} B: not bitwise")
    print("splat and gather at C = 1..4, aligned and 4 bytes off: agree "
          "with their plain versions (gather bitwise)")


def kernel_phase(rng, rng_cluster):
    import torch
    import torch.nn.functional as F

    from taming_event_flow_tpu_torch.ops import cuda_warp

    dev = torch.device(DEVICE)
    h, w = RES
    results = {}

    # splat inputs: the window's P event slots as the main path holds them
    # (window_points), with (pos, neg, pos*ts, neg*ts) per event like
    # RSAT's splat and zero values on the padding rows
    loc_f, values, real = splat_inputs(rng, *window_points(rng, PASSES))
    check(loc_f.shape[1] == SPLAT_M, "splat shape")
    loc_r = torch.round(loc_f)
    splat_err = max(check_splat("rounded", loc_r, values, True),
                    check_splat("fractional", loc_f, values, False))
    # the same points clustered on edges (a generator of their own)
    c_loc, c_vals, c_real = splat_inputs(
        rng_cluster, *clustered_points(rng_cluster, PASSES))
    c_loc_r = torch.round(c_loc)
    splat_err = max(splat_err,
                    check_splat("clustered rounded", c_loc_r, c_vals, True),
                    check_splat("clustered fractional", c_loc, c_vals, False))
    check_widths(rng_cluster)

    # the main path's splat: rounded locations (RSAT/FWL)
    taps = n_taps(loc_r[0], h, w, skip_integer=True)
    nbytes = (loc_r.numel() + values.numel() + h * w * 4) * 4
    nops = taps * (1 + 2 * 4)  # weight product + C (mul, atomic add)
    b_ms, b_by = bound_ms(nbytes, nops)
    flat_idx, wv = [], []
    for idx, weight in cuda_warp._taps(loc_r, h, w):
        flat_idx.append(idx.reshape(-1))
        wv.append((values * weight[..., None]).reshape(-1, 4))
    flat_idx, wv = torch.cat(flat_idx), torch.cat(wv)

    def lib_splat():
        return torch.zeros(h * w, 4, device=dev).index_put_(
            (flat_idx,), wv, accumulate=True)

    call = lambda: cuda_warp.splat_bilinear(loc_r, values, RES)  # noqa: E731
    ms, kernel_ms = splat_times(loc_r, values)
    results["splat_bilinear"] = {
        "name": "splat_bilinear",
        "route": "cuda",
        "source": "taming_event_flow_tpu_torch/csrc/warp_kernels.cu",
        "replaces": "taming_event_flow_tpu/ops/pallas_warp.py:128",
        "max_abs_err": splat_err,
        "ms": ms,
        # all the call runs on the device: the output's zero fill and the
        # kernel, like the library call's torch.zeros and index_put_
        "device_ms": device_ms(call),
        "kernel_only_device_ms": kernel_ms,
        "host_us": host_us(call),
        "plain_ms": time_ms(
            lambda: cuda_warp.splat_bilinear_plain(loc_r, values, RES),
            reps=10),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": time_ms(lib_splat),
        "library_device_ms": device_ms(lib_splat),
        "library_host_us": host_us(lib_splat, reps=10),
    }
    print(f"splat call on the device {results['splat_bilinear']['device_ms']:.5f}"
          f" ms, of which splat_kernel {kernel_ms:.5f} ms")
    # the other inputs, each beside the splat of its real rows alone (the
    # contention-free reference: no zero rows at (0, 0))
    variants = {}
    for name, lc, vl, keep in (
            ("rounded", loc_r, values, real),
            ("fractional", loc_f, values, real),
            ("clustered rounded", c_loc_r, c_vals, c_real),
            ("clustered fractional", c_loc, c_vals, c_real)):
        variants[name] = {
            "all rows": (ms, kernel_ms)
            if name == "rounded" else splat_times(lc, vl),
            "real rows": splat_times(lc[:, keep].contiguous(),
                                     vl[:, keep].contiguous())}
        print(f"splat {name} (event ms, splat_kernel device ms): "
              f"{variants[name]['all rows']} over all {lc.shape[1]} rows, "
              f"{variants[name]['real rows']} over the "
              f"{int(keep.sum())} real rows alone")
    results["splat_bilinear"]["inputs"] = variants

    # gather inputs: a flow map and the last pass's lookup points, P event
    # slots (window_points) followed by the H*W pixel grid
    maps = torch.from_numpy(
        rng.normal(size=(1, h, w, 2)).astype(np.float32) * 4).to(dev)
    grid_pts = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                                    indexing="ij"), -1).reshape(-1, 2)
    gl = np.concatenate([window_points(rng, PASSES)[0],
                         grid_pts.astype(np.float32)])
    mg = gl.shape[0]
    check(mg == GATHER_M, "gather shape")
    gloc = torch.from_numpy(gl)[None].to(dev)
    out_k = cuda_warp.gather_bilinear(maps, gloc)
    out_p = cuda_warp.gather_bilinear_plain(maps, gloc)
    torch.cuda.synchronize()
    gerr = float((out_k - out_p).abs().max())
    check(torch.equal(out_k, out_p),
          f"gather kernel is not bitwise its plain version: {gerr}")
    grid = torch.stack([2 * gloc[..., 1] / (w - 1) - 1,
                        2 * gloc[..., 0] / (h - 1) - 1], -1)[:, None]
    maps_nchw = maps.permute(0, 3, 1, 2).contiguous()

    def lib_gather():
        return F.grid_sample(maps_nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    lib_err = float((lib_gather()[:, :, 0].transpose(1, 2) - out_p)
                    .abs().max())
    print(f"gather: max_abs_err {gerr:.3e}; grid_sample yardstick differs "
          f"by {lib_err:.3e} (coordinate normalisation)")
    taps = n_taps(gloc[0], h, w, skip_integer=False)
    nbytes = (gloc.numel() + maps.numel() + mg * 2) * 4
    b_ms, b_by = bound_ms(nbytes, taps * (1 + 2 * 2))
    call = lambda: cuda_warp.gather_bilinear(maps, gloc)  # noqa: E731
    results["gather_bilinear"] = {
        "name": "gather_bilinear",
        "route": "cuda",
        "source": "taming_event_flow_tpu_torch/csrc/warp_kernels.cu",
        "replaces": "taming_event_flow_tpu/ops/pallas_warp.py:206",
        "max_abs_err": gerr,
        "ms": time_ms(call),
        "device_ms": device_ms(call),
        "host_us": host_us(call),
        "plain_ms": time_ms(
            lambda: cuda_warp.gather_bilinear_plain(maps, gloc), reps=10),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": time_ms(lib_gather),
        "library_device_ms": device_ms(lib_gather),
        "library_host_us": host_us(lib_gather),
    }
    return results


def fused_points(rng, batch, h, w):
    """``[B, FUSED_M, 2]`` lookup points as the training backward meets
    them: fractional, some out of frame, and the first quarter of each lane
    at exactly integer coordinates (where the dual stencil spans three taps
    per axis)."""
    loc = np.stack([rng.uniform(-2, h + 1, (batch, FUSED_M)),
                    rng.uniform(-2, w + 1, (batch, FUSED_M))],
                   -1).astype(np.float32)
    loc[:, : FUSED_M // 4] = np.round(loc[:, : FUSED_M // 4])
    return loc


def n_dual_taps(loc, h, w):
    """``(taps, y taps)`` the fused kernel reads for ``loc [..., 2]``: per
    axis, the in-frame taps of floor and floor+1, and of floor-1 too at an
    exactly integer coordinate."""
    import torch

    def axis(c, size):
        c0 = torch.floor(c)
        count = torch.zeros_like(c)
        for k in (-1, 0, 1):
            t = c0 + k
            ok = (t >= 0) & (t <= size - 1)
            count += (ok & (c == c0)) if k == -1 else ok
        return count

    ny, nx = axis(loc[..., 0], h), axis(loc[..., 1], w)
    return int((ny * nx).sum()), int(ny.sum())


def bits(t):
    """The float32 tensor's bit patterns (int32): equal only where every
    bit is, the sign of a zero included."""
    import torch

    return t.contiguous().view(torch.int32)


def check_fused_bitwise(tag, maps, loc, vals, with_gv):
    """The fused kernel against its plain version, every bit of gv (where
    asked) and d_loc (dy, dx); returns the max abs error."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    got = cuda_warp.gather_fused_dloc(maps, loc, vals, with_gv=with_gv)
    gv, dy, dx = cuda_warp.gather_fused_plain(maps, loc, vals,
                                              with_gv=with_gv)
    ref = (gv, torch.stack([dy, dx], -1))
    torch.cuda.synchronize()
    pairs = [(a, b) for a, b in zip(got, ref) if b is not None]
    check(got[0] is None if not with_gv else got[0] is not None,
          f"fused gather ({tag}): gv returned where not asked, or not")
    e = max(float((a - b).abs().max()) for a, b in pairs)
    check(all(torch.equal(bits(a), bits(b)) for a, b in pairs),
          f"fused gather is not bitwise its plain version ({tag}, with_gv "
          f"{with_gv}): max abs err {e}")
    return e


def check_fused_widths(rng):
    """The fused gather at C = 1..4 on small inputs with pointers aligned
    (the vector instances for C = 2 and 4) and one float off (the scalar
    instances), integer coordinates on y, on x and on both, zero-valued
    rows at (0, 0), with and without gather values: bitwise."""
    import torch

    h, w, m = 37, 53, 5000
    for c in (1, 2, 3, 4):
        for off in (0, 1):
            def arr(shape, low, high):
                n = int(np.prod(shape))
                buf = torch.from_numpy(rng.uniform(low, high, n + off)
                                       .astype(np.float32)).to(DEVICE)
                return buf[off:].view(shape)

            loc = arr((2, m, 2), 0.0, 1.0)
            loc.mul_(torch.tensor([h + 3.0, w + 3.0], device=DEVICE)).sub_(2)
            loc[:, : m // 4] = torch.round(loc[:, : m // 4])
            loc[:, m // 4: m // 3, 0] = torch.round(loc[:, m // 4: m // 3, 0])
            loc[:, m // 3: m // 2, 1] = torch.round(loc[:, m // 3: m // 2, 1])
            vals = arr((2, m, c), -1.0, 1.0)
            vals[:, -m // 8:] = 0.0
            loc[:, -m // 8:] = 0.0
            maps = arr((2, h, w, c), -1.0, 1.0)
            for with_gv in (True, False):
                check_fused_bitwise(f"C={c}, offset {4 * off} B", maps, loc,
                                    vals, with_gv)
    print("fused gather at C = 1..4, aligned and 4 bytes off, integer "
          "coordinates and zero-valued rows, with and without gather "
          "values: bitwise its plain version")


def check_backward_kernels(maps4, maps2, loc, vals4, cot2):
    """The two Functions' location gradients at the training shapes run
    the fused gather and nothing else on the device: no stack after it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from taming_event_flow_tpu_torch.ops import cuda_warp

    lc = loc.clone().requires_grad_()
    splat = cuda_warp.SplatBilinearFn.apply(lc, vals4, TRAIN_RES)
    gather = cuda_warp.GatherBilinearFn.apply(maps2, lc)
    for tag, out, g in (("SplatBilinearFn", splat, maps4),
                        ("GatherBilinearFn", gather, cot2)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, lc, g, retain_graph=True)
            torch.cuda.synchronize()
        names = [a.key for a in prof.key_averages()
                 if a.device_type == DeviceType.CUDA
                 and not a.is_user_annotation and a.self_device_time_total]
        check(names and all("gather_fused_kernel" in n for n in names),
              f"{tag}.backward runs more than the fused gather: {names}")
        print(f"{tag}.backward (location gradient) on the device: {names}")


def fused_case(tag, maps, loc, vals, plain=False):
    """Hold the fused gather bitwise to its plain version with and
    without gather values, then time it as the training path calls it
    (``gather_fused_dloc`` without gather values): event, device (all the
    call runs there, and the kernel alone) and host time beside its
    bound."""
    from taming_event_flow_tpu_torch.ops import cuda_warp

    b, h, w, c = maps.shape
    n = loc.shape[0] * loc.shape[1]
    e = max(check_fused_bitwise(tag, maps, loc, vals, True),
            check_fused_bitwise(tag, maps, loc, vals, False))
    # without gather values a row whose values are all zero reads no taps
    work = ~(vals == 0).all(-1)
    taps, ytaps = n_dual_taps(loc[work], h, w)
    nbytes = (loc.numel() + vals.numel() + maps.numel() + 2 * n) * 4
    nops = taps * c * 4 + ytaps * c * 6 + n * c * 4
    b_ms, b_by = bound_ms(nbytes, nops)
    call = lambda: cuda_warp.gather_fused_dloc(  # noqa: E731
        maps, loc, vals, with_gv=False)
    case = {"max_abs_err": e, "B": b, "M": loc.shape[1], "C": c,
            "zero_rows": int(n - int(work.sum())),
            "ms": time_ms(call), "device_ms": device_ms(call),
            "kernel_only_device_ms": device_ms(call, "gather_fused_kernel"),
            "host_us": host_us(call), "bound_ms": b_ms, "bound_by": b_by}
    if plain:
        case["plain_ms"] = time_ms(
            lambda: cuda_warp.gather_fused_dloc_plain(maps, loc, vals,
                                                      with_gv=False),
            reps=10)
    return case


def fused_phase(rng, seed):
    """The fused dual-stencil gather at the training path's shapes: the
    splat backward (the C=4 IWE cotangent image, the splat's values) and
    the gather backward (the C=2 flow map, the gather's cotangent), both
    without gather values, as the path calls them, at their largest launch
    (10 windows) beside the library yardstick; then at 5 (C=4) and 2 (C=2,
    the step's smallest launch) windows and at 10 windows with the step's
    shares of zero-valued rows, some at (0, 0) (``tools/
    bench_fused_shapes``' inputs, a generator of their own); every case
    bitwise its plain version, and at C = 1..4 with misaligned pointers;
    the two Functions' location gradients run nothing but the kernel."""
    import torch
    import torch.nn.functional as F

    from taming_event_flow_tpu_torch.ops import cuda_warp
    from taming_event_flow_tpu_torch.tools import bench_fused_shapes as shapes

    dev = torch.device(DEVICE)
    h, w = TRAIN_RES
    loc = torch.from_numpy(fused_points(rng, TRAIN_B, h, w)).to(dev)
    n = loc.shape[0] * loc.shape[1]
    q = FUSED_M // 4  # the integer points; the yardstick skips them
    grid = torch.stack([2 * loc[:, q:, 1] / (w - 1) - 1,
                        2 * loc[:, q:, 0] / (h - 1) - 1], -1)[:, None]
    # grid_sample's coordinate normalisation moves a point by ~1e-5 px: one
    # within that of an integer may land on the other side, where the
    # derivative stencil jumps, so the agreement is read on the others
    frac = loc[:, q:] - torch.floor(loc[:, q:])
    clear = ((frac > 1e-3) & (frac < 1 - 1e-3)).all(-1)
    cases, err, inputs = {}, 0.0, {}
    for tag, c in (("splat_backward", 4), ("gather_backward", 2)):
        maps = torch.from_numpy(rng.normal(size=(TRAIN_B, h, w, c))
                                .astype(np.float32)).to(dev)
        vals = torch.from_numpy(rng.normal(size=(TRAIN_B, FUSED_M, c))
                                .astype(np.float32)).to(dev)
        inputs[c] = (maps, vals)
        ref = cuda_warp.gather_fused_plain(maps, loc, vals)
        cases[tag] = fused_case(tag, maps, loc, vals, plain=True)
        err = max(err, cases[tag].pop("max_abs_err"))

        maps_nchw = maps.permute(0, 3, 1, 2).contiguous()
        g_out = vals[:, q:].permute(0, 2, 1)[:, :, None].contiguous()

        def lib():
            # two calls the port never makes: grid_sample forward (gv) and
            # its grid gradient (the location gradient x (size - 1) / 2)
            out = F.grid_sample(maps_nchw, grid, mode="bilinear",
                                padding_mode="zeros", align_corners=True)
            _, d_grid = torch.ops.aten.grid_sampler_2d_backward(
                g_out, maps_nchw, grid, 0, 0, True, [False, True])
            return out, d_grid

        out, d_grid = lib()
        lib_err = max(
            float((out[:, :, 0].transpose(1, 2) - ref[0][:, q:])[clear]
                  .abs().max()),
            float((d_grid[:, 0, :, 0] * (2 / (w - 1)) - ref[2][:, q:])[clear]
                  .abs().max()),
            float((d_grid[:, 0, :, 1] * (2 / (h - 1)) - ref[1][:, q:])[clear]
                  .abs().max()))
        cases[tag].update(library_ms=time_ms(lib),
                          library_device_ms=device_ms(lib),
                          library_host_us=host_us(lib))
        print(f"gather_fused {tag} (B={TRAIN_B}, M={FUSED_M}, C={c}): "
              f"bitwise; {cases[tag]}; grid_sample + "
              f"grid_sampler_2d_backward on the {n - TRAIN_B * q} "
              f"non-integer points ({int(clear.sum())} more than 1e-3 px "
              f"from an integer: differ by {lib_err:.3e})")

    check_backward_kernels(inputs[4][0], inputs[2][0], loc, inputs[4][1],
                           inputs[2][1])
    check_fused_widths(np.random.default_rng([seed, 3]))
    more = {}
    for i, (tag, (c, m, zero)) in enumerate(shapes.CASES.items()):
        if (m == FUSED_M and not zero[0]) or zero[0] == 1.0:
            continue  # the two cases above; the stream alone is the study's
        maps, lc, vals = shapes.fused_inputs([seed, 4, i], c, m, zero)
        more[tag] = fused_case(tag, maps, lc, vals)
        err = max(err, more[tag].pop("max_abs_err"))
        print(f"gather_fused {tag} (B={TRAIN_B}, M={m}, C={c}, "
              f"{more[tag]['zero_rows']} zero-valued rows, "
              f"{int((lc == 0).all(-1).sum())} rows at (0, 0)): "
              f"bitwise; {more[tag]}")

    entry = {
        "name": "gather_fused",
        "route": "cuda",
        "source": "taming_event_flow_tpu_torch/csrc/warp_kernels.cu",
        "replaces": "taming_event_flow_tpu/ops/pallas_warp.py:281",
        "max_abs_err": err,
        **cases["splat_backward"],
        "gather_backward": cases["gather_backward"],
        "shapes": more,
    }
    return {"gather_fused": entry}


def radial_maps():
    """A mild radial distortion at ``RES``: the forward map in the file's
    layout (``[y_raw, x_raw] = (x_rect, y_rect)``) and an approximate
    backward mapping (``[y_rect, x_rect] = (x_raw, y_raw)``), float32."""
    h, w = RES
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cy, cx = (h - 1) / 2, (w - 1) / 2
    r2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / (cy ** 2 + cx ** 2)
    fwd = np.stack([cx + (xx - cx) * (1 + RECT_K * r2),
                    cy + (yy - cy) * (1 + RECT_K * r2)], -1)
    bwd = np.stack([cx + (xx - cx) * (1 - RECT_K * r2),
                    cy + (yy - cy) * (1 - RECT_K * r2)], -1)
    return fwd.astype(np.float32), bwd.astype(np.float32)


def rectified_index(bwd):
    """``remap_idx [H, W]`` of the backward mapping (``data.remap_index``)
    with a zeroed border: the out-of-source pixels cv2 leaves."""
    from taming_event_flow_tpu_torch.data import remap_index

    ridx = remap_index(bwd, RES)
    b = RECT_BORDER
    ridx[:b] = ridx[-b:] = 0
    ridx[:, :b] = ridx[:, -b:] = 0
    return ridx


def row_gather_phase(rng):
    """The row gather at the study's shapes (the twin's inputs and
    measurement), at the rectified remap's (the count rows of a DSEC window
    and the index ``derive_count_input`` builds from a remap index) and at
    widths that take the scalar path; bitwise against its plain version."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp
    from taming_event_flow_tpu_torch.tools import bench_dma_gather as study

    dev = torch.device(DEVICE)
    err = 0.0
    studies = {}
    for w in study.STUDY_WIDTHS:
        table, streams = study.study_inputs(study.STUDY_ROWS, w,
                                            study.STUDY_M, device=dev)
        for stream, idx in streams.items():
            r = study.measure(table, idx)
            err = max(err, r.pop("max_abs_err"))
            studies[f"W{w}_{stream}"] = r
            rate = {k: study.STUDY_M / (r[k] * 1e-3) / 1e6
                    for k in ("ms", "library_ms", "plain_ms", "device_ms",
                              "library_device_ms") if r[k] > 0}
            print(f"row_gather study W={w} {stream}: {r}; M rows/s {rate}")
        del table, streams

    # the remap: P lanes of H*W count rows plus one zero row each, gathered
    # by the 1-based index (0 -> the zero row), as derive_count_input does
    h, w = RES
    rows = h * w + 1
    ridx = torch.from_numpy(rectified_index(radial_maps()[1])).to(dev)
    counts = rng.integers(0, 4, (PASSES, rows, 2)).astype(np.float32)
    counts[:, -1] = 0.0
    table = torch.from_numpy(counts.reshape(-1, 2)).to(dev)
    src = torch.where(ridx > 0, ridx - 1, h * w).reshape(1, -1).to(
        torch.int32)
    idx = (src + torch.arange(PASSES, dtype=torch.int32,
                              device=dev)[:, None] * rows).reshape(-1)
    check(idx.shape[0] == PASSES * h * w, "remap shape")
    remap = study.measure(table, idx)
    err = max(err, remap.pop("max_abs_err"))
    remap["host_us"] = host_us(lambda: cuda_warp.row_gather(table, idx))
    remap["library_host_us"] = host_us(
        lambda: torch.index_select(table, 0, idx))
    print(f"row_gather remap (M={idx.shape[0]}, W=2): {remap}")

    # the scalar path: W = 1, an odd W, and a table off 16-byte alignment
    for r_, w_, m_, off in ((100000, 1, 200000, 0), (100000, 3, 200001, 0),
                            (100000, 4, 200000, 1)):
        buf = torch.from_numpy(rng.normal(size=r_ * w_ + off)
                               .astype(np.float32)).to(dev)
        tab = buf[off:].view(r_, w_)
        ix = torch.from_numpy(rng.integers(-3, r_ + 3, m_)
                              .astype(np.int32)).to(dev)
        got = cuda_warp.row_gather(tab, ix)
        ref = cuda_warp.row_gather_plain(tab, ix)
        torch.cuda.synchronize()
        check(torch.equal(got, ref),
              f"row_gather disagrees with its plain version at W={w_}, "
              f"offset {off * 4} B")
        print(f"row_gather W={w_} (table at a {off * 4}-byte offset, some "
              f"indices out of range): bitwise equal")
    entry = {
        "name": "row_gather",
        "route": "cuda",
        "source": "taming_event_flow_tpu_torch/csrc/warp_kernels.cu",
        "replaces": "scripts/bench_dma_gather.py:54",
        "max_abs_err": err,
        **remap,
        "bound_by": "bytes",
        "study": studies,
    }
    return {"row_gather": entry}


# --------------------------------------------------------------- slice phase


def synthetic_windows(rng, n_windows):
    """DSEC-shaped GT windows: P passes of ~40k real events each (integer
    pixel coordinates, sorted window-normalised ts, +-1 polarity), plus a
    random GT flow map per window."""
    h, w = RES
    windows = []
    for _ in range(n_windows):
        passes = []
        for _ in range(PASSES):
            n = int(rng.integers(38000, 42000))
            ev = np.zeros((1, n, 4), np.float32)
            ev[0, :, 0] = np.sort(rng.uniform(0, 1, n))
            ev[0, 0, 0] = 0.0
            ev[0, :, 1] = rng.integers(0, h, n)
            ev[0, :, 2] = rng.integers(0, w, n)
            ev[0, :, 3] = rng.choice([-1.0, 1.0], n)
            passes.append({"event_list": ev})
        gt = rng.normal(size=(1, h, w, 2)).astype(np.float32) * 4
        passes[-1]["gtflow"] = gt
        windows.append(passes)
    return windows


def run_windows(pipe, windows, flows=None):
    """Drive the pipeline as the eval loop does; returns per-window host
    metrics and the seconds per window (synchronised). Each window's last
    flow is appended to ``flows`` when given."""
    import torch

    mets, secs = [], []
    for passes in windows:
        t0 = time.perf_counter()
        for b in passes:
            b = pipe.ensure_bucket(b)
            flow = pipe.ingest(b, {"ts": 0.0})
        if flows is not None:
            flows.append(flow)
        check(pipe.passes_done == pipe.passes, "window did not complete")
        m = pipe.boundary_metrics(passes[-1], {"ts": 0.0})
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mets.append(m)
    return mets, secs


def check_metrics(m, tag):
    for k in ("fwl", "rsat", "aee"):
        check(np.isfinite(float(m[k])), f"{tag}: {k} not finite")
    fb = m["flow_bw"]
    check(fb.shape == (1, RES[0], RES[1], 2) and fb.dtype == np.uint16,
          f"{tag}: flow_bw {fb.shape} {fb.dtype}")


def slice_phase(rng, n_windows, profile_dir):
    import torch

    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    windows = synthetic_windows(rng, n_windows)
    model = build_model(MODEL_CONFIG, num_bins=2, device=DEVICE, seed=0)
    pipe = EvalPipeline(DSEC_CONFIG, model, device=DEVICE)
    check(pipe.windowed and pipe.use_extras, "DSEC config must run windowed")

    reset_launches()
    mets, secs = run_windows(pipe, windows)
    launches = dict(LAUNCHES)
    # per window: the RSAT/FWL splat pair and one gather per pass
    expect = {"splat_bilinear": 2 * n_windows,
              "gather_bilinear": PASSES * n_windows, "gather_fused": 0,
              "row_gather": 0}
    check(launches == expect,
          f"eval path launches {launches}, expected {expect}")
    for i, m in enumerate(mets):
        check_metrics(m, f"window {i}")
        print(f"bf16 window {i}: {secs[i] * 1e3:.2f} ms  FWL "
              f"{float(m['fwl']):.6f}  RSAT {float(m['rsat']):.6f}  AEE "
              f"{float(m['aee']):.6f}")
    warm = secs[1:] if len(secs) > 1 else secs
    # the host's pace varies window to window: time more passes over the
    # same windows
    for _ in range(TIMING_ROUNDS):
        warm += run_windows(pipe, windows)[1]
    ms_pass = float(np.mean(warm)) / PASSES * 1e3
    print(f"slice: {ms_pass:.3f} ms/pass (mean of {len(warm)} warm "
          f"windows, bf16 forward; per window "
          f"{', '.join(f'{s * 1e3:.2f}' for s in warm)} ms); launches "
          f"{launches}")

    if profile_dir:
        profile_window(pipe, windows[-1], profile_dir)

    # float32 on the card (TF32 off) against the CPU's plain versions
    m_card = check_f32_card_vs_cpu(model, DSEC_CONFIG, windows[:1])
    for k in ("fwl", "rsat", "aee"):
        print(f"bf16 vs f32 {k} (window 0): "
              f"{float(mets[0][k]):.7f} vs {float(m_card[k]):.7f}")
    return launches, ms_pass, model


def check_f32_card_vs_cpu(model, config, windows, ridx=None, flows=None):
    """One window in float32 (TF32 off) on the card and on the CPU (plain
    versions): FWL/RSAT/AEE must agree. ``ridx`` sets ``cur_ridx`` on both;
    the card's last flow goes to ``flows``."""
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    cfg32 = copy.deepcopy(config)
    del cfg32["metrics"]["inference_dtype"]
    card = EvalPipeline(cfg32, model, device=DEVICE)
    card.cur_ridx = ridx
    (m_card,), _ = run_windows(card, windows, flows)
    t0 = time.perf_counter()
    cpu = EvalPipeline(cfg32, copy.deepcopy(model).cpu(), device="cpu")
    cpu.cur_ridx = ridx
    (m_cpu,), _ = run_windows(cpu, windows)
    print(f"cpu window: {time.perf_counter() - t0:.1f} s")
    for k in ("fwl", "rsat", "aee"):
        a, b = float(m_card[k]), float(m_cpu[k])
        print(f"f32 {k}: card {a:.7f} cpu {b:.7f} "
              f"rel {abs(a - b) / abs(b):.2e}")
        check(math.isclose(a, b, rel_tol=METRIC_RTOL, abs_tol=METRIC_ATOL),
              f"{k}: card {a} vs cpu {b} beyond rtol {METRIC_RTOL}")
    return m_card


def rectified_windows(rng, n_windows, fwd, ridx):
    """``synthetic_windows`` made rectified as the loader makes them
    (``data/base.py assemble_sample``): the raw integer coordinates go to
    ``event_raw_xy``, the list carries the forward map's fractional ones
    (``data.rectify_events``), and the host builds the count input at the
    raw coordinates and remaps it through the index (zero where it is 0)."""
    from taming_event_flow_tpu_torch.data import (
        events_to_channels_np,
        rectify_events,
    )

    h, w = RES
    src = np.where(ridx > 0, ridx - 1, 0).reshape(-1)
    windows = synthetic_windows(rng, n_windows)
    for passes in windows:
        for b in passes:
            ev = b["event_list"]
            ys, xs, ps = (ev[0, :, k].copy() for k in (1, 2, 3))
            b["event_raw_xy"] = np.stack([ys, xs], -1).astype(
                np.uint16)[None]
            rx, ry = rectify_events(fwd, xs, ys)
            ev[0, :, 1], ev[0, :, 2] = ry, rx
            cnt = events_to_channels_np(xs, ys, ps, RES).reshape(-1, 2)
            net = np.where((ridx > 0)[..., None],
                           cnt[src].reshape(h, w, 2), 0.0).astype(np.float32)
            b["net_input"] = net[None]
            b["event_mask"] = (net.sum(-1, keepdims=True) > 0).astype(
                np.float32)[None]
    return windows


def rectified_phase(rng, model, n_windows, ms_plain, profile_dir):
    """The DSEC protocol on a rectified sequence: the count input derived
    on the card (raw coordinates + ``cur_ridx``, one row gather per window)
    against the host-built input shipped, bitwise; float32 metrics card
    against CPU; ``compute_pol_iwe`` card against CPU."""
    import torch

    from taming_event_flow_tpu_torch.ops import (
        LAUNCHES,
        compute_pol_iwe,
        reset_launches,
    )
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline
    from taming_event_flow_tpu_torch.training.step import _derive_inputs

    fwd, bwd = radial_maps()
    ridx = rectified_index(bwd)[None]
    windows = rectified_windows(rng, n_windows, fwd, ridx[0])
    pipe = EvalPipeline(DSEC_CONFIG, model, device=DEVICE)
    pipe.cur_ridx = ridx

    reset_launches()
    mets, secs = run_windows(pipe, windows)
    launches = dict(LAUNCHES)
    expect = {"splat_bilinear": 2 * n_windows,
              "gather_bilinear": PASSES * n_windows, "gather_fused": 0,
              "row_gather": n_windows}
    check(launches == expect,
          f"rectified path launches {launches}, expected {expect}")
    for i, m in enumerate(mets):
        check_metrics(m, f"rectified window {i}")

    # the same windows with the host-built input shipped (no index): the
    # metrics agree (same inputs, checked bitwise below; the splats'
    # atomics may reorder the RSAT/FWL sums), then both routes are timed
    # in turns over TIMING_ROUNDS passes through the windows
    host = EvalPipeline(DSEC_CONFIG, model, device=DEVICE)
    host_mets, _ = run_windows(host, windows)
    for i, (a, b) in enumerate(zip(mets, host_mets)):
        for k in ("fwl", "rsat", "aee"):
            check(math.isclose(float(a[k]), float(b[k]), rel_tol=KERNEL_RTOL,
                               abs_tol=KERNEL_ATOL),
                  f"rectified window {i}: {k} derived {a[k]} vs host {b[k]}")
    secs = {"derived": [], "host": []}
    for _ in range(TIMING_ROUNDS):
        for route, runner in (("derived", pipe), ("host", host)):
            secs[route] += run_windows(runner, windows)[1]
    ms_derived, ms_host = (float(np.mean(secs[r])) / PASSES * 1e3
                           for r in ("derived", "host"))
    print("rectified windows, derived / host-built input: " + ", ".join(
        f"{a * 1e3:.2f} / {b * 1e3:.2f} ms"
        for a, b in zip(secs["derived"], secs["host"])))
    print(f"rectified slice: {ms_derived:.3f} ms/pass with the count input "
          f"derived on the card, {ms_host:.3f} ms/pass with the host-built "
          f"input shipped (mean of {len(secs['host'])} warm windows each, "
          f"in turns); unrectified slice {ms_plain:.3f} ms/pass (bf16 "
          f"forward); launches {launches}")

    if profile_dir:
        profile_run(lambda: run_windows(pipe, windows[-1:]), profile_dir,
                    "rectified", trace=False)

    # one window: derived input and mask bitwise the host-built ones
    passes = [pipe.ensure_bucket(b) for b in windows[0]]
    stack = lambda k: torch.from_numpy(  # noqa: E731
        np.stack([b[k] for b in passes])).to(DEVICE)
    x, _, emask = _derive_inputs(RES, stack("event_list"), None, None, None,
                                 stack("event_raw_xy"), pipe.cur_ridx)
    check(torch.equal(x, stack("net_input"))
          and torch.equal(emask, stack("event_mask")),
          "derived rectified input differs from the host-built one")
    print(f"derived rectified input and event mask equal the host-built "
          f"ones bitwise ({int((x.sum(-1) > 0).sum())} active pixels over "
          f"{PASSES} passes, {int((pipe.cur_ridx == 0).sum())} out-of-source "
          f"pixels)")

    flows = []
    check_f32_card_vs_cpu(model, DSEC_CONFIG, windows[:1], ridx, flows)
    flow = flows[0]
    ev = stack("event_list")[-1]
    p = ev[..., 3]
    pol = torch.stack([p > 0, p < 0], -1).float()
    for rounding in ((True, True), (False, False)):
        got = compute_pol_iwe(flow, ev, RES, pol, *rounding)
        ref = compute_pol_iwe(flow.cpu(), ev.cpu(), RES, pol.cpu(),
                              *rounding)
        e = float((got.cpu() - ref).abs().max())
        check(torch.allclose(got.cpu(), ref, rtol=KERNEL_RTOL,
                             atol=KERNEL_ATOL),
              f"compute_pol_iwe {rounding}: card vs cpu {e}")
        print(f"compute_pol_iwe (round_idx, round_flow) = {rounding}: card "
              f"vs cpu max abs err {e:.3e} (max {float(ref.max()):.3f})")
    return launches, ms_derived, ms_host


def profile_run(fn, out_dir, tag, trace=True, watch=()):
    """Kernel-time breakdown of one call of ``fn`` (torch.profiler): the
    table goes to ``<out_dir>/profile_<tag>.txt``, the ten kernels with the
    most device time to stdout, and for each name in ``watch`` the
    launches and device ms of the kernels whose name holds it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    table = averages.table(sort_by="self_cuda_time_total", row_limit=60)
    # device time: the kernels' and copies' own rows (each op's row would
    # count its kernels a second time)
    # (a user annotation such as the optimizer step's spans its kernels on
    # the device timeline and would count them again)
    device_rows = [a for a in averages if a.device_type == DeviceType.CUDA
                   and not a.is_user_annotation]
    busy = sum(a.self_device_time_total for a in device_rows) / 1e6  # s
    with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as f:
        f.write(f"wall {wall * 1e3:.3f} ms, device time "
                f"{busy * 1e3:.3f} ms\n{table}\n")
    if trace:
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{tag}.json"))
    print(f"profile {tag}: wall {wall * 1e3:.3f} ms, device time "
          f"{busy * 1e3:.3f} ms (device idle {1 - busy / wall:.1%} of the "
          f"wall) -> {out_dir}")
    top = sorted(device_rows, key=lambda a: -a.self_device_time_total)[:10]
    for a in top:
        print(f"  {a.self_device_time_total / 1e3:9.3f} ms  {a.count:6d}x  "
              f"{a.key[:90]}")
    for name in watch:
        rows = [a for a in device_rows if name in a.key]
        print(f"profile {tag}: kernels named *{name}*: "
              f"{sum(a.count for a in rows)} launches, "
              f"{sum(a.self_device_time_total for a in rows) / 1e3:.5f} ms")


def profile_window(pipe, passes, out_dir):
    """Kernel-time breakdown of one warm bf16 eval window."""
    profile_run(lambda: run_windows(pipe, [passes]), out_dir, "window")


# ------------------------------------------------------------ training phase


def train_window(rng, batch, device=DEVICE):
    """One training window of ``PASSES`` passes as ``bench.py``'s
    ``_synthetic_events`` builds it (uniform integer pixels, uniform ts,
    +-1 polarity), every event on the gradient path, with the count input
    derived on the device. On the card unless the caller asks for the CPU.
    """
    import torch

    from taming_event_flow_tpu_torch.ops import derive_count_input
    from taming_event_flow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    shape = (PASSES, batch, TRAIN_N)
    ev = np.zeros(shape + (4,), np.float32)
    ev[..., 0] = rng.uniform(0, 1, shape)
    ev[..., 1] = rng.integers(0, TRAIN_RES[0], shape)
    ev[..., 2] = rng.integers(0, TRAIN_RES[1], shape)
    ev[..., 3] = rng.choice([-1.0, 1.0], shape)
    ev = torch.from_numpy(ev).to(dev)
    p = ev[..., 3]
    return {"net_input": derive_count_input(ev, TRAIN_RES),
            "event_list": ev,
            "pol_mask": torch.stack([p > 0, p < 0], dim=-1).float(),
            "grad_mask": torch.ones(shape + (1,), device=dev)}


def build_trainer(batch, device):
    """The training slice: full-width RecEVFlowNet (seed 0), Adam after the
    global-norm clip, the Iterative loss; returns ``(model, step, state)``.
    """
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.objectives import LossConfig
    from taming_event_flow_tpu_torch.training import (
        build_optimizer,
        init_train_state,
        make_train_step,
    )

    model = build_model(MODEL_CONFIG, num_bins=2, device=device, seed=0)
    opt = build_optimizer(TRAIN_OPT, model.parameters(),
                          clip_grad=TRAIN_CLIP, device=device)
    step = make_train_step(model, opt, LossConfig(**TRAIN_LOSS),
                           "Iterative", flow_scaling=FLOW_SCALING,
                           res=TRAIN_RES)
    return model, step, init_train_state(model, batch, *TRAIN_RES,
                                         device=device)


def check_grads(model, tag):
    """Every parameter got a finite, non-zero gradient."""
    import torch

    names, grads = zip(*((n, p.grad) for n, p in model.named_parameters()))
    check(all(g is not None for g in grads), f"{tag}: a gradient is missing")
    ok = torch.stack([torch.isfinite(g).all() & (g != 0).any()
                      for g in grads]).cpu()
    bad = [n for n, good in zip(names, ok.tolist()) if not good]
    check(not bad, f"{tag}: non-finite or all-zero gradients: {bad}")


def padding_cost(model, window):
    """What the rows purged to (0, 0) cost the splat: the tref-5 IWE splat
    of each flow scale, with and without them."""
    import torch

    from taming_event_flow_tpu_torch.objectives import warp_table_triangular
    from taming_event_flow_tpu_torch.ops import cuda_warp
    from taming_event_flow_tpu_torch.training import run_passes

    tref = PASSES // 2
    with torch.no_grad():
        carry = model.init_state(TRAIN_B, *TRAIN_RES, device=DEVICE)
        flows, _ = run_passes(model, carry, window["net_input"],
                              FLOW_SCALING)
        ts = window["event_list"][..., 0:1] + torch.arange(
            PASSES, device=DEVICE).reshape(-1, 1, 1, 1)
    for s in range(flows.shape[1]):
        with torch.no_grad():
            loc, mask = warp_table_triangular(
                flows[:, s], window["event_list"][..., 1:3], ts,
                window["pol_mask"], TRAIN_RES)
        loc = loc[tref].permute(1, 0, 2, 3).reshape(TRAIN_B, -1, 2)
        mask = mask[tref].permute(1, 0, 2, 3).reshape(TRAIN_B, -1, 2)
        loc = loc.contiguous()
        vals = torch.cat([mask, mask * 0.5], -1).contiguous()
        at_origin = (mask.sum(-1) == 0) & (loc == 0).all(-1)
        keep = int((~at_origin).sum(1).min())
        # per lane, the first `keep` rows that are not purged: the same
        # points the splat counts, without the zero atomics on pixel (0, 0)
        order = torch.argsort(at_origin.int(), dim=1, stable=True)[:, :keep]
        loc_k = torch.gather(loc, 1, order[..., None].expand(-1, -1, 2))
        vals_k = torch.gather(vals, 1, order[..., None].expand(-1, -1, 4))
        loc_k, vals_k = loc_k.contiguous(), vals_k.contiguous()
        times = {}
        for tag, lc, vl in (("with", loc, vals), ("without", loc_k, vals_k)):
            call = lambda: cuda_warp.splat_bilinear(  # noqa: E731
                lc, vl, TRAIN_RES)
            times[tag] = (time_ms(call), device_ms(call, "splat_kernel"))
        n0 = int(at_origin.sum())
        print(f"padding rows, scale {s}: {n0} of {at_origin.numel()} rows of "
              f"the tref-{tref} IWE splat sit purged at (0, 0) "
              f"({n0 / TRAIN_B:.0f} per lane); splat (event ms, device ms) "
              f"{times['with']} with them, {times['without']} on the {keep} "
              f"per lane without")


def fused_gather_census(step, state, window):
    """One more training step with the two Functions' backward watched:
    per width C, the fused gathers' launches and points, the share of rows
    whose values are all zero (which read no taps) and of those at (0, 0),
    and the bytes bound of them all (each launch's loc, values, map and
    d_loc once). ``tools/bench_fused_shapes.ZERO_SHARE`` carries the share
    to the kernel phases' zero-row inputs. Returns the new state."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    stats = {}

    def record(maps, loc, vals):
        zero = (vals == 0).all(-1)
        s = stats.setdefault(vals.shape[-1], {"launches": 0, "points": 0,
                                              "bytes": 0, "zero": [],
                                              "at_origin": []})
        s["launches"] += 1
        s["points"] += zero.numel()
        s["bytes"] += (loc.numel() + vals.numel() + maps.numel()
                       + 2 * zero.numel()) * 4
        s["zero"].append(zero.sum())
        s["at_origin"].append((zero & (loc == 0).all(-1)).sum())

    splat_bw = cuda_warp.SplatBilinearFn.backward
    gather_bw = cuda_warp.GatherBilinearFn.backward

    def splat_spy(ctx, g):
        if ctx.needs_input_grad[0]:
            loc, values = ctx.saved_tensors
            record(g, loc, values)
        return splat_bw(ctx, g)

    def gather_spy(ctx, g):
        if ctx.needs_input_grad[1]:
            maps, loc = ctx.saved_tensors
            record(maps, loc, g)
        return gather_bw(ctx, g)

    cuda_warp.SplatBilinearFn.backward = staticmethod(splat_spy)
    cuda_warp.GatherBilinearFn.backward = staticmethod(gather_spy)
    try:
        state, _ = step(state, window)
    finally:
        cuda_warp.SplatBilinearFn.backward = staticmethod(splat_bw)
        cuda_warp.GatherBilinearFn.backward = staticmethod(gather_bw)
    launches = sum(s["launches"] for s in stats.values())
    check(launches == TRAIN_LAUNCHES["gather_fused"],
          f"census saw {launches} fused gathers in a step")
    total = 0
    for c, s in sorted(stats.items()):
        zero = int(torch.stack(s["zero"]).sum())
        origin = int(torch.stack(s["at_origin"]).sum())
        total += s["bytes"]
        print(f"fused gathers of a training step at C={c}: {s['launches']} "
              f"launches, {s['points']} points, zero-valued rows "
              f"{zero / s['points']:.6f} of them ({zero}; at (0, 0) "
              f"{origin}); bytes bound {bound_ms(s['bytes'], 0)[0]:.5f} ms")
    print(f"fused gathers of a training step: bytes bound "
          f"{bound_ms(total, 0)[0]:.5f} ms ({total} B)")
    return state


def max_ratio(got, ref):
    """``max |got - ref| / max |ref|``."""
    return float((got.cpu() - ref).abs().max() / ref.abs().max())


def grad_gaps(model, ref_model):
    """Per parameter ``max |g - g_ref| / max |g_ref|``: the worst
    ``(ratio, name)`` and the global relative L2 error."""
    ref = dict(ref_model.named_parameters())
    worst, diff2, norm2 = (-1.0, None), 0.0, 0.0
    for name, p in model.named_parameters():
        g, r = p.grad.cpu(), ref[name].grad
        worst = max(worst, (max_ratio(g, r), name),
                    key=lambda t: t[0])
        diff2 += float(((g - r) ** 2).sum())
        norm2 += float((r ** 2).sum())
    return worst, math.sqrt(diff2 / norm2)


def card_vs_cpu(rng):
    """Float32 on the card (TF32 off) against the CPU's plain versions, at
    B=1 from the same weights on the same window.

    The loss's gradient is discontinuous in the flows (the derivative
    stencil jumps where a warped point crosses an integer coordinate), so
    the whole step's parameter gradients move with the convolutions'
    rounding on either device. The check holds each half of the chain
    apart: (a) the whole step's loss; (b) the loss's flow gradient on
    identical flows (the warp and its kernels, forward and backward); (c)
    the parameter gradients of the P passes for one flow cotangent (the
    model's backward), in float64 on both devices. Printed beside them:
    the whole step's gradient gap next to the CPU's own gap when its
    weights move by ``JITTER``, and the float32 model gradients against
    float64 on either device."""
    import torch

    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.objectives import (
        LossConfig,
        iterative_loss,
    )
    from taming_event_flow_tpu_torch.training import run_passes

    w_card = train_window(rng, 1)
    w_cpu = {k: v.cpu() for k, v in w_card.items()}
    cfg = LossConfig(**TRAIN_LOSS)

    def flows_of(model, w, dtype=torch.float32):
        dev = next(model.parameters()).device
        carry = model.init_state(1, *TRAIN_RES, dtype=dtype, device=dev)
        return run_passes(model, carry, w["net_input"].to(dtype),
                          FLOW_SCALING)[0]

    # (a) the whole step; the CPU once more with its weights jittered
    runs = {}
    for tag, dev, w, jitter in (("card", DEVICE, w_card, 0.0),
                                ("cpu", "cpu", w_cpu, 0.0),
                                ("jitter", "cpu", w_cpu, JITTER)):
        model, step, state = build_trainer(1, dev)
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                noise = torch.randn(p.shape, generator=gen).to(dev)
                p.mul_(1 + jitter * noise)
            flows = flows_of(model, w).cpu()
        t0 = time.perf_counter()
        _, loss = step(state, w)
        runs[tag] = (model, flows, float(loss))
        print(f"{tag} train step: {time.perf_counter() - t0:.1f} s")
    a, b = runs["card"][2], runs["cpu"][2]
    rel = abs(a - b) / abs(b)
    print(f"f32 train loss: card {a:.8f} cpu {b:.8f} rel {rel:.2e}")
    check(rel <= TRAIN_LOSS_RTOL, f"train loss: card {a} vs cpu {b}")
    for tag in ("card", "jitter"):
        (worst, name), glob = grad_gaps(runs[tag][0], runs["cpu"][0])
        print(f"f32 whole step, {tag} vs cpu: flows max abs error / max "
              f"|flow| {max_ratio(runs[tag][1], runs['cpu'][1]):.2e}; "
              f"gradients worst {worst:.2e} ({name}), global {glob:.2e}")

    # (b) the loss's flow gradient on identical flows
    flows = runs["cpu"][1]
    gen = torch.Generator().manual_seed(2)
    jittered = flows * (1 + JITTER * torch.randn(flows.shape, generator=gen))
    g_flow = {}
    for tag, dev, w, fl in (("card", DEVICE, w_card, flows),
                            ("cpu", "cpu", w_cpu, flows),
                            ("jitter", "cpu", w_cpu, jittered)):
        f = fl.to(dev).requires_grad_()
        iterative_loss(f, w["event_list"], w["pol_mask"], w["grad_mask"],
                       cfg).backward()
        g_flow[tag] = f.grad
    ratio = max_ratio(g_flow["card"], g_flow["cpu"])
    print(f"f32 loss flow gradient on identical flows, card vs cpu: max abs "
          f"error / max |g| {ratio:.2e}; cpu with flows jittered vs cpu "
          f"{max_ratio(g_flow['jitter'], g_flow['cpu']):.2e}")
    check(ratio <= TRAIN_GRAD_TOL, f"loss flow gradient off by {ratio}")

    # (c) the model's backward for one flow cotangent
    models = {}
    for dtype in (torch.float64, torch.float32):
        for dev, w in ((DEVICE, w_card), ("cpu", w_cpu)):
            m = build_model(MODEL_CONFIG, num_bins=2, device=dev,
                            seed=0).to(dtype)
            flows_of(m, w, dtype).backward(g_flow["cpu"].to(dev))
            models[dev, dtype] = m
    ref = models["cpu", torch.float64]
    (worst, name), glob = grad_gaps(models[DEVICE, torch.float64], ref)
    print(f"f64 model gradients for one flow cotangent, card vs cpu: worst "
          f"max abs error / max |g| {worst:.2e} ({name}), global "
          f"{glob:.2e}")
    check(worst <= TRAIN_GRAD_TOL,
          f"model gradients: {name} off by {worst} x its max |g|")
    for dev in (DEVICE, "cpu"):
        (w32, n32), g32 = grad_gaps(models[dev, torch.float32], ref)
        print(f"f32 model gradients on {dev} vs f64 on cpu: worst {w32:.2e} "
              f"({n32}), global {g32:.2e}")


def train_phase(rng, profile_dir):
    import torch

    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches

    model, step, state = build_trainer(TRAIN_B, DEVICE)
    windows = [train_window(rng, TRAIN_B) for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, secs = [], []
    for i, window in enumerate(windows):
        t0 = time.perf_counter()
        state, loss = step(state, window)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        check(math.isfinite(losses[-1]), f"train step {i}: loss not finite")
        check_grads(model, f"train step {i}")
        print(f"train step {i}{' (warm-up)' if i == 0 else ''}: loss "
              f"{losses[-1]:.7f}  {secs[-1] * 1e3:.2f} ms")
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # what the tensors asked for, without the allocator's rounding and
    # unsplit cached blocks
    asked = torch.cuda.memory_stats().get("requested_bytes.all.peak")
    expect = {name: n * len(windows) for name, n in TRAIN_LAUNCHES.items()}
    check(launches == expect,
          f"training path launches {launches}, expected {expect}")
    check(all(a != b for a, b in zip(losses, losses[1:])),
          f"the loss did not change between steps: {losses}")
    check(state.step == len(windows), "step count")
    ms_step = float(np.mean(secs[1:])) * 1e3
    per_step = {k: v / len(windows) for k, v in launches.items()}
    print(f"train: {ms_step:.3f} ms/step (mean of {TRAIN_STEPS} warm steps, "
          f"B={TRAIN_B}, {TRAIN_RES[0]}x{TRAIN_RES[1]}, P={PASSES}, "
          f"N={TRAIN_N}); launches {launches} ({per_step} per step); peak "
          f"memory {peak / 2**30:.3f} GiB ({peak} B; requested {asked} B)")

    padding_cost(model, windows[-1])
    state = fused_gather_census(step, state, windows[-1])
    if profile_dir:
        # the fused gathers, and the stack/cat kernels (none of them after
        # a fused gather, check_backward_kernels shows)
        profile_run(lambda: step(state, windows[-1]), profile_dir, "train",
                    trace=False, watch=("gather_fused_kernel", "CatArray"))

    card_vs_cpu(rng)
    return launches, ms_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default=None,
                    help="directory for a torch.profiler breakdown")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from taming_event_flow_tpu_torch.ops import kernel_build, set_tf32

    t_start = time.perf_counter()
    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    set_tf32(False)
    lib = kernel_build.load()
    print(f"built {lib.path} in {lib.build_seconds:.2f} s")
    for name, regs, spill in kernel_build.ptxas_report(lib.build_log):
        print(f"  ptxas: {name}: {regs} registers, {spill} bytes spilled")

    rng = np.random.default_rng(args.seed)
    # the clustered splat input draws from a stream of its own, so the
    # other phases see the same data as before it
    kernels = kernel_phase(rng, np.random.default_rng([args.seed, 2]))
    kernels.update(fused_phase(rng, args.seed))
    # the row-gather and rectified phases draw from a stream of their own,
    # so the earlier phases see the same data as before them
    rng_rect = np.random.default_rng([args.seed, 1])
    kernels.update(row_gather_phase(rng_rect))
    eval_launches, ms_pass, model = slice_phase(rng, N_WINDOWS, args.profile)
    rect_launches, ms_rect, ms_rect_host = rectified_phase(
        rng_rect, model, N_WINDOWS, ms_pass, args.profile)
    del model
    train_launches, ms_step = train_phase(rng, args.profile)

    paths = {"dsec_eval": eval_launches, "dsec_rectified": rect_launches,
             "train": train_launches}
    entries = []
    for name in ("splat_bilinear", "gather_bilinear", "gather_fused",
                 "row_gather"):
        e = dict(kernels[name])
        e["launches_by_path"] = {p: n[name] for p, n in paths.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        entries.append(e)
    for e in entries:
        rows = [e] + ([dict(e["gather_backward"], name="  C=2")]
                      if "gather_backward" in e else [])
        for r in rows:
            print(f"{r['name']}: event {r['ms']:.5f} ms, device "
                  f"{r['device_ms']:.5f} ms (wrapper and launch "
                  f"{r['ms'] - r['device_ms']:.5f} ms), host "
                  f"{r['host_us']:.3f} us per call; library event "
                  f"{r['library_ms']:.5f} ms, device "
                  f"{r['library_device_ms']:.5f} ms, host "
                  f"{r['library_host_us']:.3f} us; bound "
                  f"{r['bound_ms']:.5f} ms")
    for tag, r in kernels["gather_fused"]["shapes"].items():
        print(f"gather_fused {tag}: event {r['ms']:.5f} ms, device "
              f"{r['device_ms']:.5f} ms, host {r['host_us']:.3f} us per "
              f"call; bound {r['bound_ms']:.5f} ms")
    print(f"slice_ms_per_pass {ms_pass:.4f}")
    print(f"rectified_ms_per_pass {ms_rect:.4f} (derived on the card), "
          f"{ms_rect_host:.4f} (host-built input shipped)")
    print(f"train_ms_per_step {ms_step:.4f}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
