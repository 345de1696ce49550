"""The fused gather's launch-shape study on the card: which of 128 and 256
threads x 1, 2 and 4 points per thread runs ``gather_fused_kernel``
(``csrc/warp_kernels.cu``) fastest at the training step's shapes?

Builds one library per shape from a copy of the source with
``kFusedThreads`` and ``kFusedPoints`` set (all nvcc runs at once, under
``build/cuda/fused_shapes/``), prints each kernel instance's registers and
spills, holds every shape bitwise to ``ops.gather_fused_plain``, and
times its kernel on the device (profiler) as the training step calls it
(no gather values) at B = 8, 128x128: C = 4 at 10 and 5 windows of 8,192
events (the IWE splat's backward), C = 2 at 10 and 2 windows (the flow
gather's backward, the step's smallest launch), and the 10-window cases
with the step's shares of zero-valued rows and with every row zero (no
tap read: the stream alone). Prints a table of
device ms and the fastest shape per case and over all. Runs on the card
only::

    python -m taming_event_flow_tpu_torch.tools.bench_fused_shapes
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import gather_fused_plain, kernel_build
from .bench_dma_gather import device_ms

SHAPES = tuple((t, p) for t in (128, 256) for p in (1, 2, 4))
BATCH = 8
RES = (128, 128)
WINDOW_N = 8192  # events per window and lane (configs/train_flow.yml)
# the shares of a training step's fused-gather rows whose values are all
# zero, and of all rows those at (0, 0), per width C: chip_smoke.py's
# training phase counts them (B = 8, seeded random weights; NVIDIA H100 80GB
# HBM3, 700.00 W)
ZERO_SHARE = {4: (0.51, 0.155), 2: (0.65, 0.17)}
# tag: (C, M per lane, (share of zero-valued rows, share of them at (0, 0)))
CASES = {
    "C4_10w": (4, 10 * WINDOW_N, (0.0, 0.0)),
    "C4_5w": (4, 5 * WINDOW_N, (0.0, 0.0)),
    "C2_10w": (2, 10 * WINDOW_N, (0.0, 0.0)),
    "C2_2w": (2, 2 * WINDOW_N, (0.0, 0.0)),
    "C4_10w_zero_rows": (4, 10 * WINDOW_N, ZERO_SHARE[4]),
    "C2_10w_zero_rows": (2, 10 * WINDOW_N, ZERO_SHARE[2]),
    # every row zero: no tap is read, what is left is the stream of loc,
    # values and d_loc
    "C4_10w_no_taps": (4, 10 * WINDOW_N, (1.0, 0.0)),
    "C2_10w_no_taps": (2, 10 * WINDOW_N, (1.0, 0.0)),
}


def fused_inputs(seed, c, m, zero, batch=BATCH, res=RES, device="cuda"):
    """``(maps [B, H, W, C], loc [B, M, 2], values [B, M, C])`` made from
    ``seed``: uniform points over the frame and two pixels past it, the
    first quarter of each lane at integer coordinates, and, with ``zero =
    (share, at_origin)``, a share of rows at random positions with zero
    values, ``at_origin`` of all rows of them moved to (0, 0) as
    ``purge_unfeasible`` leaves them."""
    rng = np.random.default_rng(seed)
    h, w = res
    loc = np.stack([rng.uniform(-2, h + 1, (batch, m)),
                    rng.uniform(-2, w + 1, (batch, m))],
                   -1).astype(np.float32)
    loc[:, : m // 4] = np.round(loc[:, : m // 4])
    vals = rng.normal(size=(batch, m, c)).astype(np.float32)
    maps = rng.normal(size=(batch, h, w, c)).astype(np.float32)
    u = rng.uniform(size=(batch, m))
    vals[u < zero[0]] = 0.0
    loc[u < min(zero)] = 0.0
    return tuple(torch.from_numpy(a).to(device) for a in (maps, loc, vals))


def build_shapes(shapes=SHAPES):
    """One library per ``(threads, points)``: ``{shape: (lib, log)}``."""
    with open(kernel_build.SOURCE) as f:
        src = f.read()
    root = os.path.join(kernel_build.BUILD_ROOT, "fused_shapes")
    jobs = {}
    for threads, points in shapes:
        text, n_t = re.subn(r"constexpr int kFusedThreads = \d+;",
                            f"constexpr int kFusedThreads = {threads};", src)
        text, n_p = re.subn(r"constexpr int kFusedPoints = \d+;",
                            f"constexpr int kFusedPoints = {points};", text)
        if (n_t, n_p) != (1, 1):
            raise RuntimeError("the launch-shape constants of the fused "
                               "gather are not in the source")
        out = os.path.join(root, f"t{threads}_p{points}")
        os.makedirs(out, exist_ok=True)
        cu = os.path.join(out, "warp_kernels.cu")
        with open(cu, "w") as f:
            f.write(text)
        jobs[threads, points] = (cu, os.path.join(out, "warp_kernels.so"))
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = {k: pool.submit(kernel_build.compile_library, *v)
                for k, v in jobs.items()}
        logs = {k: f.result()[1] for k, f in logs.items()}
    return {k: (kernel_build.open_library(jobs[k][1]), logs[k])
            for k in jobs}


def fused_call(lib, maps, loc, vals, d_loc):
    """The library's fused gather without gather values, as the training
    path calls it, on the current stream."""
    b, h, w, c = maps.shape
    rc = lib.tef_gather_fused(
        maps.data_ptr(), loc.data_ptr(), vals.data_ptr(), None,
        d_loc.data_ptr(), b, loc.shape[1], c, h, w,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(lib.tef_error_string(rc).decode())


def study(libs, cases=CASES, seed=0):
    """``{case: {shape: device ms}}``, every shape first held bitwise to
    the plain version."""
    times = {}
    for i, (tag, (c, m, zero)) in enumerate(cases.items()):
        maps, loc, vals = fused_inputs([seed, i], c, m, zero)
        ref = torch.stack(gather_fused_plain(maps, loc, vals,
                                             with_gv=False)[1:], -1)
        times[tag] = {}
        for shape, (lib, _) in libs.items():
            d_loc = torch.empty_like(ref)
            fused_call(lib, maps, loc, vals, d_loc)
            torch.cuda.synchronize()
            if not torch.equal(d_loc.view(torch.int32),
                               ref.view(torch.int32)):
                raise RuntimeError(f"shape {shape} disagrees with the plain "
                                   f"version at {tag}")
            times[tag][shape] = device_ms(
                lambda: fused_call(lib, maps, loc, vals, d_loc),
                kernel="gather_fused_kernel")
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_fused_shapes runs on a CUDA card only")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({gpu})", flush=True)
    libs = build_shapes()
    for shape, (_, log) in libs.items():
        for name, regs, spill in kernel_build.ptxas_report(log):
            if name.startswith("gather_fused_kernel"):
                print(f"{shape[0]}x{shape[1]} {name}: {regs} registers, "
                      f"{spill} bytes spilled", flush=True)
    times = study(libs, seed=args.seed)
    print("device ms, threads x points per thread: "
          + "  ".join(f"{t}x{p}" for t, p in SHAPES))
    for tag, row in times.items():
        best = min(row, key=row.get)
        print(f"{tag:18s} " + "  ".join(f"{row[s]:.5f}" for s in SHAPES)
              + f"  fastest {best[0]}x{best[1]}", flush=True)
    total = {s: sum(row[s] for row in times.values()) for s in SHAPES}
    best = min(total, key=total.get)
    print(f"{'sum':18s} " + "  ".join(f"{total[s]:.5f}" for s in SHAPES)
          + f"  fastest {best[0]}x{best[1]}")
    print(gpu)


if __name__ == "__main__":
    main()
