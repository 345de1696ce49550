#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``taming_event_flow_tpu_torch``) on
one NVIDIA card.

    python3 chip_smoke.py [--seed S] [--profile DIR]

1. Prints the card (``nvidia-smi`` name and power limit), sets both TF32
   flags, builds the CUDA kernels from ``taming_event_flow_tpu_torch/csrc``.
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   at the DSEC eval path's shapes, with its time, the plain version's, a
   library yardstick's and its memory bound.
3. Slice phase: the DSEC eval protocol (``configs/eval_dsec.yml``: 480x640,
   P=10, 65,536-event bucket, FWL/RSAT/AEE, Iterative warping, bf16
   forward, flow_bw store) through ``EvalPipeline`` with a full-width
   RecEVFlowNet (seeded weights) on synthetic event windows; the launch
   counters must show both kernels ran. Then one window in float32 on the
   card and on the CPU (plain versions), whose metrics must agree.
4. Prints the ``kernels`` JSON line and, last, ``{"ok": true, ...}``.

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
DEVICE = "cuda"

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
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after warm-up; inputs stay L2-warm between calls)."""
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


def kernel_phase(rng):
    import torch
    import torch.nn.functional as F

    from taming_event_flow_tpu_torch.ops import cuda_warp

    dev = torch.device(DEVICE)
    h, w = RES
    results = {}

    # splat inputs: the window's P event slots as the main path holds them
    # (window_points), with (pos, neg, pos*ts, neg*ts) per event like
    # RSAT's splat and zero values on the padding rows
    loc, real = window_points(rng, PASSES)
    m = loc.shape[0]
    check(m == SPLAT_M, "splat shape")
    p = rng.choice([-1.0, 1.0], m)
    ts = rng.uniform(0, PASSES, m)
    vals = np.stack([p > 0, p < 0, (p > 0) * ts, (p < 0) * ts],
                    -1).astype(np.float32) * real[:, None]
    loc_f = torch.from_numpy(loc)[None].to(dev)
    values = torch.from_numpy(vals)[None].to(dev)
    loc_r = torch.round(loc_f)

    splat_err = 0.0
    for name, lc in (("rounded", loc_r), ("fractional", loc_f)):
        out_k = cuda_warp.splat_bilinear(lc, values, RES)
        out_p = cuda_warp.splat_bilinear_plain(lc, values, RES)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        check(torch.allclose(out_k, out_p, rtol=KERNEL_RTOL,
                             atol=KERNEL_ATOL),
              f"splat kernel disagrees with its plain version ({name}): "
              f"max abs err {err}")
        if name == "rounded":
            # count planes at integer locations are sums of 0/1 values:
            # exact in any order of accumulation
            check(torch.equal(out_k[..., :2], out_p[..., :2]),
                  "splat count planes not exact")
        splat_err = max(splat_err, err)
        print(f"splat {name}: max_abs_err {err:.3e} "
              f"(max |out| {float(out_p.abs().max()):.3f})")

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

    results["splat_bilinear"] = {
        "name": "splat_bilinear",
        "route": "cuda",
        "source": "taming_event_flow_tpu_torch/csrc/warp_kernels.cu",
        "replaces": "taming_event_flow_tpu/ops/pallas_warp.py:128",
        "max_abs_err": splat_err,
        "ms": time_ms(lambda: cuda_warp.splat_bilinear(loc_r, values, RES)),
        "plain_ms": time_ms(
            lambda: cuda_warp.splat_bilinear_plain(loc_r, values, RES),
            reps=10),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": time_ms(lib_splat),
    }
    results["splat_bilinear_fractional_ms"] = time_ms(
        lambda: cuda_warp.splat_bilinear(loc_f, values, RES))

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
    check(torch.allclose(out_k, out_p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
          f"gather kernel disagrees with its plain version: {gerr}")
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
    results["gather_bilinear"] = {
        "name": "gather_bilinear",
        "route": "cuda",
        "source": "taming_event_flow_tpu_torch/csrc/warp_kernels.cu",
        "replaces": "taming_event_flow_tpu/ops/pallas_warp.py:206",
        "max_abs_err": gerr,
        "ms": time_ms(lambda: cuda_warp.gather_bilinear(maps, gloc)),
        "plain_ms": time_ms(
            lambda: cuda_warp.gather_bilinear_plain(maps, gloc), reps=10),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": time_ms(lib_gather),
    }
    return results


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


def run_windows(pipe, windows):
    """Drive the pipeline as the eval loop does; returns per-window host
    metrics and the seconds per window (synchronised)."""
    import torch

    mets, secs = [], []
    for passes in windows:
        t0 = time.perf_counter()
        for b in passes:
            b = pipe.ensure_bucket(b)
            pipe.ingest(b, {"ts": 0.0})
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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    for i, m in enumerate(mets):
        check_metrics(m, f"window {i}")
        print(f"bf16 window {i}: {secs[i] * 1e3:.2f} ms  FWL "
              f"{float(m['fwl']):.6f}  RSAT {float(m['rsat']):.6f}  AEE "
              f"{float(m['aee']):.6f}")
    warm = secs[1:] if len(secs) > 1 else secs
    ms_pass = float(np.mean(warm)) / PASSES * 1e3
    print(f"slice: {ms_pass:.3f} ms/pass (mean of {len(warm)} warm "
          f"windows, bf16 forward); launches {launches}")

    if profile_dir:
        profile_window(pipe, windows[-1], profile_dir)

    # float32 on the card (TF32 off) against the CPU's plain versions
    cfg32 = copy.deepcopy(DSEC_CONFIG)
    del cfg32["metrics"]["inference_dtype"]
    card = EvalPipeline(cfg32, model, device=DEVICE)
    (m_card,), _ = run_windows(card, windows[:1])
    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    cpu = EvalPipeline(cfg32, cpu_model, device="cpu")
    (m_cpu,), _ = run_windows(cpu, windows[:1])
    print(f"cpu window: {time.perf_counter() - t0:.1f} s")
    for k in ("fwl", "rsat", "aee"):
        a, b = float(m_card[k]), float(m_cpu[k])
        print(f"f32 {k}: card {a:.7f} cpu {b:.7f} rel {abs(a - b) / abs(b):.2e}")
        check(math.isclose(a, b, rel_tol=METRIC_RTOL, abs_tol=METRIC_ATOL),
              f"{k}: card {a} vs cpu {b} beyond rtol {METRIC_RTOL}")
    for k in ("fwl", "rsat", "aee"):
        print(f"bf16 vs f32 {k} (window 0): "
              f"{float(mets[0][k]):.7f} vs {float(m_card[k]):.7f}")
    return launches, ms_pass


def profile_window(pipe, passes, out_dir):
    """Kernel-time breakdown of one warm bf16 window (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_windows(pipe, [passes])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    table = averages.table(sort_by="self_cuda_time_total", row_limit=40)
    # device time: the kernels' and copies' own rows (each op's row would
    # count its kernels a second time)
    busy = sum(a.self_device_time_total for a in averages
               if a.device_type == DeviceType.CUDA) / 1e6  # us -> s
    with open(os.path.join(out_dir, "profile_window.txt"), "w") as f:
        f.write(f"wall {wall * 1e3:.3f} ms, device time "
                f"{busy * 1e3:.3f} ms\n{table}\n")
    prof.export_chrome_trace(os.path.join(out_dir, "trace_window.json"))
    print(f"profile: wall {wall * 1e3:.3f} ms/window, device time "
          f"{busy * 1e3:.3f} ms -> {out_dir}")


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
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    rng = np.random.default_rng(args.seed)
    kernels = kernel_phase(rng)
    launches, ms_pass = slice_phase(rng, N_WINDOWS, args.profile)

    entries = []
    for name in ("splat_bilinear", "gather_bilinear"):
        e = dict(kernels[name])
        e["launches"] = launches[name]
        entries.append(e)
    print(f"splat on fractional input: "
          f"{kernels['splat_bilinear_fractional_ms']:.4f} ms")
    print(f"slice_ms_per_pass {ms_pass:.4f}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
