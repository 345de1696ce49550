"""The row-gather study on the card: does the hand-written row gather
(``ops.row_gather``, ``csrc/warp_kernels.cu: row_gather_kernel``) beat the
library's row rate?

The port's twin of ``scripts/bench_dma_gather.py``, which asked the same of
a Pallas kernel issuing one HBM->VMEM DMA per row against XLA's
``take_along_axis``. Here the question is asked of the CUDA kernel against
the library yardstick ``torch.index_select(table, 0, idx)``, which computes
the same function on in-range indices, with the plain PyTorch version
(``ops.row_gather_plain``) timed beside them. Same shapes and index
streams as the study: a ``[rows, width]`` float32 table, ``m`` indices,
scattered (uniform) and contiguous (``arange(m) % rows``: the same row
count with perfectly local sources). The study's ``--depth`` and
``--block`` (its DMA ring) have no meaning for a CUDA kernel and are not
taken.

Every call is first held bitwise to the plain version. Prints one line per
(width, stream, implementation) with ms and M rows/s, timed with CUDA
events over back-to-back calls and, for the kernel and ``index_select``,
also as device time from a profiler trace (a short kernel's event time
includes its wrapper's launch cost), and a verdict per width on the
scattered stream by each. Runs on the card only::

    python -m taming_event_flow_tpu_torch.tools.bench_dma_gather \\
        [--rows 307200] [--width 8 128] [--m 655360] [--iters 50]
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from ..ops import row_gather, row_gather_plain

STUDY_ROWS = 307200  # 480 x 640
STUDY_M = 655360
STUDY_WIDTHS = (8, 128)  # the packed patch (4C, C = 2) and a wide row
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet


def study_inputs(rows: int, width: int, m: int, seed: int = 0,
                 device="cuda"):
    """The study's table and its two index streams, made from ``seed`` as
    the study makes them: ``(table [rows, width] float32, {"scattered":
    idx, "contiguous": idx})``, ``idx [m]`` int32."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, width)).astype(np.float32)
    scattered = rng.integers(0, rows, m).astype(np.int32)
    contiguous = (np.arange(m, dtype=np.int64) % rows).astype(np.int32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(table), {"scattered": to(scattered),
                       "contiguous": to(contiguous)}


def time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean time per call of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after warm-up): the device's time, or the host's launch time
    where that is longer."""
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


def device_ms(fn, reps: int = 20, kernel=None, traces: int = 5) -> float:
    """Device time per call of ``fn``: the kernels' own time in a
    ``torch.profiler`` trace of ``reps`` calls, without the host's launch
    cost that back-to-back event timing of a short kernel includes; with
    ``kernel``, only the kernels whose name holds it (the splat wrapper's
    zero fill is then left out), else everything the call runs.

    The profiler now and then returns a trace without the device rows
    asked for, and on the card this has lasted for several traces in a
    row: after ``traces`` such traces the time is read with CUDA events
    (:func:`time_ms`, which includes the launch cost, so it is never
    below the device time) and a line says so, naming the device rows the
    traces did hold."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = set()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(a.key, a.self_device_time_total) for a in prof.key_averages()
                if a.device_type == DeviceType.CUDA
                and not a.is_user_annotation and a.self_device_time_total]
        seen.update(k for k, _ in rows)
        us = sum(t for k, t in rows if kernel is None or kernel in k)
        if us > 0:
            return us / reps / 1e3
    ms = time_ms(fn, reps)
    print(f"the profiler saw no device time for {kernel or 'a call'} in "
          f"{traces} traces (device rows seen: {sorted(seen)}): CUDA-event "
          f"time {ms:.5f} ms per call used in its place", flush=True)
    return ms


def bound_ms(m: int, width: int, rows: int) -> float:
    """Bytes bound: each index read once, each output row written once,
    and at most each table row read once (``min(m, rows)`` rows: a table
    smaller than the index stream is read whole, no more), over the card's
    memory rate."""
    nbytes = m * (width * 4 + 4) + min(m, rows) * width * 4
    return nbytes / PEAK_BYTES_PER_S * 1e3


def measure(table, idx, reps: int = 50, plain_reps: int = 10):
    """Hold the kernel bitwise to the plain version, then time kernel,
    ``index_select`` and plain version with CUDA events, and kernel and
    ``index_select`` on the device alone (:func:`device_ms`):
    ``{"max_abs_err", "ms", "library_ms", "plain_ms", "device_ms",
    "library_device_ms", "bound_ms"}``."""
    got = row_gather(table, idx)
    ref = row_gather_plain(table, idx)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, ref):
        raise RuntimeError(
            f"row_gather disagrees with its plain version at "
            f"{tuple(table.shape)}, M={idx.shape[0]}: max abs err {err}")
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: row_gather(table, idx), reps),
        "library_ms": time_ms(lambda: torch.index_select(table, 0, idx),
                              reps),
        "plain_ms": time_ms(lambda: row_gather_plain(table, idx),
                            plain_reps),
        "device_ms": device_ms(lambda: row_gather(table, idx)),
        "library_device_ms": device_ms(
            lambda: torch.index_select(table, 0, idx)),
        "bound_ms": bound_ms(idx.shape[0], table.shape[1], table.shape[0]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=STUDY_ROWS)
    ap.add_argument("--width", type=int, nargs="+",
                    default=list(STUDY_WIDTHS))
    ap.add_argument("--m", type=int, default=STUDY_M)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_dma_gather runs on a CUDA card only")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({gpu})", flush=True)

    for width in args.width:
        table, streams = study_inputs(args.rows, width, args.m, args.seed)
        rates = {}
        for stream, idx in streams.items():
            r = measure(table, idx, args.iters, max(1, args.iters // 5))
            for key, name in (("ms", "row_gather kernel"),
                              ("device_ms", "  on the device"),
                              ("library_ms", "index_select"),
                              ("library_device_ms", "  on the device"),
                              ("plain_ms", "plain table[idx]")):
                rate = (args.m / (r[key] * 1e-3) / 1e6 if r[key] > 0
                        else float("nan"))
                rates[stream, key] = rate
                print(f"W={width:<4d} {stream:10s} {name:18s} "
                      f"{r[key]:9.5f} ms  {rate:9.1f} M rows/s  (bound "
                      f"{r['bound_ms']:.5f} ms)", flush=True)
        for k_key, l_key, what in (("ms", "library_ms", "with launches"),
                                   ("device_ms", "library_device_ms",
                                    "on the device")):
            k, lib = rates["scattered", k_key], rates["scattered", l_key]
            print(f"verdict W={width} ({what}): "
                  f"{'KERNEL WINS' if k > lib else 'index_select wins'} "
                  f"({k:.1f} vs {lib:.1f} M rows/s, scattered)", flush=True)
        del table, streams
    print(gpu)


if __name__ == "__main__":
    main()
