"""The eval CLI's wall time per GT window on the card: ``eval_flow_torch.test``
on ``configs/eval_dsec.yml``'s values (480x640, P = 10, 0.1 s GT windows,
``n_events_pad`` 65,536, bf16 forward, ``flow_bw`` PNGs stored), over one
rectified and one unrectified synthetic sequence of ``--windows`` + 2 GT
frames each (``--windows`` GT windows or one more, as the last pass rounds), data in memory or in ``.h5`` files as ``chip_smoke.py``'s eval-CLI
phase serves it. The run holds no checkpoint, so the CLI evaluates its
seeded initial weights.

After one warm-up evaluation, prints for each of ``--reps`` evaluations the
CLI's wall ms per GT window (set-up, loader and PNG writeback included) and
its ``SectionTimer`` report, then their median, each beside the card's
``nvidia-smi`` name and power limit. Run from the root of a checkout, on the
card only::

    python -m taming_event_flow_tpu_torch.tools.bench_eval_cli \\
        [--windows 8] [--reps 3] [--tag NAME]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import shutil
import statistics
import sys
import tempfile


def make_run(work, seed):
    """A tracked run holding ``configs/train_flow.yml``'s values and no
    checkpoint. Returns its id."""
    import chip_smoke
    from taming_event_flow_tpu_torch import tracking

    config = chip_smoke.train_cli_config(os.path.join(work, "data"),
                                         seed).config
    tracking.set_tracking_uri(work)
    tracking.set_experiment(config["experiment"])
    run = tracking.start_run()
    tracking.log_params({k: str(v) for k, v in config.items()})
    tracking.end_run()
    return run.info.run_id


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=8,
                    help="GT windows evaluated per sequence")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="", help="printed on every line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_eval_cli: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    gpu = chip_smoke.gpu_line()
    tag = f"[{args.tag}] " if args.tag else ""
    build = os.path.join(os.getcwd(), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="bench_eval_cli_", dir=build)
    try:
        runid = make_run(work, args.seed)
        frames = args.windows + 2  # n GT frames give n - 2 windows at P = 10
        specs = {
            "seq_rect": chip_smoke.dsec_sequence(frames, args.seed * 10 + 20,
                                                 rectify=True),
            "seq_plain": chip_smoke.dsec_sequence(frames,
                                                  args.seed * 10 + 21),
        }
        data_dir, loader_cls = chip_smoke.eval_cli_data(work, "bench", specs)
        ms = []
        for rep in range(args.reps + 1):
            with contextlib.redirect_stdout(io.StringIO()):
                _, wall, pipe, _, _ = chip_smoke.eval_cli_run(
                    f"bench{rep}", chip_smoke.EVAL_DSEC_CLI, data_dir,
                    loader_cls, runid, work)
            n = len(pipe.windows)
            chip_smoke.check(n >= 2 * args.windows,
                             f"{n} GT windows evaluated")
            if rep == 0:
                print(f"{tag}warm-up: {wall / n * 1e3:.3f} ms per GT window")
                continue
            ms.append(wall / n * 1e3)
            print(f"{tag}rep {rep}: {ms[-1]:.3f} ms per GT window of CLI "
                  f"wall over {n} windows on {gpu}")
            print(f"{tag}rep {rep} on {gpu}: {pipe.tm.report()}")
        print(f"{tag}median {statistics.median(ms):.3f} ms per GT window "
              f"(reps {', '.join(f'{m:.3f}' for m in ms)}) on {gpu}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
