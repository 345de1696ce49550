"""Run-to-run spread of the training CLI's losses on the card: the one-rank
run of ``chip_smoke.py`` phase 10's (e) cases several times, then the same
cases on two gloo ranks that share the card, with every step's loss.

    python3 -m taming_event_flow_tpu_torch.tools.bench_cli_spread [--runs 3]

Run from the repo root (it reuses ``chip_smoke.py``'s data and configs:
``configs/train_flow.yml``'s values, full width, 128x128, P = 10, one
epoch over two synthetic sequences). Prints one line per run and the
epoch losses' largest relative gap among the one-rank runs and between the
two-rank runs and the first one-rank run. A one-rank run repeats bit for bit
(the splat sums in fixed point, the upsample's backward is a gather, cuDNN
keeps to its deterministic algorithms), so the one-rank gap prints 0. Two
ranks shard the splat and loss sums or the gradient sum, which reorders
float sums, and the loss's gradient jumps in the flows: the two-rank gap
says how far apart two correct runs may land.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile


def _two_ranks(rank, world, url, seed, work, tag):
    import chip_smoke
    import train_flow_torch
    from taming_event_flow_tpu_torch.ops import (
        kernel_build,
        set_deterministic,
        set_tf32,
    )
    from taming_event_flow_tpu_torch.parallel import init_distributed

    init_distributed({"coordinator": url, "num_processes": world,
                      "process_id": rank}, backend="gloo", device="cuda:0")
    set_tf32(False)
    set_deterministic()
    kernel_build.load()
    data_dir, loader_cls, _ = chip_smoke.cli_train_data(work, seed,
                                                        write=False)
    steps = chip_smoke.recording(
        train_flow_torch.make_event_parallel_train_step)
    root = tempfile.mkdtemp(prefix=f"two_{tag}_", dir=work)
    runid, _, _ = chip_smoke.run_train_cli(
        chip_smoke.par_cli_parser(data_dir, seed,
                                  chip_smoke.PAR_CLI_CASES[tag], 2),
        root, {"H5Loader": loader_cls,
               "make_event_parallel_train_step": steps})
    epoch = chip_smoke.epoch_losses(root, runid) if rank == 0 else None
    return steps.steps[0].losses, epoch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.getcwd())
    import chip_smoke
    import train_flow_torch
    from taming_event_flow_tpu_torch.ops import (
        kernel_build,
        set_deterministic,
        set_tf32,
    )
    from taming_event_flow_tpu_torch.parallel.spawn import run_ranks

    print(chip_smoke.gpu_line())
    set_tf32(False)
    set_deterministic()
    kernel_build.load()
    build = os.path.join(os.getcwd(), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="cli_spread_", dir=build)
    try:
        data_dir, loader_cls, _ = chip_smoke.cli_train_data(work, args.seed)
        for tag, change in chip_smoke.PAR_CLI_CASES.items():
            one = []
            for i in range(args.runs):
                steps = chip_smoke.recording(train_flow_torch.make_train_step)
                root = tempfile.mkdtemp(prefix=f"one_{tag}_", dir=work)
                runid, _, _ = chip_smoke.run_train_cli(
                    chip_smoke.par_cli_parser(data_dir, args.seed, change, 1),
                    root, {"H5Loader": loader_cls, "make_train_step": steps})
                one.append(chip_smoke.epoch_losses(root, runid)[0])
                print(f"spread {tag} one rank run {i}: steps "
                      f"{steps.steps[0].losses}, epoch {one[-1]}", flush=True)
            two = []
            for i in range(max(args.runs - 1, 1)):
                url = "file://" + os.path.join(work, f"rdv_{tag}_{i}")
                out = run_ranks(_two_ranks, 2,
                                (url, args.seed, work, tag), timeout=900.0)
                two.append(out[0][1][0])
                print(f"spread {tag} two ranks run {i}: steps {out[0][0]}, "
                      f"epoch {two[-1]}", flush=True)
            gap_one = (max(one) - min(one)) / abs(one[0])
            gap_two = max(abs(t - one[0]) for t in two) / abs(one[0])
            print(f"spread {tag}: one-rank epoch losses within {gap_one:.2e} "
                  f"of each other; two-rank within {gap_two:.2e} of the "
                  "first one-rank run")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
