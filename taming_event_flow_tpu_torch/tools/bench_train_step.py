"""Wall ms per training step and one step's device time on the card, at the
training cell of ``chip_smoke.py`` (``configs/train_flow.yml`` at
``bench.py``'s batch: full-width RecEVFlowNet, 128x128, P = 10, B = 8,
8,192 events a pass and lane, float32, TF32 off, Adam after clip 100).

    python3 -m taming_event_flow_tpu_torch.tools.bench_train_step [--steps 5]

Run from the repo root (it reuses ``chip_smoke.py``'s trainer and
windows). Sets the precision and determinism the training CLI sets, runs
one warm-up and ``--steps`` timed steps (each synchronised), then one
profiled step (``chip_smoke.profile_run``: its device time against its
wall, the table under ``--profile``). Prints the card and, last, one JSON
line. To compare two trees, unpack the other into a git-ignored directory
and run the tool from each root in one call, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--profile", default=os.path.join("build", "profile"),
                    help="directory for the profiled step's table")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_train_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from taming_event_flow_tpu_torch.ops import (
        kernel_build,
        set_deterministic,
        set_tf32,
    )

    gpu = chip_smoke.gpu_line()
    print(gpu)
    set_tf32(False)
    set_deterministic()
    kernel_build.load()
    _, step, state = chip_smoke.build_trainer(chip_smoke.TRAIN_B, "cuda")
    rng = np.random.default_rng(args.seed)
    windows = [chip_smoke.train_window(rng, chip_smoke.TRAIN_B)
               for _ in range(args.steps + 1)]
    secs, losses = [], []
    for window in windows:
        t0 = time.perf_counter()
        state, loss = step(state, window)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    wall, busy = chip_smoke.profile_run(
        lambda: step(state, windows[-1]), args.profile,
        f"train_{args.label}", trace=False)
    print(json.dumps({
        "label": args.label, "gpu": gpu,
        "ms_per_step": float(np.mean(secs[1:])) * 1e3,
        "steps_ms": [s * 1e3 for s in secs], "losses": losses,
        "profiled_wall_ms": wall, "device_ms": busy}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
