"""``chip_smoke.py`` phase 10 (f) alone, for a machine with two or more
cards: the event axis, the data axis and the event-sharded DSEC eval over
NCCL with one card a rank, held to one process on card 0.

    python3 -m taming_event_flow_tpu_torch.tools.parallel_cards

Run from the repo root (it reuses ``chip_smoke.py``'s cells and checks).
Prints the checks' lines, the ms per step and per window of each case and
the ranks' kernel launches; exits non-zero if a check fails. The times are
two cards of the machine over a few steps and windows, not a scaling
figure.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from taming_event_flow_tpu_torch.ops import (
        kernel_build,
        set_deterministic,
        set_tf32,
    )
    from taming_event_flow_tpu_torch.parallel.spawn import run_ranks

    t0 = time.perf_counter()
    print(chip_smoke.gpu_line())
    n_cards = torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{n_cards} cards")
    chip_smoke.check(n_cards >= 2, "NCCL over one card a rank needs two")
    set_tf32(False)
    set_deterministic()
    kernel_build.load()
    build = os.path.join(os.getcwd(), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="cards_", dir=build)
    try:
        ref = chip_smoke.parallel_references(0)
        spec = {"backend": "nccl", "seed": 0, "flows": ref["flows"],
                "clis": False}
        out = run_ranks(chip_smoke.mesh_rank, 2,
                        ("file://" + os.path.join(work, "rdv"), spec),
                        timeout=chip_smoke.PAR_TIMEOUT)
        chip_smoke.check(all(r["backend"] == "nccl" for r in out),
                         f"backends {[r['backend'] for r in out]}")
        times = chip_smoke.check_mesh_results(out, ref,
                                              "(f) NCCL, one card a rank")
        print(f"parallel_cards_ms {times}; launches "
              f"{[r['launches'] for r in out]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
