"""Run one cell of the benchmark once, on the card of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration and traffic mix; see ``benchmark/harness/spec.py`` for how
the files are found. The run makes its inputs and weights from ``--seed``,
warms up, measures for ``--seconds``, then holds what the timed path
produced to the plain reference (``benchmark/reference``). The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: every number compared beside its limit, also printed as
the last lines of standard error). With ``--trace 0`` the metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and when JAX or the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "taming_event_flow_tpu")


def loaded_forbidden():
    """Modules of JAX or of the JAX package in this process, compared by
    the whole top-level name (the port's name begins with the JAX
    package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the run stays in the checkout
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [ROOT, BENCH_DIR]

    from harness.spec import Spec

    spec = Spec(ROOT, BENCH_DIR)
    cell = spec.workload(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from harness.runner import run_cell
    from harness.work import card_line

    device = torch.device("cuda", 0)
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"JAX was loaded in the benchmark's process: {bad}",
              file=sys.stderr)
        return 3
    result["device"]["card"] = card_line()
    print("set-up, seconds from the start at the end of each part: "
          + json.dumps(result.pop("setup_parts")), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
