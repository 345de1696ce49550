"""A tiny copy of the benchmark for CPU tests: the repo's ``BENCHMARK.json``
and ``benchmark/`` copied under a temporary root, every configuration and
traffic mix cut to a size the CPU runs in seconds (the widths and shapes
are the tests', not the cells'). The training size keeps the model's four
scales: with fewer, the finest scale's flows are so small at the seeded
init that the first gradient is a sum of near-singular terms (PERF.md
section 2) and the comparison reads rounding."""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

TINY_MODEL = {"base_channels": 16, "num_encoders": 4}
TINY_TRAFFIC = {
    "train_b8": {"resolution": [64, 64], "batch": 2, "passes": 4,
                 "slots": 2048, "events_per_pass": [1000, 2000], "pool": 4,
                 "shapes": [4, 8]},
    "dsec_rect": {"resolution": [32, 48], "passes": 2, "slots": 512,
                  "events_per_pass": [200, 400], "pool": 3,
                  "shapes": [2, 4]},
    "mvsec": {"resolution": [26, 34], "passes": 1, "slots": 256,
              "events_per_pass": [100, 200], "pool": 4, "shapes": [2, 4]},
}


def _rewrite(path, update):
    with open(path) as f:
        data = json.load(f)
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(data.get(k), dict):
            data[k].update(v)
        else:
            data[k] = v
    with open(path, "w") as f:
        json.dump(data, f)


def make_tiny(dest: str) -> str:
    """Copy the benchmark under ``dest`` at the tests' size; returns the
    new root (which holds ``BENCHMARK.json`` and ``benchmark/``)."""
    root = os.path.join(dest, "root")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH_DIR, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = os.path.join(root, "benchmark")
    for name in os.listdir(os.path.join(bench, "configs")):
        _rewrite(os.path.join(bench, "configs", name),
                 {"model": TINY_MODEL})
    for name, upd in TINY_TRAFFIC.items():
        _rewrite(os.path.join(bench, "traffic", name + ".json"), upd)
    return root


def model_cfg(**sizes):
    """The iterative configuration's model with ``sizes`` changed."""
    path = os.path.join(BENCH_DIR, "configs", "recevflownet_iterative.json")
    with open(path) as f:
        return dict(json.load(f)["model"], **sizes)


def import_harness():
    """Put the benchmark's directory on the path (as ``run.py`` does)."""
    for p in (ROOT, BENCH_DIR):
        if p not in sys.path:
            sys.path.insert(0, p)
