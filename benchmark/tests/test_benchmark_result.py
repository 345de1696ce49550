"""The result line's keys, and a run without a card."""

import os
import subprocess
import sys

import pytest
import torch

from harness.runner import run_cell
from harness.spec import Spec

import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["iter_train_b8", "iter_dsec_eval"])
def test_result_keys(tiny_root, workload):
    spec = Spec(tiny_root, os.path.join(tiny_root, "benchmark"))
    cpu = torch.device("cpu")
    r0 = run_cell(spec, workload, 2 ** 40 + 3, 0.2, False, cpu, 0.0)
    r0.pop("setup_parts")
    assert list(r0) == KEYS + ["checks"]
    assert set(r0["device"]) == {"platform", "kind", "count",
                                 "memory_peak_bytes"}
    for m in r0["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in r0["checks"].values():
        assert set(c) == {"value", "limit"}
    r1 = run_cell(spec, workload, 2 ** 40 + 3, 0.2, True, cpu, 0.0)
    r1.pop("setup_parts")
    assert list(r1)[-1] == "checks"
    assert set(r1) <= set(KEYS) | {"breakdown", "checks"}
    names = {m["name"] for m in spec.per_layer(workload)}
    assert set(r1["metrics"]) <= names


def test_no_card_exits_without_a_result(tmp_path):
    """The sandbox has no card: the command fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(tiny.BENCH_DIR, "run.py"),
         "--workload", "iter_train_b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_stripped_checkout_fails(tmp_path):
    """Only BENCHMARK.json and benchmark/: no program to run."""
    import shutil

    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(tiny.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, str(tmp_path / "benchmark" / "run.py"),
         "--workload", "iter_train_b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_seed_repeats_inputs():
    """The same seed gives the same inputs and weights; a large seed
    works."""
    import json

    from harness import events
    from harness.weights import make_weights

    with open(os.path.join(tiny.BENCH_DIR, "traffic", "mvsec.json")) as f:
        mix = json.load(f)
    mix.update(tiny.TINY_TRAFFIC["mvsec"])
    seed = 2 ** 31 + 12345
    a, b = events.eval_sequence(mix, seed), events.eval_sequence(mix, seed)
    assert all((x == y).all() for x, y in zip(a.raw, b.raw))
    c = events.eval_sequence(mix, seed + 1)
    # the same work, another scene
    assert sorted(map(len, a.raw)) == sorted(map(len, c.raw))
    cfg = tiny.model_cfg(base_channels=8, num_encoders=2,
                         num_residual_blocks=1)
    w1 = make_weights(cfg, seed, "cpu")
    w2 = make_weights(cfg, seed, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)


@pytest.mark.card
def test_a_cell_on_the_card(card):
    """On a machine with a card: the command runs a short cell and prints a
    correct result line naming the card."""
    import json

    proc = subprocess.run(
        [sys.executable, os.path.join(tiny.BENCH_DIR, "run.py"),
         "--workload", "iter_mvsec_eval", "--seed", str(2 ** 31 + 7),
         "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
        cwd=tiny.ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert "W" in result["device"]["card"]
