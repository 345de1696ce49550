"""The E-RAFT configuration and the one-lane training cell in the harness:
the reference's module found by name, its operation count against
``torch.utils.flop_counter`` on its own forward, and both new cells run
whole at a tiny size on the CPU (they must come out correct)."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import work
from harness.runner import run_cell
from harness.spec import Spec
from harness.weights import make_weights
from reference.models import lookup

import tiny

with open(os.path.join(tiny.BENCH_DIR, "configs", "eraft_iterative.json")) as f:
    CFG = json.load(f)["model"]


def test_lookup_finds_eraft_and_refuses_other_norms():
    mod = lookup(CFG)
    assert mod.__name__.endswith("models.eraft")
    with pytest.raises(NotImplementedError):
        lookup(dict(CFG, cnet_norm="group"))
    with pytest.raises(NotImplementedError):
        lookup(dict(CFG, base_channels=8))


def test_operation_count_is_the_forward_count():
    """``conv_layers`` counts every convolution and the correlation matmul
    of one pass, as ``flop_counter`` counts the reference's forward (its
    operations at the published widths, 2 refinements, 128 x 160)."""
    cfg = dict(CFG, iters=2)
    mod = lookup(cfg)
    weights = make_weights(cfg, 3, "cpu")
    x = torch.rand(1, 128, 160, 2)
    state = mod.init_state(cfg, 1, 128, 160)
    with FlopCounterMode(display=False) as fc:
        mod.forward(weights, cfg, x, state)
    assert work.pass_flops(cfg, 128, 160, 1, train=False) == \
        fc.get_total_flops()


def _root(tmp_path):
    """A tiny copy whose E-RAFT configuration keeps its own keys (the tiny
    model sizes are RecEVFlowNet's) with 2 refinements, and whose DSEC
    traffic is 128 x 160, the least E-RAFT's 4-level pyramid takes."""
    root = tiny.make_tiny(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    path = os.path.join(bench, "configs", "eraft_iterative.json")
    with open(path) as f:
        data = json.load(f)
    data["model"] = dict(CFG, iters=2)
    with open(path, "w") as f:
        json.dump(data, f)
    tiny._rewrite(os.path.join(bench, "traffic", "dsec_rect.json"),
                  {"resolution": [128, 160], "slots": 2048,
                   "events_per_pass": [600, 1200], "pool": 2})
    tiny._rewrite(os.path.join(bench, "traffic", "train_b1.json"),
                  tiny.TINY_TRAFFIC["train_b8"] | {"batch": 1})
    return root


@pytest.mark.parametrize("workload", ["eraft_dsec_eval", "iter_train_b1"])
def test_new_cells_come_out_correct(tmp_path, workload):
    root = _root(tmp_path)
    spec = Spec(root, os.path.join(root, "benchmark"))
    r = run_cell(spec, workload, 2 ** 35 + 7, 0.2, True,
                 torch.device("cpu"), 0.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
