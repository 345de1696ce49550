"""The control of each cell, at a size a test run holds: the plain
reference put in the program's place one precision below the
configuration's (TF32 for float32, fp8 for a bfloat16 forward), and for
the training cells the half-batch and sign-flip faults, must fail the cell's limits. On
the card the same readings come from ``benchmark/control.py`` at the
cells' own sizes (PERF.md gives them)."""

import os
import sys

import pytest
import torch

from harness import compare
from harness.spec import Spec


def _readings(root, workload, variant):
    sys.path.insert(0, os.path.join(root, "benchmark"))
    import control

    spec = Spec(root, os.path.join(root, "benchmark"))
    return control.readings(spec, workload, 2 ** 37 + 9, variant,
                            torch.device("cpu")), spec.limits(workload)


@pytest.mark.parametrize("workload,variant", [
    ("iter_train_b8", "control"), ("iter_train_b8", "half_batch"),
    ("iter_train_b8", "signflip"), ("linear_train_b8", "control"),
    ("linear_train_b8", "half_batch"), ("linear_train_b8", "signflip"),
    ("iter_dsec_eval", "control"), ("iter_mvsec_eval", "control")])
def test_control_fails_the_limits(tiny_root, workload, variant):
    numbers, limits = _readings(tiny_root, workload, variant)
    ok, checks = compare.check(numbers, limits)
    assert not ok, checks
