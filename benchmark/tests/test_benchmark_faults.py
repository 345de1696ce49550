"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped (the run is on the CPU at a tiny
size), everything else as in a run. One case for each fault a cell can
have: a step that leaves the state unchanged, an update in the wrong
direction, half of the batch left out with the mean taken over the rest,
an answer altered where it is produced.
(No cell spans chips, so none can leave out an exchange between them.)"""

import os

import pytest
import torch

from harness.runner import run_cell
from harness.spec import Spec


def _run(root, workload):
    spec = Spec(root, os.path.join(root, "benchmark"))
    return run_cell(spec, workload, 2 ** 36 + 5, 0.2, False,
                    torch.device("cpu"), 0.0)


@pytest.mark.parametrize("workload", ["iter_train_b8", "linear_train_b8"])
def test_a_sound_training_run_is_correct(tiny_root, workload):
    r = _run(tiny_root, workload)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["iter_train_b8", "linear_train_b8"])
def test_state_left_unchanged(tiny_root, workload, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    assert not _run(tiny_root, workload)["correct"]


@pytest.mark.parametrize("workload", ["iter_train_b8", "linear_train_b8"])
def test_update_in_the_wrong_direction(tiny_root, workload, monkeypatch):
    """Adam's step taken up the gradient: each update of the right size,
    the wrong sign."""
    step = torch.optim.Adam.step

    def flipped(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        out = step(self, closure)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(2 * b - p)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", flipped)
    r = _run(tiny_root, workload)
    assert not r["correct"]
    assert r["checks"]["change_dir_median"]["value"] > 1.5


@pytest.mark.parametrize("workload,warping", [
    ("iter_train_b8", "Iterative"), ("linear_train_b8", "Linear")])
def test_half_batch_left_out(tiny_root, workload, warping, monkeypatch):
    from taming_event_flow_tpu_torch import objectives

    loss = objectives.LOSS_REGISTRY[warping]

    def half(flows, ev, pol, gm, cfg, **kw):
        h = ev.shape[1] // 2
        return 2.0 * loss(flows[:, :, :h], ev[:, :h], pol[:, :h], gm[:, :h],
                          cfg, **kw)

    monkeypatch.setitem(objectives.LOSS_REGISTRY, warping, half)
    assert not _run(tiny_root, workload)["correct"]


@pytest.mark.parametrize("workload", ["iter_dsec_eval", "iter_mvsec_eval"])
def test_eval_answer_altered(tiny_root, workload, monkeypatch):
    from taming_event_flow_tpu_torch.pipeline import eval as pe

    aee = pe.compute_aee
    monkeypatch.setattr(pe, "compute_aee",
                        lambda *a, **k: aee(*a, **k) * 1.01)
    assert not _run(tiny_root, workload)["correct"]


def test_dsec_flow_map_altered(tiny_root, monkeypatch):
    from taming_event_flow_tpu_torch.pipeline import eval as pe

    u16 = pe.flow_to_u16
    monkeypatch.setattr(pe, "flow_to_u16",
                        lambda f: (u16(f).int() + 16).to(torch.uint16))
    r = _run(tiny_root, "iter_dsec_eval")
    assert not r["correct"]
    assert r["checks"]["flow_bw_mean_steps"]["value"] >= 16
