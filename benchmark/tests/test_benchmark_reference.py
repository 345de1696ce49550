"""The plain reference against the port's CPU path at a tiny size: the
model forward, both losses and their flow gradients, the training step,
and whole eval cells (which must come out correct)."""

import os

import numpy as np
import pytest
import torch

from harness import events
from harness.runner import run_cell
from harness.spec import Spec
from harness.weights import make_weights
from reference import losses as ref_losses
from reference.models import recevflownet as ref_model
from reference.train import count_input

import tiny

CFG = tiny.model_cfg(base_channels=8, num_encoders=2,
                     num_residual_blocks=1)
MIX = {"resolution": [32, 32], "batch": 2, "passes": 2, "slots": 256,
       "events_per_pass": [120, 240], "pool": 2, "shapes": [2, 4],
       "speed_px_per_pass": [0.5, 4.0], "noise_share": 0.1}


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("hw", [(32, 32), (26, 34)])
def test_model_forward_matches_the_port(dtype, hw):
    from taming_event_flow_tpu_torch.models import build_model

    h, w = hw
    weights = make_weights(CFG, 11, "cpu")
    model = build_model(dict(CFG), device="cpu")
    model.load_state_dict(weights)
    net = model if dtype is None else model.to(dtype)
    x = torch.rand(1, h, w, 2) * 3
    carry = model.init_state(1, h, w, dtype=dtype or torch.float32)
    want, want_c = net(x.to(dtype) if dtype else x, carry)
    got, got_c = ref_model.forward(weights, CFG, x, carry, dtype=dtype)
    assert torch.equal(want, got)
    assert all(torch.equal(a, b) for a, b in zip(want_c, got_c))


@pytest.mark.parametrize("warping", ["Iterative", "Linear"])
def test_losses_and_flow_gradients_match_the_port(warping):
    from taming_event_flow_tpu_torch.objectives import (LOSS_REGISTRY,
                                                        LossConfig)

    pool = events.train_pool(MIX, 5)
    ev = torch.from_numpy(pool[0].events)
    gm = torch.from_numpy(pool[0].grad)
    pol = torch.stack([ev[..., 3] > 0, ev[..., 3] < 0], -1).float()
    torch.manual_seed(0)
    flows = (torch.randn(2, 2, 2, 32, 32, 2) * 2).requires_grad_()
    cfg = LossConfig(res=(32, 32), passes_loss=2, scales_loss=1,
                     iterative_mode="two")
    lp = LOSS_REGISTRY[warping](flows, ev, pol, gm, cfg)
    gp, = torch.autograd.grad(lp, flows)
    rcfg = {"res": (32, 32), "passes_loss": 2, "scales_loss": 1,
            "iterative_mode": "two"}
    lr = ref_losses.LOSSES[warping](flows, ev, pol, gm, rcfg)
    gr, = torch.autograd.grad(lr, flows)
    lp, lr = float(lp.detach()), float(lr.detach())
    assert abs(lp - lr) <= 1e-6 * abs(lr)
    assert float((gp - gr).abs().max()) <= 1e-5 * float(gr.abs().max())


def test_count_input_matches_the_port():
    from taming_event_flow_tpu_torch.ops import derive_count_input

    pool = events.train_pool(MIX, 9)
    ev = torch.from_numpy(pool[0].events)
    assert torch.equal(count_input(ev, (32, 32)),
                       derive_count_input(ev, (32, 32)))


@pytest.mark.parametrize("workload", ["iter_dsec_eval", "iter_mvsec_eval"])
def test_eval_cells_come_out_correct(tiny_root, workload):
    spec = Spec(tiny_root, os.path.join(tiny_root, "benchmark"))
    r = run_cell(spec, workload, 2 ** 35 + 1, 0.3, False,
                 torch.device("cpu"), 0.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("workload", ["iter_train_b8", "linear_train_b8"])
def test_training_first_step_matches_the_port(tiny_root, workload):
    """The first step's loss is the port's to rounding (the later steps and
    the gradient part on the loss's jumps, PERF.md section 2)."""
    spec = Spec(tiny_root, os.path.join(tiny_root, "benchmark"))
    cell = spec.workload(workload)
    out = spec.driver("train").run(spec.config(cell["config"]),
                                   spec.traffic(cell["traffic"]), 2 ** 35 + 1,
                                   0.2, False, torch.device("cpu"), 0.0)
    prog, ref = out["program"][0], out["reference"][0]
    assert abs(prog[0] - ref[0]) <= 1e-6 * abs(ref[0])
    assert np.isfinite(prog).all()
