"""The yardstick's counters against hand counts and against
``torch.utils.flop_counter`` on the models themselves."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import work
from harness.weights import make_weights
from reference.models import recevflownet as ref_model

import tiny

FULL = tiny.model_cfg()
SMALL = dict(FULL, base_channels=4, num_encoders=3, num_residual_blocks=1)


def _reader(name):
    path = os.path.join(tiny.BENCH_DIR, "layer_metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_full_step_flops_match_the_flop_counter_reading():
    # torch.utils.flop_counter on one executed B = 8 step at 128x128,
    # P = 10 (bench_torch.py on the H100) counted 2,728,289,894,400
    assert 10 * work.pass_flops(FULL, 128, 128, 8, train=True) \
        == 2728289894400


@pytest.mark.parametrize("hw", [(32, 48), (26, 34)])
@pytest.mark.parametrize("train", [False, True])
def test_pass_flops_match_the_counter(hw, train):
    """The reference model and the port's model both execute what
    ``pass_flops`` counts, forward and (train) backward, padding
    included."""
    from taming_event_flow_tpu_torch.models import build_model

    h, w = hw
    b = 2
    weights = make_weights(SMALL, 3, "cpu")
    x = torch.rand(b, h, w, 2)
    params = {k: v.clone().requires_grad_(train) for k, v in weights.items()}
    carry = ref_model.init_state(SMALL, b, h, w)
    with FlopCounterMode(display=False) as fc:
        flows, _ = ref_model.forward(params, SMALL, x, carry)
        if train:
            flows.sum().backward()
    want = work.pass_flops(SMALL, h, w, b, train=train)
    assert fc.get_total_flops() == want
    model = build_model(dict(SMALL), device="cpu")
    model.load_state_dict(weights)
    model.requires_grad_(train)
    with FlopCounterMode(display=False) as fc:
        flows, _ = model(x, model.init_state(b, h, w))
        if train:
            flows.sum().backward()
    assert fc.get_total_flops() == want


def test_iterative_warp_bytes_by_hand():
    """P = 2 windows of 3 and 5 real events, one 2 x 2 map (map_px 4)."""
    mod = _reader("warp_roofline.train")
    n, px = [3, 5], 4
    # table, forward chain: tau 0 (3 rows, no location grad), tau 1 (8
    # rows, 3 with it); backward chain: tau 1 (5 rows, none), tau 0 (8,
    # 5); per gather 32 px + 16 rows fwd, 16 rows + 32 px d_map, 32 px +
    # 24 per grad row d_loc
    def gather(rows, grad):
        return 32 + 16 * rows + 16 * rows + 32 + (32 + 24 * grad if grad
                                                  else 0)
    table = gather(3, 0) + gather(8, 3) + gather(5, 0) + gather(8, 5)
    # sweep, mode two (delta 1): trefs 0, 1, 2 over windows [0,1), [0,2),
    # [1,2): 3, 8, 5 rows; per splat 24 a row + 64 fwd, 64 + 32 a row bwd
    sweep = sum(24 * r + 64 + 64 + 32 * r for r in (3, 8, 5))
    assert mod.iterative_bytes(n, px, "two") == table + sweep
    lin = mod.linear_bytes(n, px)
    # arrival gather of 8 rows over 2 maps of 4 px, and its map gradient;
    # two splats of 8 rows
    assert lin == (2 * 4 * 8 + 8 * 16 + 8 * 16 + 2 * 4 * 8) \
        + 2 * (24 * 8 + 64 + 64 + 32 * 8)
    counts = np.array([[1, 2], [2, 3]])
    cfg = {"model": FULL, "loss": {"warping": "Iterative",
                                   "iterative_mode": "two"}}
    mix = {"resolution": [2, 1], "batch": 2}
    assert mod.step_bytes(counts, cfg, mix) == 4 * (table + sweep)
    cfg["loss"]["warping"] = "Linear"
    assert mod.step_bytes(counts, cfg, mix) == 4 * lin


def test_eval_warp_bytes_by_hand():
    mod = _reader("warp_roofline.eval")
    mix = {"resolution": [2, 2], "pipeline": {"metrics": {}}}
    # passes of 3 and 5 events on a 2 x 2 frame: gathers over 3 + 4 and
    # 8 + 4 points (32 px + 16 a point); two 4-channel splats of 8 rows
    gathers = (32 + 16 * 7) + (32 + 16 * 12)
    splats = 2 * (24 * 8 + 64)
    assert mod.window_bytes([3, 5], mix, False) == gathers + splats
    rect = 8 * 20 + 2 * 4 * 20
    assert mod.window_bytes([3, 5], mix, True) == gathers + splats + rect
    mix["pipeline"]["metrics"]["mask_aee"] = True
    assert mod.window_bytes([3, 5], mix, False) == gathers + splats \
        + 16 * 8 + 32
