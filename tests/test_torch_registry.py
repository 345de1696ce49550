"""The registry variants of the port against the JAX package's, on the CPU
at small sizes: the model families (EVFlowNet, RecFireFlowNet,
FireFlowNet) from parameters converted by ``flax_params_to_state_dict``,
``events_to_voxel``, 3-step loss histories of the train step (Linear loss,
a Fire model, voxel input, a stateless model) and eval-pipeline windows
(Linear validation, a stateless model, voxel batches).

Tolerances: the forward passes 1e-5 (``tests/test_torch_model.py``'s); the
loss histories rtol 1e-4 (``tests/test_torch_training.py``'s); the
pipeline metrics rtol 2e-3 / atol 2e-4 (the pipeline-parity tolerance)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taming_event_flow_tpu.models import build_model as jax_build_model
from taming_event_flow_tpu.objectives import LossConfig as JLossConfig
from taming_event_flow_tpu.ops import encodings as jenc
from taming_event_flow_tpu.pipeline import EvalPipeline as JaxEvalPipeline
from taming_event_flow_tpu.training import build_optimizer as j_build_opt
from taming_event_flow_tpu.training import make_train_step as j_make_step
from taming_event_flow_tpu.training.step import (
    init_train_state as j_init_state,
)
from taming_event_flow_tpu_torch.data import events_to_voxel_np
from taming_event_flow_tpu_torch.models import (
    EVFlowNet,
    FireFlowNet,
    RecFireFlowNet,
    build_model,
    flax_params_to_state_dict,
)
from taming_event_flow_tpu_torch.objectives import LossConfig
from taming_event_flow_tpu_torch.ops import encodings as tenc
from taming_event_flow_tpu_torch.pipeline import EvalPipeline
from taming_event_flow_tpu_torch.training import (
    build_optimizer,
    init_train_state,
    make_forward_fn,
    make_train_step,
)

from .test_torch_pipeline import (
    DSEC_VIS,
    _assert_metrics_close,
    _config,
    _drive,
    _window,
)
from .test_torch_pipeline import RES as PIPE_RES
from .test_training import P_PASSES, RES, make_window
from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = {
    "EVFlowNet": {"name": "EVFlowNet", "base_channels": 8,
                  "num_encoders": 2, "num_residual_blocks": 1,
                  "final_w_scale": 0.01},
    "RecFireFlowNet": {"name": "RecFireFlowNet", "base_channels": 8},
    "FireFlowNet": {"name": "FireFlowNet", "base_channels": 8,
                    "final_w_scale": 0.01},
}
FWD_RES = (20, 28)  # EVFlowNet pads it to 32x32; Fire runs it as it is


def converted(cfg, num_bins, res, seed=0):
    """A JAX model, its parameters and the port's model holding them."""
    jm = jax_build_model(cfg, num_bins=num_bins)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, *res, num_bins)),
                     jm.init_state(1, *res))["params"]
    tm = build_model(cfg, num_bins=num_bins, device="cpu")
    tm.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("num_bins", [2, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_passes_match_jax(rng, family, num_bins):
    """Three passes with the carry handed on: flows and carry (NCHW in the
    port) within 1e-5."""
    jm, params, tm = converted(FAMILIES[family], num_bins, FWD_RES)
    assert type(tm).__name__ == family
    jcarry = jm.init_state(1, *FWD_RES)
    tcarry = tm.init_state(1, *FWD_RES)
    assert len(tcarry) == len(jcarry) == (2 if family == "RecFireFlowNet"
                                          else 0)
    fwd = make_forward_fn(tm, flow_scaling=1.0)
    for _ in range(3):
        x = rng.poisson(0.7, (1, *FWD_RES, num_bins)).astype(np.float32)
        jflows, jcarry = jm.apply({"params": params}, jnp.asarray(x), jcarry,
                                  train=False)
        tflows, tcarry = fwd(tcarry, torch.from_numpy(x))
        scales = 2 if family == "EVFlowNet" else 1
        assert tflows.shape == jflows.shape == (scales, 1, *FWD_RES, 2)
        np.testing.assert_allclose(tflows.numpy(), np.asarray(jflows),
                                   rtol=1e-5, atol=1e-5)
        for jc, tc in zip(jcarry, tcarry):
            np.testing.assert_allclose(tc.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(jc), rtol=1e-5, atol=1e-5)


def test_registry_builds_by_name_with_the_jax_fields():
    """Each name builds its class, keeps the config keys its JAX twin
    takes (the Fire models ignore the UNet's), and carries the expected
    state_dict names; unknown names and paths raise."""
    fire = build_model({"name": "RecFireFlowNet", "num_encoders": 3,
                        "base_channels": 4}, num_bins=3, device="cpu")
    assert isinstance(fire, RecFireFlowNet)
    assert fire.head.conv2d.weight.shape == (4, 3, 3, 3)
    assert {"head.conv2d.weight", "gru1.update_gate.bias",
            "gru2.out_gate.weight", "pred.conv2d.bias"} <= set(
                fire.state_dict())
    assert isinstance(build_model({"name": "FireFlowNet"}, device="cpu"),
                      FireFlowNet)
    ev = build_model({"name": "EVFlowNet", "base_channels": 4,
                      "num_encoders": 2}, device="cpu")
    assert isinstance(ev, EVFlowNet) and ev.init_state(1, 8, 8) == ()
    assert "arch.encoders.1.conv2d.weight" in ev.state_dict()
    with pytest.raises(ValueError, match="Unknown model"):
        build_model({"name": "FlowNetX"}, device="cpu")
    with pytest.raises(KeyError, match="No port module"):
        flax_params_to_state_dict({"gru3": {"update_gate": {
            "kernel": np.zeros((3, 3, 2, 2))}}})


@pytest.mark.parametrize("bins", [1, 3, 5])
def test_events_to_voxel_matches_jax(rng, bins):
    n, res = 200, (12, 17)
    xs = rng.integers(0, res[1], n).astype(np.float32)
    ys = rng.integers(0, res[0], n).astype(np.float32)
    ts = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    valid = (rng.uniform(size=n) > 0.2).astype(np.float32)
    ref = jenc.events_to_voxel(*map(jnp.asarray, (xs, ys, ts, ps)), bins,
                               res, valid=jnp.asarray(valid))
    got = tenc.events_to_voxel(*map(torch.from_numpy, (xs, ys, ts, ps)),
                               bins, res, valid=torch.from_numpy(valid))
    assert got.shape == (*res, bins)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    # the loader's host voxel grid (valid events only) agrees too
    keep = valid > 0
    host = events_to_voxel_np(xs[keep], ys[keep], ts[keep], ps[keep], bins,
                              res)
    np.testing.assert_allclose(got.numpy(), host, rtol=1e-6, atol=1e-6)


# ------------------------------------------------- train-step histories

OPT = {"name": "Adam", "lr": 1e-3}
CLIP = 100.0
FLOW_SCALING = 4.0
TINY = {"name": "RecEVFlowNet", "base_channels": 8, "num_encoders": 2,
        "num_residual_blocks": 1, "min_size": 4, "final_w_scale": 0.01}
HISTORY_CASES = {
    # (model config, num_bins, warping)
    "linear": (TINY, 2, "Linear"),
    "fire": ({"name": "RecFireFlowNet", "base_channels": 8,
              "final_w_scale": 0.01}, 2, "Iterative"),
    "voxel": (TINY, 4, "Iterative"),
    "evflownet_linear": (dict(TINY, name="EVFlowNet"), 2, "Linear"),
}


def _voxel_window(w, bins):
    """The window's events as a ``bins``-channel voxel input."""
    p, b = w["event_list"].shape[:2]
    net = np.zeros((p, b, *RES, bins), np.float32)
    for i in range(p):
        for j in range(b):
            ev = w["event_list"][i, j]
            net[i, j] = events_to_voxel_np(ev[:, 2], ev[:, 1], ev[:, 0],
                                           ev[:, 3], bins, RES)
    return dict(w, net_input=net)


@pytest.mark.parametrize("case", list(HISTORY_CASES))
def test_loss_history_matches_jax(rng, case):
    cfg, bins, warping = HISTORY_CASES[case]
    w = make_window(rng, 1)
    if bins != 2:
        w = _voxel_window(w, bins)
    jm = jax_build_model(cfg, num_bins=bins)
    jopt = j_build_opt(OPT, clip_grad=CLIP)
    jstate = j_init_state(jm, jopt, 1, RES[0], RES[1], bins)
    jstep = j_make_step(jm, jopt, JLossConfig(res=RES, passes_loss=P_PASSES),
                        warping, flow_scaling=FLOW_SCALING, donate=False,
                        res=RES)

    tm = build_model(cfg, num_bins=bins, device="cpu")
    tm.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, jstate.params)))
    opt = build_optimizer(OPT, tm.parameters(), clip_grad=CLIP, device="cpu")
    step = make_train_step(tm, opt, LossConfig(res=RES, passes_loss=P_PASSES),
                           warping, flow_scaling=FLOW_SCALING, res=RES)
    state = init_train_state(tm, 1, RES[0], RES[1], device="cpu")

    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    jl, tl = [], []
    for _ in range(3):
        jstate, loss = jstep(jstate, jw)
        jl.append(float(loss))
        state, loss = step(state, tw)
        tl.append(float(loss))
    assert state.step == 3 and len(state.carry) == len(jstate.carry)
    assert all(c.grad_fn is None for c in state.carry)
    assert len(set(tl)) == 3  # the updates reach the loss
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


# ------------------------------------------------------ pipeline windows

PIPE_CASES = {
    # (model config, metrics.warping, data.voxel)
    "linear": ({"name": "RecEVFlowNet", "base_channels": 8,
                "num_encoders": 2}, "Linear", None),
    "stateless": ({"name": "FireFlowNet", "base_channels": 8}, "Iterative",
                  None),
    "stateless_linear": ({"name": "EVFlowNet", "base_channels": 8,
                          "num_encoders": 2}, "Linear", None),
    "voxel": ({"name": "RecEVFlowNet", "base_channels": 8,
               "num_encoders": 2}, "Iterative", 4),
}


def _voxel_batches(window, bins):
    """The loader's voxel batches: a ``bins``-channel net input built from
    each batch's events (the event mask stays the count one)."""
    out = []
    for b in window:
        ev = b["event_list"][0]
        net = events_to_voxel_np(ev[:, 2], ev[:, 1], ev[:, 0], ev[:, 3],
                                 bins, PIPE_RES)
        out.append(dict(b, net_input=net[None].astype(np.float32)))
    return out


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_windows_match_jax(case):
    """Two DSEC-protocol windows (windowed path, flow_bw stored) through
    both pipelines, then a per-pass window with a sequence rollover. A
    voxel batch ships its net input and event mask: nothing derives."""
    cfg, warping, voxel = PIPE_CASES[case]
    jm, params, tm = converted(cfg, voxel or 2, PIPE_RES)
    config = _config(vis=DSEC_VIS, metrics={
        "warping": warping, "name": ["FWL", "RSAT", "AEE"]})
    config["data"]["voxel"] = voxel
    windows = [_window(1), _window(2)]
    if voxel:
        windows = [_voxel_batches(w, voxel) for w in windows]
        pipe = EvalPipeline(config, tm, device="cpu")
        assert not pipe._derive_on_device(windows[0][0])
    ref = _drive(JaxEvalPipeline(config, jm, params, auto_shard=False),
                 windows)
    pipe = EvalPipeline(config, tm, device="cpu")
    assert type(pipe.criteria).__name__ == f"{warping}Validation"
    _assert_metrics_close(_drive(pipe, windows), ref)

    # the per-pass path (a jump flushes the window) and the carry reset
    jpipe = JaxEvalPipeline(config, jm, params, auto_shard=False)
    ref = _drive(jpipe, windows, jump_at=1)
    pipe = EvalPipeline(config, tm, device="cpu")
    _assert_metrics_close(_drive(pipe, windows, jump_at=1), ref)
    pipe.start_sequence()
    assert len(pipe.carry) == len(jpipe.carry)
    assert all(float(c.abs().sum()) == 0 for c in pipe.carry)
