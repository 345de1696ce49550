"""The port's Linear scheme against the JAX package's, on the same numpy
inputs: the Linear loss (value and flow gradient under
``jax.value_and_grad``; the JAX package on the CPU runs its separable
einsums, the port its plain PyTorch versions through its autograd
Functions) and ``LinearValidation`` (state, RSAT, FWL, the window IWE and
the window flow).

Loss tolerances are ``tests/test_objectives.py``'s for the Linear loss:
rtol 2e-4 / atol 1e-5 on the value, rtol 2e-3 / atol 2e-5 on the
gradient."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taming_event_flow_tpu import objectives as jobj
from taming_event_flow_tpu.metrics import validation as jval
from taming_event_flow_tpu_torch import objectives as tobj
from taming_event_flow_tpu_torch.metrics import validation as tval

from .test_torch_objectives import value_and_grad, world_of_one
from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RES = (8, 10)
N_GRAD, N_DET = 12, 6
N = N_GRAD + N_DET
S = 2  # flow scales
VALUE_TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def make_inputs(rng, passes, b=1):
    """``tests/test_torch_objectives.py``'s inputs: integer pixels, window
    ts anchored at 0, a detached event subset."""
    flows = rng.normal(size=(passes, S, b, RES[0], RES[1], 2)).astype(
        np.float32) * 1.5
    events = np.zeros((passes, b, N, 4), np.float32)
    events[..., 0] = rng.uniform(0, 1, (passes, b, N))
    events[:, :, 0, 0] = 0.0
    events[:, :, N_GRAD, 0] = 0.0
    events[..., 1] = rng.integers(0, RES[0], (passes, b, N))
    events[..., 2] = rng.integers(0, RES[1], (passes, b, N))
    events[..., 3] = rng.choice([-1.0, 1.0], (passes, b, N))
    pol = np.stack([(events[..., 3] > 0), (events[..., 3] < 0)],
                   axis=-1).astype(np.float32)
    grad_mask = np.zeros((passes, b, N, 1), np.float32)
    grad_mask[:, :, :N_GRAD] = 1.0
    return flows, events, pol, grad_mask


def both(flows, events, pol, grad_mask, **cfg_kw):
    """(value, flow grad) of the JAX Linear loss and of the port's."""
    jcfg = jobj.LossConfig(res=RES, **cfg_kw)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda f: jobj.linear_loss(f, jnp.asarray(events), jnp.asarray(pol),
                                   jnp.asarray(grad_mask), jcfg)
    ))(jnp.asarray(flows))
    tf = torch.from_numpy(flows).requires_grad_()
    tv = tobj.LOSS_REGISTRY["Linear"](
        tf, torch.from_numpy(events), torch.from_numpy(pol),
        torch.from_numpy(grad_mask), tobj.LossConfig(res=RES, **cfg_kw))
    tv.backward()
    return (float(jv), np.asarray(jg)), (float(tv.detach()), tf.grad.numpy())


@pytest.mark.parametrize("passes,scales,round_ts,b,border,scaling", [
    (4, 1, False, 1, True, True),
    (4, 2, False, 1, True, True),
    (3, 1, True, 2, True, True),
    (4, 2, False, 2, False, False),
])
def test_linear_loss_matches_jax(rng, passes, scales, round_ts, b, border,
                                 scaling):
    inputs = make_inputs(rng, passes, b=b)
    j, t = both(*inputs, passes_loss=passes, scales_loss=scales,
                round_ts=round_ts, border_compensation=border,
                loss_scaling=scaling)
    assert np.abs(t[1]).max() > 0
    np.testing.assert_allclose(t[0], j[0], **VALUE_TOL)
    np.testing.assert_allclose(t[1], j[1], **GRAD_TOL)


@pytest.mark.parametrize("scales", [1, 2])
def test_linear_loss_smoothing_terms_match_jax(rng, scales):
    inputs = make_inputs(rng, 4)
    j, t = both(*inputs, passes_loss=4, scales_loss=scales,
                flow_spat_smooth_weight=0.5, flow_temp_smooth_weight=0.3)
    np.testing.assert_allclose(t[0], j[0], **VALUE_TOL)
    np.testing.assert_allclose(t[1], j[1], **GRAD_TOL)


def test_linear_loss_detached_events_carry_no_gradient(rng, tmp_path):
    """With every event off the gradient path only the smoothing terms
    reach the flows, with or without an ``event_axis`` (a world of one
    rank: the same zero gradient)."""
    flows, events, pol, gm = make_inputs(rng, 2)
    t = torch.from_numpy
    cfg = tobj.LossConfig(res=RES, passes_loss=2)
    detached = (events, pol, np.zeros_like(gm))
    _, grad = value_and_grad(tobj.linear_loss, flows, detached, cfg)
    assert float(grad.abs().max()) == 0.0
    with world_of_one(tmp_path) as group:
        _, grad = value_and_grad(tobj.linear_loss, flows, detached, cfg,
                                 event_axis=group)
        assert float(grad.abs().max()) == 0.0
        loss = tobj.linear_loss(t(flows), t(events), t(pol), t(gm), cfg,
                                event_axis=group)
        assert torch.equal(loss, tobj.linear_loss(
            t(flows), t(events), t(pol), t(gm), cfg))


# ------------------------------------------------------ LinearValidation

V_RES = (12, 16)
P, B, V_N = 3, 2, 40
LOC_TOL = dict(rtol=1e-4, atol=1e-4)


def _passes(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(P):
        ev = np.zeros((B, V_N, 4), np.float32)
        ev[..., 0] = np.sort(rng.uniform(0, 1, (B, V_N)), axis=1)
        ev[:, 0, 0] = 0.0
        ev[..., 1] = rng.integers(0, V_RES[0], (B, V_N))
        ev[..., 2] = rng.integers(0, V_RES[1], (B, V_N))
        ev[..., 3] = rng.choice([-1.0, 1.0], (B, V_N))
        ev[:, -V_N // 8:] = 0.0  # padding rows
        pol = np.stack([ev[..., 3] > 0, ev[..., 3] < 0], -1).astype(
            np.float32)
        flow = (rng.normal(size=(B, *V_RES, 2)) * 1.5).astype(np.float32)
        emask = (rng.uniform(size=(B, *V_RES, 1)) > 0.5).astype(np.float32)
        out.append((flow, ev, pol, emask))
    return out


def _run(mod, to, round_ts=False, n_passes=P):
    kw = {"device": "cpu"} if mod is tval else {}
    val = mod.METRIC_REGISTRY["Linear"](
        mod.ValConfig(res=V_RES, passes=P, round_ts=round_ts), B, V_N, **kw)
    state = val.init()
    for k, (flow, ev, pol, emask) in enumerate(_passes(0)[:n_passes]):
        state = val.update(state, to(flow), to(ev), to(pol), to(emask),
                           n_active=k + 1)
    return val, state


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("round_ts", [False, True])
def test_linear_validation_matches_jax(round_ts):
    jv, js = _run(jval, jnp.asarray, round_ts)
    tv, ts = _run(tval, torch.from_numpy, round_ts)
    assert isinstance(tv, tval.LinearValidation)
    assert ts.pass_idx == int(js.pass_idx) == P
    # fw_loc holds each event's flow; the Iterative-only slots stay zero
    np.testing.assert_allclose(_np(ts.fw_loc), _np(js.fw_loc), **LOC_TOL)
    for name in ("event_ts", "event_loc", "pol_mask", "flow_maps",
                 "event_mask_maps", "fw_mask", "bw_loc", "accum_flow"):
        np.testing.assert_array_equal(_np(getattr(ts, name)),
                                      _np(getattr(js, name)), err_msg=name)

    rsat_t, fwl_t = tv.rsat_fwl(ts)
    rsat_j, fwl_j = jv.rsat_fwl(js)
    np.testing.assert_allclose(rsat_t.numpy(), np.asarray(rsat_j),
                               rtol=1e-5)
    np.testing.assert_allclose(float(fwl_t), float(fwl_j), rtol=1e-5)
    np.testing.assert_allclose(tv.rsat(ts).numpy(), np.asarray(jv.rsat(js)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tv.fwl(ts)), float(jv.fwl(js)),
                               rtol=1e-5)
    assert float(tv.fwl(ts)) == float(fwl_t)  # bitwise, as for Iterative


@pytest.mark.parametrize("n_passes", [1, 2, P])
def test_linear_window_accessors_match_jax(n_passes):
    """The window IWE (``mode`` ignored: backward renders the forward IWE)
    and the window flow, masked and unmasked, at every fill of the slots."""
    jv, js = _run(jval, jnp.asarray, n_passes=n_passes)
    tv, ts = _run(tval, torch.from_numpy, n_passes=n_passes)
    for mode in ("forward", "backward"):
        for round_idx in (False, True):
            np.testing.assert_allclose(
                tv.window_iwe(ts, mode=mode, round_idx=round_idx).numpy(),
                np.asarray(jv.window_iwe(js, mode=mode,
                                         round_idx=round_idx)),
                **LOC_TOL, err_msg=f"{mode} {round_idx}")
    for mode in (None, "backward", "forward"):
        for mask in (False, True):
            np.testing.assert_allclose(
                tv.window_flow(ts, mode=mode, mask=mask).numpy(),
                np.asarray(jv.window_flow(js, mode=mode, mask=mask)),
                **LOC_TOL, err_msg=f"{mode} {mask}")


def test_forward_prop_flow_once_takes_one_dt_per_map(rng):
    """One splat of several maps, each with its own ``dt``, equals one call
    per map (the Linear window flow's batching)."""
    maps = torch.from_numpy(
        rng.normal(size=(3, *V_RES, 2)).astype(np.float32) * 2)
    dts = [3.0, 2.0, 1.0]
    batched = tval.forward_prop_flow_once(
        maps, V_RES, torch.tensor(dts).view(-1, 1, 1))
    for i, dt in enumerate(dts):
        np.testing.assert_allclose(
            batched[i].numpy(),
            tval.forward_prop_flow_once(maps[i:i + 1], V_RES, dt)[0].numpy(),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            batched[i].numpy(),
            np.asarray(jval.forward_prop_flow_once(
                jnp.asarray(maps[i:i + 1].numpy()), V_RES, dt))[0],
            **LOC_TOL)
