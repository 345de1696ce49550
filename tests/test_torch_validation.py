"""The port's IterativeValidation against the JAX package's: the same passes
(events, flow maps, masks from a numpy seed) through both, with the
backward re-warp and the forward-propagated maps on, in both ``n_active``
forms; then the window metrics and accessors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taming_event_flow_tpu.metrics import validation as jval
from taming_event_flow_tpu_torch.metrics import validation as tval

from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RES = (12, 16)
P, B, N = 3, 2, 40
LOC_TOL = dict(rtol=1e-4, atol=1e-4)


def _passes(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(P):
        ev = np.zeros((B, N, 4), np.float32)
        ev[..., 0] = np.sort(rng.uniform(0, 1, (B, N)), axis=1)
        ev[:, 0, 0] = 0.0
        ev[..., 1] = rng.integers(0, RES[0], (B, N))
        ev[..., 2] = rng.integers(0, RES[1], (B, N))
        ev[..., 3] = rng.choice([-1.0, 1.0], (B, N))
        ev[:, -N // 8:] = 0.0  # padding rows
        pol = np.stack([ev[..., 3] > 0, ev[..., 3] < 0], -1).astype(
            np.float32)
        flow = (rng.normal(size=(B, *RES, 2)) * 1.5).astype(np.float32)
        emask = (rng.uniform(size=(B, *RES, 1)) > 0.5).astype(np.float32)
        out.append((flow, ev, pol, emask))
    return out


def _run(mod, to, cfg, passes, n_active_form):
    kw = {"device": "cpu"} if mod is tval else {}
    val = mod.IterativeValidation(cfg, B, N, **kw)
    state = val.init()
    for k, (flow, ev, pol, emask) in enumerate(passes):
        state = val.update(state, to(flow), to(ev), to(pol), to(emask),
                           n_active=(k + 1) if n_active_form else None)
    return val, state


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def jax_run():
    cfg = jval.ValConfig(res=RES, passes=P)
    return _run(jval, jnp.asarray, cfg, _passes(0), n_active_form=True)


@pytest.mark.parametrize("n_active_form", [True, False])
def test_update_state_matches_jax(jax_run, n_active_form):
    _, js = jax_run
    cfg = tval.ValConfig(res=RES, passes=P)
    _, ts = _run(tval, torch.from_numpy, cfg, _passes(0), n_active_form)
    assert ts.pass_idx == int(js.pass_idx) == P
    for name in ("fw_loc", "bw_loc", "warp_indices", "accum_flow",
                 "fw_prop_flow"):
        np.testing.assert_allclose(_np(getattr(ts, name)),
                                   _np(getattr(js, name)), **LOC_TOL,
                                   err_msg=name)
    for name in ("fw_mask", "bw_mask", "out_mask", "fw_ts", "event_ts",
                 "pol_mask", "flow_maps"):
        np.testing.assert_array_equal(_np(getattr(ts, name)),
                                      _np(getattr(js, name)), err_msg=name)


def test_metrics_and_accessors_match_jax(jax_run, rng):
    jv, js = jax_run
    cfg = tval.ValConfig(res=RES, passes=P)
    tv, ts = _run(tval, torch.from_numpy, cfg, _passes(0), True)

    rsat_t, fwl_t = tv.rsat_fwl(ts)
    rsat_j, fwl_j = jv.rsat_fwl(js)
    np.testing.assert_allclose(rsat_t.numpy(), np.asarray(rsat_j),
                               rtol=1e-5)
    np.testing.assert_allclose(float(fwl_t), float(fwl_j), rtol=1e-5)
    # the fused FWL is bitwise the standalone one
    assert float(tv.fwl(ts)) == float(fwl_t)
    np.testing.assert_allclose(tv.rsat(ts).numpy(), rsat_t.numpy(),
                               rtol=1e-6)

    for mode in ("backward", "forward", None):
        np.testing.assert_allclose(
            tv.window_flow(ts, mode=mode, mask=True).numpy(),
            np.asarray(jv.window_flow(js, mode=mode, mask=True)),
            **LOC_TOL, err_msg=str(mode))
    for mode in ("forward", "backward"):
        np.testing.assert_allclose(
            tv.window_iwe(ts, mode=mode).numpy(),
            np.asarray(jv.window_iwe(js, mode=mode)), **LOC_TOL)
    np.testing.assert_allclose(tv.window_events(ts).numpy(),
                               np.asarray(jv.window_events(js)), **LOC_TOL)

    pred = (tv.window_flow(ts, mode="backward") * P).numpy()
    gt = rng.normal(size=pred.shape).astype(np.float32)
    gt[:, :2] = 0.0  # invalid GT pixels
    emask = (rng.uniform(size=pred.shape[:3] + (1,)) > 0.3).astype(
        np.float32)
    for kw in ({}, {"event_mask": emask, "res_aee": (8, 12),
                    "vertical_crop_aee": 6}):
        t_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in kw.items()}
        np.testing.assert_allclose(
            float(tval.compute_aee(torch.from_numpy(pred),
                                   torch.from_numpy(gt), **t_kw)),
            float(jval.compute_aee(jnp.asarray(pred), jnp.asarray(gt), **kw)),
            rtol=1e-5)


def test_reset_equals_init():
    cfg = tval.ValConfig(res=RES, passes=P)
    val, state = _run(tval, torch.from_numpy, cfg, _passes(1), True)
    fresh = val.init()
    state = val.reset(state)
    assert state.pass_idx == 0
    for a, b in zip(state.tensors(), fresh.tensors()):
        assert torch.equal(a, b)


def test_round_ts_and_disabled_tracking():
    cfg = tval.ValConfig(res=RES, passes=P, round_ts=True, track_bw=False,
                         track_fw_prop=False)
    jcfg = jval.ValConfig(res=RES, passes=P, round_ts=True, track_bw=False,
                          track_fw_prop=False)
    tv, ts = _run(tval, torch.from_numpy, cfg, _passes(2), True)
    jv, js = _run(jval, jnp.asarray, jcfg, _passes(2), True)
    np.testing.assert_array_equal(ts.event_ts.numpy(),
                                  np.asarray(js.event_ts))
    np.testing.assert_allclose(ts.accum_flow.numpy(),
                               np.asarray(js.accum_flow), **LOC_TOL)
    with pytest.raises(ValueError):
        tv.window_iwe(ts, mode="backward")
    with pytest.raises(ValueError):
        tv.window_flow(ts, mode="forward")
