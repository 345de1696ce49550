"""The port's Iterative contrast-max loss against the JAX package's, on the
same numpy inputs: value and flow gradient (the JAX package on the CPU runs
its separable einsums, whose derivative stencil is the Pallas one; the port
runs its plain PyTorch versions through its autograd Functions).

Tolerance: rtol 1e-4 on the value; on the gradient rtol 1e-4 plus an atol
of 1e-4 x the largest |gradient|. Both sides sum in float32 in different
orders, and single elements are ill-conditioned: a pixel whose IWE holds the
tiny corner weight of one event puts ``ts / iwe`` under a division by that
weight. On the batch-2, no-border-compensation, unscaled case the JAX
package's own gradient moves by 1.5e-5 (of a largest 0.43) when the flows
are perturbed by one ulp."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taming_event_flow_tpu import objectives as jobj
from taming_event_flow_tpu_torch import objectives as tobj
from taming_event_flow_tpu_torch.parallel import (
    init_distributed,
    make_event_mesh,
)

from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RES = (8, 10)
B = 1
N_GRAD = 12
N_DET = 6
N = N_GRAD + N_DET
S = 2  # flow scales
RTOL = 1e-4
# the JAX package's scan knobs: the port has no field for them and runs
# its one loss, which the JAX loss with any of them must match
JAX_ONLY = ("triangular_warp", "warp_remat", "scan_unroll")


def port_cfg(**cfg_kw):
    """The port's ``LossConfig`` of the JAX config ``cfg_kw``."""
    return tobj.LossConfig(res=RES, **{k: v for k, v in cfg_kw.items()
                                       if k not in JAX_ONLY})


def make_inputs(rng, passes, b=B):
    """Random flows and events as ``tests/test_objectives.py`` makes them:
    integer pixels, window ts anchored at 0, a detached event subset."""
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
    """(value, flow grad) of the JAX loss and of the port's."""
    jcfg = jobj.LossConfig(res=RES, **cfg_kw)
    jv, jg = jax.value_and_grad(
        lambda f: jobj.iterative_loss(f, jnp.asarray(events),
                                      jnp.asarray(pol),
                                      jnp.asarray(grad_mask), jcfg)
    )(jnp.asarray(flows))
    tf = torch.from_numpy(flows).requires_grad_()
    tv = tobj.iterative_loss(tf, torch.from_numpy(events),
                             torch.from_numpy(pol),
                             torch.from_numpy(grad_mask),
                             port_cfg(**cfg_kw))
    tv.backward()
    return (float(jv), np.asarray(jg)), (float(tv.detach()), tf.grad.numpy())


def assert_match(j, t):
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL)
    np.testing.assert_allclose(t[1], j[1], rtol=RTOL,
                               atol=RTOL * np.abs(j[1]).max())


@pytest.mark.parametrize(
    "passes,scales,mode,round_ts",
    [
        (4, 1, "two", False),
        (4, 2, "two", False),
        (4, 1, "one", False),
        (3, 1, "one", True),
        (2, 1, "four", False),  # mode four doubles the configured 2
    ],
)
def test_iterative_loss_matches_jax(rng, passes, scales, mode, round_ts):
    eff = passes * 2 if mode == "four" else passes
    inputs = make_inputs(rng, eff)
    j, t = both(*inputs, passes_loss=eff, scales_loss=scales,
                iterative_mode=mode, round_ts=round_ts)
    assert np.abs(t[1]).max() > 0
    assert_match(j, t)


def test_iterative_loss_smoothing_terms_match_jax(rng):
    inputs = make_inputs(rng, 3)
    j, t = both(*inputs, passes_loss=3, flow_spat_smooth_weight=0.5,
                flow_temp_smooth_weight=0.3)
    assert_match(j, t)


@pytest.mark.parametrize("b,border,scaling", [(2, True, True),
                                             (1, False, False)])
def test_iterative_loss_batch_and_border_options(rng, b, border, scaling):
    inputs = make_inputs(rng, 3, b=b)
    j, t = both(*inputs, passes_loss=3, border_compensation=border,
                loss_scaling=scaling)
    assert_match(j, t)


@pytest.mark.parametrize("name", ["spatial", "temporal"])
def test_smoothing_terms_match_jax(rng, name):
    flows = rng.normal(size=(2, 3, RES[0], RES[1], 2)).astype(np.float32)
    if name == "spatial":
        jfn = lambda f: jobj.flow_spatial_smoothing([f, f * 0.5], 0.7)  # noqa
        tfn = lambda f: tobj.flow_spatial_smoothing([f, f * 0.5], 0.7)  # noqa
    else:
        jfn = lambda f: jobj.flow_temporal_smoothing([f], RES, 0.7)  # noqa
        tfn = lambda f: tobj.flow_temporal_smoothing([f], RES, 0.7)  # noqa
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(flows))
    tf = torch.from_numpy(flows).requires_grad_()
    tv = tfn(tf)
    tv.backward()
    assert_match((float(jv), np.asarray(jg)),
                 (float(tv.detach()), tf.grad.numpy()))


def test_warp_table_matches_jax(rng):
    """The triangular table, location for location and mask for mask."""
    passes = 3
    flows, events, pol, grad_mask = make_inputs(rng, passes)
    pass_ids = np.arange(passes, dtype=np.float32).reshape(passes, 1, 1, 1)
    ts = events[..., 0:1] + pass_ids
    fl = flows[:, 0]
    from taming_event_flow_tpu.objectives.iterative import (
        warp_table_triangular as jtable,
    )

    jl, jm = jtable(jnp.asarray(fl), jnp.asarray(events[..., 1:3]),
                    jnp.asarray(ts), jnp.asarray(pol), RES)
    t = torch.from_numpy
    tl, tm = tobj.warp_table_triangular(t(fl), t(events[..., 1:3]), t(ts),
                                        t(pol), RES)
    assert tl.shape == (passes + 1, passes, B, N, 2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_gradient_gating_and_detached_masks(rng):
    """Events with grad_mask 0 pass no gradient to the flow; the table's
    masks carry none at all."""
    passes = 3
    flows, events, pol, _ = make_inputs(rng, passes)
    t = torch.from_numpy
    fl = t(flows[:, 0] * 0.1).requires_grad_()  # few events leave
    ts = t(events[..., 0:1]) + torch.arange(passes).reshape(-1, 1, 1, 1)
    gm = torch.zeros(passes, B, N, 1)
    gm[:, :, 1:2] = 1.0  # one gradient event per window
    tl, tm = tobj.warp_table_triangular(fl, t(events[..., 1:3]), ts, t(pol),
                                        RES, grad_mask=gm)
    assert not tm.requires_grad
    (g_det,) = torch.autograd.grad(tl[..., 2:, :].sum(), fl,
                                   retain_graph=True)
    assert float(g_det.abs().sum()) == 0.0
    (g_grad,) = torch.autograd.grad(tl[..., 1:2, :].sum(), fl)
    assert float(g_grad.abs().sum()) > 0.0


def test_padding_invariance(rng):
    passes = 3
    flows, events, pol, gm = make_inputs(rng, passes)
    cfg = tobj.LossConfig(res=RES, passes_loss=passes)
    t = torch.from_numpy
    base = float(tobj.iterative_loss(t(flows), t(events), t(pol), t(gm), cfg))

    def pad(a):
        return np.concatenate(
            [a, np.zeros(a.shape[:2] + (7,) + a.shape[3:], a.dtype)], axis=2)

    padded = float(tobj.iterative_loss(t(flows), t(pad(events)), t(pad(pol)),
                                       t(pad(gm)), cfg))
    np.testing.assert_allclose(padded, base, rtol=1e-6)


@contextlib.contextmanager
def world_of_one(tmp_path):
    """A gloo process group of this process alone, and the event group of
    its (1 x 1) mesh."""
    init_distributed({"coordinator": f"file://{tmp_path / 'rdv'}",
                      "num_processes": 1, "process_id": 0}, device="cpu")
    try:
        yield make_event_mesh(1, 1).event_group
    finally:
        torch.distributed.destroy_process_group()


def value_and_grad(loss_fn, flows, inputs, cfg, **kw):
    f = torch.from_numpy(flows).requires_grad_()
    loss = loss_fn(f, *map(torch.from_numpy, inputs), cfg, **kw)
    loss.backward()
    return loss.detach(), f.grad


@pytest.mark.parametrize("knob", [
    {"triangular_warp": False}, {"batched_sweep": True},
    {"warp_remat": True}])
def test_unported_knobs_raise(rng, tmp_path, knob):
    """The three knobs that once raised here (the scan table,
    ``batched_sweep``, ``warp_remat``) now match the JAX loss with the same
    knob (the port's one loss where it has no such field); an
    ``event_axis`` over a world of one rank gives the loss and flow
    gradient of ``None``, bit for bit (its all-reduces are the identity),
    in both losses."""
    flows, events, pol, gm = make_inputs(rng, 2)
    cfg = port_cfg(passes_loss=2, **knob)
    t = torch.from_numpy
    assert_match(*both(flows, events, pol, gm, passes_loss=2, **knob))
    # the Linear loss runs (it has none of these knobs)
    assert torch.isfinite(tobj.LOSS_REGISTRY["Linear"](
        t(flows), t(events), t(pol), t(gm), cfg))
    plain = tobj.LossConfig(res=RES, passes_loss=2)
    with world_of_one(tmp_path) as group:
        for warping in ("Iterative", "Linear"):
            loss_fn = tobj.LOSS_REGISTRY[warping]
            ref = value_and_grad(loss_fn, flows, (events, pol, gm), plain)
            one = value_and_grad(loss_fn, flows, (events, pol, gm), plain,
                                 event_axis=group)
            assert torch.equal(one[0], ref[0]), warping
            assert torch.equal(one[1], ref[1]), warping


def test_loss_config_fields_match_jax():
    """The JAX fields in the JAX order and with its defaults, less the
    scan knobs the port has no use for."""
    shared = tuple(f for f in jobj.LossConfig._fields if f not in JAX_ONLY)
    assert tobj.LossConfig._fields == shared
    jdefaults = jobj.LossConfig(res=RES)
    assert (tobj.LossConfig(res=RES)
            == tuple(getattr(jdefaults, f) for f in shared))
    cfg = tobj.LossConfig(res=RES, passes_loss=8, scales_loss=3,
                          iterative_mode="four")
    jcfg = jobj.LossConfig(res=RES, passes_loss=8, scales_loss=3,
                           iterative_mode="four")
    assert cfg.passes_list == jcfg.passes_list
    assert cfg.delta_passes == jcfg.delta_passes
