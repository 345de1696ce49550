"""The registry options the port took over last, against the JAX package on
the same numpy inputs: ``norm: IN`` and ``model.compute_dtype`` in the
models, and the Iterative loss's ``batched_sweep``, and JAX's
``triangular_warp: false`` and ``warp_remat`` against the port's one loss
(it has no field for either); then ``norm: IN`` through both CLIs.

Tolerances:

* ``norm: IN`` in float32: 2e-5 x max |flow|. The two packages compute the
  variance by different formulas (Flax ``E[x^2] - E[x]^2``, torch two-pass),
  which moves a normalised map by ~1e-6; measured 2.2e-6 and 3.1e-6.
* ``compute_dtype: bfloat16``: bf16 level, three times the JAX package's
  own bf16-vs-f32 gap on the same input (measured 0.53-1.05 times it),
  and the port's own bf16-vs-f32 gap at least a quarter of JAX's
  (measured 0.90-1.05 times it), so a port that computed in float32
  fails. A bf16 conv layer agrees with JAX's bit for bit; XLA's CPU
  elementwise ops in bf16 round apart from torch's (the sigmoid: one bf16
  ulp on a third of the elements, measured), and the layers carry it on.
* The loss options: the loss-parity tolerance of
  ``tests/test_torch_objectives.py`` (rtol 1e-4 on the value and on the
  flow gradient, with an atol of 1e-4 x max |gradient|); JAX's scan table
  against the port's triangular one, masks exactly, locations to 1e-5
  (the triangular table's test); a world-of-one ``event_axis``
  bitwise.
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eval_flow
import eval_flow_torch
import train_flow
import train_flow_torch
from taming_event_flow_tpu.configs import YAMLParser as JaxParser
from taming_event_flow_tpu import objectives as jobj
from taming_event_flow_tpu.models import build_model as jax_build_model
from taming_event_flow_tpu.objectives.iterative import warp_table as jtable
from taming_event_flow_tpu.tracking import load_checkpoint as jax_load_ckpt
from taming_event_flow_tpu.tracking.store import TrackingStore as JaxStore
from taming_event_flow_tpu_torch import objectives as tobj
from taming_event_flow_tpu_torch import tracking
from taming_event_flow_tpu_torch.configs import YAMLParser
from taming_event_flow_tpu_torch.data import write_synthetic_h5
from taming_event_flow_tpu_torch.models import (
    build_model,
    flax_params_to_state_dict,
)

from .test_torch_objectives import RES, assert_match, make_inputs
from .test_torch_objectives import port_cfg
from .test_torch_objectives import value_and_grad, world_of_one
from .test_torch_registry_cli import (
    LOSS_RTOL,
    METRIC_TOL,
    _losses,
    _params,
)
from .test_torch_eval_cli import eval_cfg
from .test_torch_train_cli import RES as CLI_RES
from .test_torch_train_cli import train_cfg, write_cfg
from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

IN_TOL = 2e-5
BF16_GAP = 3.0
BF16_OWN_GAP = 0.25  # the port's bf16-vs-f32 gap, at least, x JAX's
TINY = {"base_channels": 4, "num_encoders": 3, "num_residual_blocks": 1}
X_SHAPE = (2, 20, 24, 2)  # padded to 24 x 24: IN sees the zero rows


def both(flows, events, pol, grad_mask, **cfg_kw):
    """(value, flow grad) of the JAX loss (jitted: one compile in place of
    a dispatch per op) and of the port's."""
    jcfg = jobj.LossConfig(res=RES, **cfg_kw)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda f: jobj.iterative_loss(f, jnp.asarray(events),
                                      jnp.asarray(pol),
                                      jnp.asarray(grad_mask), jcfg)
    ))(jnp.asarray(flows))
    tv, tg = value_and_grad(tobj.LOSS_REGISTRY["Iterative"], flows,
                            (events, pol, grad_mask), port_cfg(**cfg_kw))
    return (float(jv), np.asarray(jg)), (float(tv), tg.numpy())


def jax_pair(cfg, rng, passes=2):
    """Flows (and carries) of ``passes`` passes of the JAX model of
    ``cfg``, with its parameters drawn then jittered (so that no bias
    stays zero) and their port ``state_dict``."""
    jm = jax_build_model(dict(cfg))
    x = rng.integers(0, 3, (passes,) + X_SHAPE).astype(np.float32)
    carry = jm.init_state(*X_SHAPE[:3])
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[0]),
                     carry)["params"]
    keys = iter(jax.random.split(jax.random.PRNGKey(2), 64))
    params = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(next(keys), a.shape), params)
    flows = []
    for k in range(passes):
        f, carry = jm.apply({"params": params}, jnp.asarray(x[k]), carry)
        flows.append(np.asarray(f))
    sd = flax_params_to_state_dict(jax.tree.map(np.asarray, params))
    return x, np.stack(flows), carry, sd


def port_run(cfg, sd, x):
    model = build_model(dict(cfg), device="cpu")
    model.load_state_dict(sd)
    carry = model.init_state(*X_SHAPE[:3])
    flows = []
    with torch.no_grad():
        for xk in x:
            f, carry = model(torch.from_numpy(xk), carry)
            flows.append(f.numpy())
    return np.stack(flows), carry, model


@pytest.mark.parametrize("name", ["RecEVFlowNet", "EVFlowNet"])
def test_norm_in_matches_jax(rng, name):
    """``norm: IN``: a GroupNorm of group size 1 after every encoder,
    decoder and prediction conv, none in the resblocks, as the JAX model
    has it."""
    cfg = dict(TINY, name=name, norm="IN")
    x, jflows, _, sd = jax_pair(cfg, rng)
    norms = {k for k in sd if ".norm_layer." in k}
    assert norms and not any("resblocks" in k for k in norms)
    assert any(k.startswith("arch.preds.") for k in norms)
    tflows, _, _ = port_run(cfg, sd, x)
    scale = np.abs(jflows).max()
    assert np.abs(tflows - jflows).max() <= IN_TOL * scale
    # a parameter the port has no module for still raises
    bad = {"arch": {"encoder_0": {"conv": {"BatchNorm_0": {
        "scale": np.ones(4, np.float32)}}}}}
    with pytest.raises(KeyError):
        flax_params_to_state_dict(bad)


def test_norm_bn_still_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(dict(TINY, norm="BN"), device="cpu")


@pytest.mark.parametrize("name,norm", [
    ("RecEVFlowNet", "IN"), ("EVFlowNet", None), ("RecFireFlowNet", None)])
def test_compute_dtype_matches_jax(rng, name, norm):
    """``compute_dtype: bfloat16``: the flows come back float32, a
    recurrent carry stays float32, the parameters stay float32, and the
    flows sit within bf16 level of the JAX package's bf16 flows."""
    cfg = dict(TINY, name=name, norm=norm)
    if name == "RecFireFlowNet":
        cfg = {"name": name, "base_channels": 4}
    x, jf32, _, sd = jax_pair(cfg, rng)
    bf = dict(cfg, compute_dtype="bfloat16")
    _, jbf, jcarry, _ = jax_pair(bf, np.random.default_rng(42))
    tbf, tcarry, model = port_run(bf, sd, x)
    assert tbf.dtype == np.float32
    assert all(c.dtype == torch.float32 for c in tcarry)
    assert [np.asarray(c).dtype for c in jcarry] == [np.float32] * len(
        tcarry)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    gap = np.abs(jbf - jf32).max()
    assert gap > 0  # the bf16 convolutions really ran
    assert np.abs(tbf - jbf).max() <= BF16_GAP * gap
    tf32, _, _ = port_run(cfg, sd, x)
    np.testing.assert_allclose(tf32, jf32, rtol=0,
                               atol=IN_TOL * np.abs(jf32).max())
    # the port's bf16 computed in bf16: as far from its float32 as JAX's
    assert np.abs(tbf - tf32).max() >= BF16_OWN_GAP * gap


@pytest.mark.parametrize("stride,activation", [(1, "relu"), (2, None)])
def test_compute_dtype_conv_layer_bitwise(rng, stride, activation):
    """One ``ConvLayer`` in bfloat16: the output's dtype and every bit of
    it equal to JAX's (the bias added to the rounded convolution, as
    ``flax.linen.Conv`` adds it)."""
    from taming_event_flow_tpu.models.blocks import ConvLayer as JaxConv
    from taming_event_flow_tpu_torch.models.blocks import (
        ConvLayer,
        set_compute_dtype,
    )

    x = rng.normal(size=(2, 20, 24, 6)).astype(np.float32)
    jm = JaxConv(features=8, stride=stride, activation=activation,
                 dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(3),
                                              a.shape), params)
    jy = jm.apply({"params": params}, jnp.asarray(x))
    assert jy.dtype == jnp.bfloat16
    tm = ConvLayer(6, 8, stride=stride, activation=activation)
    with torch.no_grad():
        tm.conv2d.weight.copy_(torch.tensor(np.asarray(
            params["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)))
        tm.conv2d.bias.copy_(torch.tensor(np.asarray(
            params["Conv_0"]["bias"])))
    set_compute_dtype(tm, "bfloat16")
    with torch.no_grad():
        ty = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert ty.dtype == torch.bfloat16
    assert tm.conv2d.weight.dtype == torch.float32
    np.testing.assert_array_equal(
        ty.float().permute(0, 2, 3, 1).numpy(),
        np.asarray(jy.astype(jnp.float32)))


def test_scan_table_matches_jax_and_triangular(rng):
    """``triangular_warp: false``: JAX's scan table (``warp_table``) is the
    port's triangular table, location for location and mask for mask, so
    the port needs no such option; JAX's scan loss against the port's one
    loss."""
    passes = 4
    flows, events, pol, gm = make_inputs(rng, passes)
    ts = events[..., 0:1] + np.arange(passes, dtype=np.float32).reshape(
        passes, 1, 1, 1)
    fl = flows[:, 0]
    jl, jm = jtable(jnp.asarray(fl), jnp.asarray(events[..., 1:3]),
                    jnp.asarray(ts), jnp.asarray(pol), RES,
                    grad_mask=jnp.asarray(gm))
    t = torch.from_numpy
    tl, tm = tobj.warp_table_triangular(
        t(fl), t(events[..., 1:3]), t(ts), t(pol), RES, grad_mask=t(gm))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    j, got = both(flows, events, pol, gm, passes_loss=passes,
                  triangular_warp=False)
    assert_match(j, got)


@pytest.mark.parametrize("mode", ["two", "four"])
@pytest.mark.parametrize("border", [True, False])
def test_batched_sweep_matches_jax(rng, mode, border):
    """``batched_sweep: true``: loss and flow gradient against JAX's
    ``batched_sweep=True``, and the value against the port's looped sweep."""
    passes = 4 if mode == "four" else 3
    inputs = make_inputs(rng, passes, b=2)
    kw = dict(passes_loss=passes, iterative_mode=mode,
              border_compensation=border)
    j, t = both(*inputs, batched_sweep=True, **kw)
    assert np.abs(t[1]).max() > 0
    assert_match(j, t)
    looped = value_and_grad(tobj.LOSS_REGISTRY["Iterative"], inputs[0],
                            inputs[1:], tobj.LossConfig(res=RES, **kw))
    assert_match((float(looped[0]), looped[1].numpy()), t)


@pytest.mark.parametrize("triangular", [True, False])
def test_warp_remat_is_bitwise(rng, triangular):
    """``warp_remat: true`` has no field in the port (no per-step residuals
    to drop): JAX's remat loss with either warp table against the port's
    one loss."""
    passes = 3
    flows, events, pol, gm = make_inputs(rng, passes)
    j, t = both(flows, events, pol, gm, passes_loss=passes,
                triangular_warp=triangular, warp_remat=True)
    assert_match(j, t)


def test_batched_sweep_event_axis_world_of_one(rng, tmp_path):
    """One all-reduce of the ``[T*B]`` IWE over a world of one rank gives
    the loss and flow gradient of ``event_axis=None``, bit for bit."""
    flows, events, pol, gm = make_inputs(rng, 3, b=2)
    cfg = tobj.LossConfig(res=RES, passes_loss=3, batched_sweep=True)
    loss_fn = tobj.LOSS_REGISTRY["Iterative"]
    ref = value_and_grad(loss_fn, flows, (events, pol, gm), cfg)
    with world_of_one(tmp_path) as group:
        one = value_and_grad(loss_fn, flows, (events, pol, gm), cfg,
                             event_axis=group)
    assert torch.equal(one[0], ref[0]) and torch.equal(one[1], ref[1])


def test_norm_in_cli_matches_jax(tmp_path):
    """``norm: IN`` through both CLIs (the registry CLI test's protocol):
    one epoch from the JAX trainer's initial parameters, epoch loss within
    1e-4; the JAX run's weights evaluated by both eval CLIs within the
    pipeline-parity tolerance."""
    ds = tmp_path / "data"
    write_synthetic_h5(str(ds / "seq0.h5"), n_events=3000, res=CLI_RES,
                       n_flow_frames=8, seed=1)
    tcfg = train_cfg(str(ds), n_epochs=1)
    tcfg["model"]["norm"] = "IN"
    ecfg = eval_cfg(str(ds), store=False)
    tpath = write_cfg(tmp_path / "train.yml", tcfg)
    epath = write_cfg(tmp_path / "eval.yml", ecfg)

    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jax_runid = train_flow.train(argparse.Namespace(
        config=tpath, path_mlflow=str(jroot), path_cache="", prev_runid=""),
        JaxParser(tpath))
    store = tracking.TrackingStore(str(proot))
    init = store.start_run().info.run_id
    tracking.save_checkpoint(init, flax_params_to_state_dict(_params(
        tcfg, 2, jax.random.PRNGKey(tcfg["loader"]["seed"]))), store=store)
    runid = train_flow_torch.train(argparse.Namespace(
        config=tpath, path_mlflow=str(proot), path_cache="",
        prev_runid=init), YAMLParser(tpath), device="cpu")
    ref, got = _losses(jroot, jax_runid), _losses(proot, runid)
    assert len(ref) == 1 and np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)

    # the JAX run's weights, written into it as checkpoint.pt
    restored, _ = jax_load_ckpt(
        jax_runid, {"params": _params(tcfg, 2, jax.random.PRNGKey(0)),
                    "opt_state": None, "step": np.int64(0),
                    "epoch": np.int64(0)}, store=JaxStore(str(jroot)))
    tracking.save_checkpoint(
        jax_runid, flax_params_to_state_dict(
            jax.tree.map(np.asarray, restored["params"])),
        store=tracking.TrackingStore(str(jroot)))
    results = {}
    for tag, module, parser_cls, kw in (
            ("jax", eval_flow, JaxParser, {}),
            ("port", eval_flow_torch, YAMLParser, {"device": "cpu"})):
        results[tag] = module.test(argparse.Namespace(
            runid=jax_runid, config=epath, path_mlflow=str(jroot),
            path_results=str(tmp_path / f"results_{tag}") + "/"),
            parser_cls(epath), **kw)
    jres, pres = results["jax"], results["port"]
    assert jres["AEE"] and sorted(pres) == sorted(jres)
    for name, per_seq in jres.items():
        for seq, v in per_seq.items():
            np.testing.assert_allclose(float(pres[name][seq]), float(v),
                                       err_msg=f"{name} {seq}", **METRIC_TOL)
