"""The port's train step against the JAX package's: the tiny RecEVFlowNet
and drifting-cloud window of ``tests/test_training.py``, identical
parameters carried across with ``flax_params_to_state_dict`` (which also
carries the JAX gradient tree), float32 on the CPU. Plus the optimizers
against optax, the detached carry, and the entry points' device rule.

Tolerances: the first step's loss to rtol 1e-5, each parameter's gradient
to a max abs error of 1e-4 x that tensor's max |g| (convolutions and the
warp sum in other orders on the two sides); the 3-step loss history to
rtol 1e-4 (Adam's first updates are ~lr x sign(g), so gradient elements
near zero pass their rounding on to the weights); optimizer updates to
rtol 1e-6 plus an atol of 1e-4 x lr (optax computes Adam's bias correction
``1 - 0.999**t`` in float32, 3e-5 off at t = 2; torch in float64).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from taming_event_flow_tpu.objectives import LossConfig as JLossConfig
from taming_event_flow_tpu.objectives import iterative_loss as j_iterative
from taming_event_flow_tpu.training import build_optimizer as j_build_opt
from taming_event_flow_tpu.training import make_train_step as j_make_step
from taming_event_flow_tpu.training.step import (
    init_train_state as j_init_state,
)
from taming_event_flow_tpu_torch.models import (
    build_model,
    flax_params_to_state_dict,
)
from taming_event_flow_tpu_torch.objectives import LossConfig
from taming_event_flow_tpu_torch.training import (
    build_optimizer,
    clip_by_global_norm_,
    init_train_state,
    make_train_step,
    reset_carry,
    unpack_window,
)

from .test_training import P_PASSES, RES, make_window, tiny_model

FLOW_SCALING = 4.0
OPT = {"name": "Adam", "lr": 1e-3}
CLIP = 100.0
TINY = {"name": "RecEVFlowNet", "base_channels": 8, "num_encoders": 2,
        "num_residual_blocks": 1, "min_size": 4, "final_w_scale": 0.01}


def torch_window(w):
    return {k: torch.from_numpy(v) for k, v in w.items()}


@pytest.fixture(scope="module")
def pair():
    """The JAX model, its optimizer and its initial state."""
    jm = tiny_model()
    jopt = j_build_opt(OPT, clip_grad=CLIP)
    return jm, jopt, j_init_state(jm, jopt, 1, RES[0], RES[1], 2)


def fresh_torch(pair):
    """The port's model holding the JAX parameters, its train step and a
    zero state."""
    _, _, jstate = pair
    tm = build_model(TINY, num_bins=2, device="cpu")
    tm.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, jstate.params)))
    opt = build_optimizer(OPT, tm.parameters(), clip_grad=CLIP, device="cpu")
    step = make_train_step(tm, opt, LossConfig(res=RES, passes_loss=P_PASSES),
                           flow_scaling=FLOW_SCALING, res=RES)
    return tm, step, init_train_state(tm, 1, RES[0], RES[1], device="cpu")


def test_first_step_gradients_match_jax(pair, rng):
    jm, _, jstate = pair
    w = make_window(rng, 1)
    cfg = JLossConfig(res=RES, passes_loss=P_PASSES)

    def jloss(params):
        def body(carry, x):
            flows, carry = jm.apply({"params": params}, x, carry)
            return carry, flows * FLOW_SCALING

        _, flows = jax.lax.scan(body, jstate.carry,
                                jnp.asarray(w["net_input"]))
        return j_iterative(flows, jnp.asarray(w["event_list"]),
                           jnp.asarray(w["pol_mask"]),
                           jnp.asarray(w["grad_mask"]), cfg)

    jv, jg = jax.value_and_grad(jloss)(jstate.params)
    jgrads = flax_params_to_state_dict(jax.tree.map(np.asarray, jg))

    tm, step, state = fresh_torch(pair)
    _, loss = step(state, torch_window(w))
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-5)
    named = dict(tm.named_parameters())
    assert set(named) == set(jgrads)
    for name, p in named.items():
        ref = jgrads[name].numpy()
        got = p.grad.numpy()
        scale = np.abs(ref).max()
        assert scale > 0, name
        err = np.abs(got - ref).max()
        assert err <= 1e-4 * scale, (name, err, scale)


def test_loss_history_matches_jax(pair, rng):
    jm, jopt, jstate = pair
    w = make_window(rng, 1)
    jstep = j_make_step(jm, jopt, JLossConfig(res=RES, passes_loss=P_PASSES),
                        "Iterative", flow_scaling=FLOW_SCALING, donate=False,
                        res=RES)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    _, step, state = fresh_torch(pair)
    tw = torch_window(w)
    jl, tl = [], []
    for _ in range(3):
        jstate, loss = jstep(jstate, jw)
        jl.append(float(loss))
        state, loss = step(state, tw)
        tl.append(float(loss))
    assert state.step == 3
    assert len(set(tl)) == 3  # the updates reach the loss
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_window_without_net_input_derives_it(rng):
    """``unpack_window`` builds the count input from the event lists,
    element for element the window's own."""
    w = make_window(rng, 1)
    full = unpack_window(torch_window(w))
    del w["net_input"]
    derived = unpack_window(torch_window(w), res=RES)
    torch.testing.assert_close(derived["net_input"], full["net_input"],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="res"):
        unpack_window(torch_window(w))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        unpack_window({"event_txy": torch.zeros(1)})


def test_carry_detaches(pair, rng):
    _, step, state = fresh_torch(pair)
    w = torch_window(make_window(rng, 1))
    state, _ = step(state, w)
    assert all(c.grad_fn is None and not c.requires_grad
               for c in state.carry)
    assert any(float(c.abs().sum()) > 0 for c in state.carry)
    zero = reset_carry(state.carry, torch.tensor([True]))
    assert all(float(c.abs().sum()) == 0 for c in zero)
    # a second step backpropagates into this window only
    state, loss = step(state, w)
    assert np.isfinite(float(loss))


def _optax_update(name, clip, params, grads_seq, lr):
    tx = j_build_opt({"name": name, "lr": lr}, clip_grad=clip)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(p)
    for g in grads_seq:
        up, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, p)
        p = optax.apply_updates(p, up)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("name", ["Adam", "AdamW", "SGD"])
@pytest.mark.parametrize("clip", [None, 1e3, 0.5])
def test_optimizer_update_matches_optax(rng, name, clip):
    """Two updates on random gradients (the 0.5 clip triggers, the 1e3 one
    does not)."""
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads_seq = [{k: rng.normal(size=v.shape).astype(np.float32)
                  for k, v in params.items()} for _ in range(2)]
    lr = 1e-2
    ref = _optax_update(name, clip, params, grads_seq, lr)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = build_optimizer({"name": name, "lr": lr}, tp.values(),
                          clip_grad=clip, device="cpu")
    for g in grads_seq:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), ref[k], rtol=1e-6,
                                   atol=1e-4 * lr)


def test_clip_by_global_norm_matches_optax(rng):
    g = {"a": rng.normal(size=(6,)).astype(np.float32) * 10,
         "b": rng.normal(size=(2, 2)).astype(np.float32)}
    for max_norm in (1.0, 1e4):
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            {k: jnp.asarray(v) for k, v in g.items()}, None)
        ps = [torch.nn.Parameter(torch.zeros(v.shape)) for v in g.values()]
        for p, v in zip(ps, g.values()):
            p.grad = torch.from_numpy(v.copy())
        clip_by_global_norm_(ps, max_norm)
        for p, k in zip(ps, g):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref[k]),
                                       rtol=1e-6)


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no ``device`` given, the training entry points
    raise; given the CPU they refuse a model that lies elsewhere."""
    tm = build_model(TINY, num_bins=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(tm, 1, *RES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_optimizer(OPT, tm.parameters())
    meta = build_model(TINY, num_bins=2, device="cpu").to("meta")
    with pytest.raises(ValueError, match="not on cpu"):
        init_train_state(meta, 1, *RES, device="cpu")
    with pytest.raises(ValueError, match="not on cpu"):
        build_optimizer(OPT, meta.parameters(), device="cpu")
    with pytest.raises(ValueError, match="Unknown optimizer"):
        build_optimizer({"name": "lamb"}, tm.parameters(), device="cpu")
