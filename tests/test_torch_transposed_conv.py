"""``use_upsample_conv: false``, the transposed-conv decoder, against the
JAX package on the same numpy inputs: the layer alone (Flax's
``ConvTranspose(strides=2, padding="SAME")`` plus the activation), its VJP,
RecEVFlowNet and EVFlowNet built with the flag, the parameter and Adam
moment maps of ``ConvTranspose_0``, and the reference import's refusal.

Tolerances:

* the layer in float32: 1e-5 x max |y| (measured 0 to 1.7e-7);
* the layer in bfloat16: bitwise, as the bf16 conv layer of
  ``tests/test_torch_options.py`` (measured: equal at every shape);
* its VJP: rtol 1e-4 with an atol of 1e-6 x max |g| per tensor;
* the models over their passes: 1e-5 x max |flow| (measured 3.1e-7 and
  4.1e-7 without a norm, 2.0e-6 and 2.8e-6 with ``norm: IN``, whose
  variance the packages compute by different formulas), the recurrent
  carry likewise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from taming_event_flow_tpu.models import build_model as jax_build_model
from taming_event_flow_tpu.models.blocks import (
    TransposedConvLayer as JaxTransposedConvLayer,
)
from taming_event_flow_tpu.training import build_optimizer as jax_build_opt
from taming_event_flow_tpu_torch.models import (
    build_model,
    flax_params_to_state_dict,
    optax_state_to_torch,
    state_dict_to_flax_params,
)
from taming_event_flow_tpu_torch.models.blocks import (
    TransposedConvLayer,
    set_compute_dtype,
)
from taming_event_flow_tpu_torch.tracking import (
    load_reference_torch_checkpoint,
)
from taming_event_flow_tpu_torch.training import build_optimizer

from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

F32_TOL = 1e-5
VJP_RTOL = 1e-4
FLOW_TOL = 1e-5
TINY = {"base_channels": 8, "num_encoders": 2, "num_residual_blocks": 1,
        "use_upsample_conv": False, "min_size": 4}
X_SHAPE = (2, 20, 24, 2)  # 20 rows pad to 20, then 10 and 5: odd skips
PASSES = 3

# (kernel size, H, W, in, out): odd and even sides at k = 3 and 5
LAYER_SHAPES = [(3, 5, 7, 6, 3), (3, 4, 4, 8, 4), (5, 6, 5, 4, 2),
                (5, 3, 8, 5, 3)]


def _layer_pair(rng, k, h, w, cin, cout, dtype=None):
    """The JAX layer's output on a seeded input with drawn parameters (the
    bias made non-zero), and the port's layer loaded with them."""
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    jl = JaxTransposedConvLayer(cout, kernel_size=k, dtype=dtype)
    params = jl.init(jax.random.PRNGKey(k), jnp.asarray(x))["params"]
    params = jax.tree.map(np.asarray, params)
    params["ConvTranspose_0"]["bias"] = rng.normal(size=cout).astype(
        np.float32)
    # the layer's leaves under a decoder's path, through the port's map
    sd = flax_params_to_state_dict({"arch": {"decoder_0": params}})
    layer = TransposedConvLayer(cin, cout, kernel_size=k)
    layer.load_state_dict({k_.split("decoders.0.")[1]: v
                           for k_, v in sd.items()})
    set_compute_dtype(layer, dtype)
    return x, jl, params, layer


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", LAYER_SHAPES,
                         ids=["k3_odd", "k3_even", "k5_mixed", "k5_odd_even"])
def test_layer_matches_flax(rng, shape, dtype):
    """``TransposedConvLayer`` computes Flax's SAME transposed conv and the
    ReLU: 2H x 2W, float32 within 1e-5 of max |y|, bf16 bitwise (the bias
    added to the rounded conv, as Flax adds it)."""
    k, h, w, cin, cout = shape
    x, jl, params, layer = _layer_pair(rng, k, h, w, cin, cout, dtype)
    ref = np.asarray(jl.apply({"params": params}, jnp.asarray(x)),
                     dtype=np.float32)
    with torch.no_grad():
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == (torch.float32 if dtype is None else torch.bfloat16)
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 2 * h, 2 * w, cout)
    assert (ref > 0).any() and (ref == 0).any()  # the ReLU acts
    if dtype is None:
        assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", LAYER_SHAPES[::2], ids=["k3", "k5"])
def test_layer_vjp_matches_jax(rng, shape):
    """The layer's gradients with respect to input, kernel and bias for one
    cotangent equal ``jax.vjp``'s (the kernel's through the port's map)."""
    k, h, w, cin, cout = shape
    x, jl, params, layer = _layer_pair(rng, k, h, w, cin, cout)
    ct = rng.normal(size=(2, 2 * h, 2 * w, cout)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, xi: jl.apply({"params": p}, xi), params,
                     jnp.asarray(x))
    g_params, g_x = vjp(jnp.asarray(ct))
    want = flax_params_to_state_dict(
        {"arch": {"decoder_0": jax.tree.map(np.asarray, g_params)}})
    want = {n.split("decoders.0.")[1]: v.numpy() for n, v in want.items()}
    want["x"] = np.asarray(g_x)

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    layer(xt).backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    got = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    got["x"] = xt.grad.permute(0, 2, 3, 1).numpy()
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=VJP_RTOL,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)


_INITS = {}


def jax_model(name, norm=None):
    """The JAX model of ``TINY`` with the flag and its drawn parameters
    (numpy), initialised once a module."""
    key = (name, norm)
    if key not in _INITS:
        jm = jax_build_model(dict(TINY, name=name, norm=norm))
        params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros(X_SHAPE),
                                  jm.init_state(*X_SHAPE[:3]))["params"]
        _INITS[key] = jm, jax.tree.map(np.asarray, params)
    return _INITS[key]


def _jittered(params, seed=1):
    """``params`` moved so that no bias stays zero."""
    draw = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + 0.1 * draw.normal(
        size=a.shape)).astype(np.float32), params)


@pytest.mark.parametrize("norm", [None, "IN"], ids=["none", "IN"])
@pytest.mark.parametrize("name", ["RecEVFlowNet", "EVFlowNet"])
def test_models_match_jax(rng, name, norm):
    """Both UNet families with the flag: transposed-conv decoders (decoder
    1 takes the 8 channels of its skip and the 2 of the coarser
    prediction), no norm in a decoder under ``norm: IN``, and the flows of
    ``PASSES`` passes (RecEVFlowNet carrying its state) from the JAX
    model's parameters within 1e-5 of max |flow|."""
    cfg = dict(TINY, name=name, norm=norm)
    jm, params = jax_model(name, norm)
    params = _jittered(params)
    x = rng.integers(0, 3, (PASSES,) + X_SHAPE).astype(np.float32)
    carry = jm.init_state(*X_SHAPE[:3])
    assert set(params["arch"]["decoder_1"]) == {"ConvTranspose_0"}
    assert params["arch"]["decoder_1"]["ConvTranspose_0"]["kernel"].shape \
        == (3, 3, 10, 4)
    jflows = []
    apply = jax.jit(jm.apply)
    for xk in x:
        f, carry = apply({"params": params}, jnp.asarray(xk), carry)
        jflows.append(np.asarray(f))
    jflows = np.stack(jflows)

    sd = flax_params_to_state_dict(params)
    assert tuple(sd["arch.decoders.1.transposed_conv2d.weight"].shape) == (
        10, 4, 3, 3)
    assert not any(k.startswith("arch.decoders.") and "norm_layer" in k
                   for k in sd)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    tcarry = model.init_state(*X_SHAPE[:3])
    tflows = []
    with torch.no_grad():
        for xk in x:
            f, tcarry = model(torch.from_numpy(xk), tcarry)
            tflows.append(f.numpy())
    tflows = np.stack(tflows)
    scale = np.abs(jflows).max()
    assert tflows.shape == jflows.shape and scale > 0
    assert np.abs(tflows - jflows).max() <= FLOW_TOL * scale
    assert len(tcarry) == len(carry)
    for a, b in zip(tcarry, carry):
        b = np.asarray(b)
        got = a.permute(0, 2, 3, 1).numpy()
        assert np.abs(got - b).max() <= FLOW_TOL * max(np.abs(b).max(), 1.0)


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("name", ["RecEVFlowNet", "EVFlowNet"])
def test_params_round_trip_bitwise(name):
    """``state_dict_to_flax_params`` inverts ``flax_params_to_state_dict``
    on a tree with ``ConvTranspose_0`` leaves, bitwise; the port's model
    loads the converted ``state_dict``; and a transposed kernel becomes
    the torch weight ``K[::-1, ::-1].transpose(2, 3, 0, 1)``."""
    cfg = dict(TINY, name=name)
    params = jax_model(name)[1]
    sd = flax_params_to_state_dict(params)
    build_model(cfg, device="cpu").load_state_dict(sd)
    _assert_trees_equal(state_dict_to_flax_params(sd), params)
    for i in range(TINY["num_encoders"]):
        kernel = params["arch"][f"decoder_{i}"]["ConvTranspose_0"]["kernel"]
        np.testing.assert_array_equal(
            sd[f"arch.decoders.{i}.transposed_conv2d.weight"].numpy(),
            kernel[::-1, ::-1].transpose(2, 3, 0, 1))


def test_optax_moments_load_bitwise():
    """Adam's ``mu`` and ``nu`` after two optax updates of a model with the
    flag load into torch Adam through the same map: converted back, each
    is bitwise optax's, and the step is optax's count."""
    cfg = dict(TINY, name="RecEVFlowNet")
    params = jax_model(cfg["name"])[1]
    tx = jax_build_opt({"name": "Adam", "lr": 1e-3}, clip_grad=100.0)
    state = tx.init(params)
    leaves, struct = jax.tree.flatten(params)
    draw = np.random.default_rng(6)

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for _ in range(2):
        grads = jax.tree.unflatten(struct, [
            draw.normal(size=a.shape).astype(np.float32) for a in leaves])
        params, state = update(grads, state, params)
    from flax import serialization

    tree = jax.tree.map(np.asarray, serialization.to_state_dict(state))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, params)))
    opt = build_optimizer({"name": "Adam", "lr": 1e-3}, model.parameters(),
                          clip_grad=100.0, device="cpu")
    optax_state_to_torch(tree, model, opt)
    adam = [s for s in jax.tree.leaves(
        state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    named = list(model.named_parameters())
    assert any(n.endswith("transposed_conv2d.weight") for n, _ in named)
    for key, ref in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        back = state_dict_to_flax_params(
            {n: opt.state[p][key] for n, p in named})
        _assert_trees_equal(back, jax.tree.map(np.asarray, ref))
    assert {float(opt.state[p]["step"]) for _, p in named} == {
        float(adam.count)}


def test_seeded_init_is_lecun_normal():
    """The port's seeded transposed-conv weights follow Flax's defaults:
    a truncated normal of standard deviation ``sqrt(1 / (k * k * in))``
    before the truncation, within two of its pre-truncation deviations,
    and a zero bias."""
    model = build_model(dict(TINY, base_channels=32), device="cpu", seed=3)
    for dec in model.arch.decoders:
        w = dec.transposed_conv2d.weight.detach()
        std = np.sqrt(1.0 / w[:, 0].numel())
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
        assert abs(float(w.std()) / std - 1) < 0.1
        assert not dec.transposed_conv2d.bias.detach().any()


@pytest.mark.parametrize("name", ["RecEVFlowNet", "EVFlowNet"])
def test_norm_bn_still_raises(name):
    """``norm: BN``, which neither package trains, raises with the flag too,
    naming ROADMAP.md."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(dict(TINY, name=name, norm="BN"), device="cpu")


def test_reference_transposed_decoder_is_refused(tmp_path):
    """A reference ``model.pth`` with a transposed-conv decoder raises
    ``ValueError`` naming ROADMAP.md: the reference pads that layer
    otherwise than the JAX package and the port."""
    path = tmp_path / "model.pth"
    torch.save({"arch.preds.0.conv2d.bias": torch.zeros(2),
                "arch.decoders.0.transposed_conv2d.weight":
                    torch.zeros(16, 8, 3, 3)}, path)
    with pytest.raises(ValueError, match="ROADMAP"):
        load_reference_torch_checkpoint(str(path))
