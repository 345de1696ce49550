"""The port's RecEVFlowNet against the JAX package's: the JAX parameters
carried across with ``flax_params_to_state_dict``, the same numpy inputs,
three recurrent passes in float32 on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taming_event_flow_tpu.models import build_model as jax_build_model
from taming_event_flow_tpu.models.port import torch_state_dict_to_flax
from taming_event_flow_tpu_torch.models import (
    build_model,
    flax_params_to_state_dict,
    pad_to_multiple,
    unpad,
)
from taming_event_flow_tpu_torch.training import make_forward_fn, reset_carry

from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RES = (36, 44)  # not a multiple of 16: exercises the top-left padding
CFG = {"name": "RecEVFlowNet", "base_channels": 8, "num_encoders": 2,
       "final_w_scale": 0.01}


@pytest.fixture(scope="module")
def pair():
    jm = jax_build_model(CFG, num_bins=2)
    carry = jm.init_state(1, *RES)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, *RES, 2)),
                     carry)["params"]
    tm = build_model(CFG, num_bins=2, device="cpu")
    tm.load_state_dict(
        flax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


def test_state_dict_names_are_the_reference_names(pair):
    _, _, tm = pair
    names = set(tm.state_dict())
    for expect in ("arch.encoders.0.conv.conv2d.weight",
                   "arch.encoders.1.recurrent_block.update_gate.bias",
                   "arch.resblocks.1.conv2.weight",
                   "arch.decoders.0.conv2d.weight",
                   "arch.preds.1.conv2d.bias"):
        assert expect in names


def test_converter_inverts_the_jax_port(pair):
    """flax -> torch -> flax (through the JAX package's own converter) is
    the identity."""
    _, params, tm = pair
    back = torch_state_dict_to_flax(
        {k: v.numpy() for k, v in tm.state_dict().items()})
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])


def test_recurrent_passes_match_jax(pair, rng):
    jm, params, tm = pair
    jcarry = jm.init_state(1, *RES)
    tcarry = tm.init_state(1, *RES)
    fwd = make_forward_fn(tm, flow_scaling=1.0)
    for _ in range(3):
        x = rng.poisson(0.7, (1, *RES, 2)).astype(np.float32)
        jflows, jcarry = jm.apply({"params": params}, jnp.asarray(x), jcarry,
                                  train=False)
        tflows, tcarry = fwd(tcarry, torch.from_numpy(x))
        assert tflows.shape == jflows.shape == (2, 1, *RES, 2)
        np.testing.assert_allclose(tflows.numpy(), np.asarray(jflows),
                                   rtol=1e-5, atol=1e-5)
        for jc, tc in zip(jcarry, tcarry):  # port carry is NCHW
            np.testing.assert_allclose(tc.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(jc), rtol=1e-5, atol=1e-5)


def test_pad_unpad_roundtrip(rng):
    x = torch.from_numpy(rng.normal(size=(2, 36, 44, 3)).astype(np.float32))
    padded, pads = pad_to_multiple(x, 16)
    assert padded.shape == (2, 48, 48, 3) and pads == (12, 4)
    assert float(padded[:, :12].abs().sum()) == 0.0  # top-left zeros
    torch.testing.assert_close(unpad(padded, pads), x, rtol=0, atol=0)


def test_reset_carry_zeroes_flagged_lanes(rng):
    carry = (torch.ones(3, 4, 5, 6), torch.ones(3, 2, 2, 3))
    out = reset_carry(carry, torch.tensor([True, False, True]))
    for c in out:
        assert float(c[0].abs().sum()) == 0 and float(c[2].abs().sum()) == 0
        assert torch.equal(c[1], torch.ones_like(c[1]))


def test_build_model_seeded_and_registry():
    a = build_model(CFG, device="cpu", seed=5).state_dict()
    b = build_model(CFG, device="cpu", seed=5).state_dict()
    c = build_model(CFG, device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    for name in ("EVFlowNet", "RecFireFlowNet", "FireFlowNet"):
        m = build_model({"name": name}, device="cpu", seed=5)
        assert type(m).__name__ == name
        again = build_model({"name": name}, device="cpu", seed=5)
        assert all(torch.equal(v, again.state_dict()[k])
                   for k, v in m.state_dict().items())
    with pytest.raises(ValueError, match="Unknown model"):
        build_model({"name": "FlowNetX"}, device="cpu")
