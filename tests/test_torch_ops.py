"""The port's warp ops and encodings against the JAX package's, on the same
numpy inputs (CPU: the port's wrappers run their plain PyTorch versions; the
JAX splat/gather run both through Pallas in interpret mode and through
XLA). The CUDA kernels themselves are held against these plain versions on
the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taming_event_flow_tpu import ops as jops
from taming_event_flow_tpu.ops import encodings as jenc
from taming_event_flow_tpu.ops import warp as jwarp
from taming_event_flow_tpu_torch import ops as tops

SHAPES = [
    ((8, 10), 32),  # tiny
    ((140, 200), 256),  # > 16384 px: the JAX XLA path is the 4-tap scatter
]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def backends():
    yield
    jops.set_warp_backend("auto")


def make_events(rng, res, m, b=2, c=3, integers=True):
    loc = np.stack(
        [rng.uniform(-2, res[0] + 1, (b, m)),  # includes out-of-frame
         rng.uniform(-2, res[1] + 1, (b, m))], axis=-1).astype(np.float32)
    if integers:
        loc[:, : m // 4] = np.round(loc[:, : m // 4])
    vals = rng.normal(size=(b, m, c)).astype(np.float32)
    vals[:, -m // 8:] = 0.0  # zero-masked padding rows
    return loc, vals


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("res,m", SHAPES)
@pytest.mark.parametrize("round_idx", [False, True])
def test_splat_matches_jax(rng, backends, backend, res, m, round_idx):
    loc, vals = make_events(rng, res, m)
    jops.set_warp_backend(backend)
    ref = np.asarray(jops.splat_values(jnp.asarray(loc), jnp.asarray(vals),
                                       res, round_idx=round_idx))
    out = tops.splat_values(torch.from_numpy(loc), torch.from_numpy(vals),
                            res, round_idx=round_idx)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("res,m", SHAPES)
def test_gather_matches_jax(rng, backends, backend, res, m):
    loc, _ = make_events(rng, res, m)
    maps = rng.normal(size=(2, res[0], res[1], 3)).astype(np.float32)
    jops.set_warp_backend(backend)
    ref = np.asarray(jops.gather_values(jnp.asarray(maps), jnp.asarray(loc)))
    out = tops.gather_values(torch.from_numpy(maps), torch.from_numpy(loc))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_get_event_flow_is_yx(rng):
    res = (9, 13)
    loc, _ = make_events(rng, res, 40, c=2)
    flow = rng.normal(size=(2, res[0], res[1], 2)).astype(np.float32)
    ref = np.asarray(jwarp.get_event_flow(jnp.asarray(flow),
                                          jnp.asarray(loc)))
    out = tops.get_event_flow(torch.from_numpy(flow), torch.from_numpy(loc))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_splat_integer_and_boundary_semantics():
    """An integer coordinate puts weight 1 on one pixel; a coordinate in
    [-1, 0) keeps its in-frame tap; a coordinate past the frame drops."""
    loc = torch.tensor([[[2.0, 3.0], [-0.25, 1.0], [4.0, 4.25], [5.0, 0.0]]])
    vals = torch.ones(1, 4, 1)
    out = tops.splat_bilinear(loc, vals, (5, 5))[0, ..., 0]
    expect = torch.zeros(5, 5)
    expect[2, 3] = 1.0
    expect[0, 1] = 0.75
    expect[4, 4] = 0.75  # (4, 4.25): tap x=5 is out of frame
    torch.testing.assert_close(out, expect, rtol=0, atol=0)


def test_warp_primitives_match_jax(rng):
    res = (11, 17)
    loc, _ = make_events(rng, res, 50, c=2)
    ts = rng.uniform(0, 1, (2, 50, 1)).astype(np.float32)
    flow = rng.normal(size=(2, 50, 2)).astype(np.float32) * 3
    pol = (rng.uniform(size=(2, 50, 2)) > 0.5).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        tops.event_propagation(t(ts), t(loc), t(flow), 0.7).numpy(),
        np.asarray(jwarp.event_propagation(ts, loc, flow, 0.7)))
    np.testing.assert_array_equal(
        tops.inside_mask(t(loc), res).numpy(),
        np.asarray(jwarp.inside_mask(jnp.asarray(loc), res)))
    for a, b in zip(tops.purge_unfeasible(t(loc), t(pol), res),
                    jwarp.purge_unfeasible(jnp.asarray(loc),
                                           jnp.asarray(pol), res)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(
        tops.iwe_from_events(t(loc), t(pol), res, round_idx=True).numpy(),
        np.asarray(jwarp.iwe_from_events(jnp.asarray(loc), jnp.asarray(pol),
                                         res, round_idx=True)), **TOL)


def _events(rng, lead, n, res):
    ev = np.zeros(lead + (n, 4), np.float32)
    ev[..., 0] = rng.uniform(0, 1, lead + (n,))
    ev[..., 1] = rng.integers(-1, res[0] + 1, lead + (n,))  # clipped
    ev[..., 2] = rng.integers(-1, res[1] + 1, lead + (n,))
    ev[..., 3] = rng.choice([-1.0, 1.0], lead + (n,))
    ev[..., -n // 4:, :] = 0.0  # padding rows (p == 0)
    return ev


@pytest.mark.parametrize("lead", [(1,), (3, 2)])
def test_derive_count_input_exact(rng, lead):
    res = (7, 9)
    ev = _events(rng, lead, 64, res)
    ref = np.asarray(jenc.derive_count_input(jnp.asarray(ev), res))
    out = tops.derive_count_input(torch.from_numpy(ev), res)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_events_to_channels_exact(rng):
    res = (7, 9)
    ev = _events(rng, (), 80, res)
    valid = (rng.uniform(size=80) > 0.2).astype(np.float32)
    args = (ev[:, 2], ev[:, 1], ev[:, 3])
    ref = np.asarray(jenc.events_to_channels(
        *map(jnp.asarray, args), res, valid=jnp.asarray(valid)))
    out = tops.events_to_channels(*map(torch.from_numpy, args), res,
                                  valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_cpu_calls_leave_launch_counters_at_zero(rng):
    tops.reset_launches()
    loc, vals = make_events(rng, (8, 10), 32)
    tops.splat_values(torch.from_numpy(loc), torch.from_numpy(vals), (8, 10))
    tops.gather_values(torch.rand(2, 8, 10, 2), torch.from_numpy(loc))
    assert tops.LAUNCHES == {"splat_bilinear": 0, "gather_bilinear": 0}


def test_wrappers_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel or raises: it is
    never quietly handed to the plain version."""
    loc = torch.zeros(1, 4, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.splat_bilinear(loc, torch.zeros(1, 4, 2, device="meta"),
                            (3, 3))
    with pytest.raises(ValueError, match="no kernel"):
        tops.gather_bilinear(torch.zeros(1, 3, 3, 2, device="meta"), loc)
    with pytest.raises(TypeError):
        tops.splat_bilinear(torch.zeros(1, 4, 2, dtype=torch.float64),
                            torch.zeros(1, 4, 1), (3, 3))
    with pytest.raises(ValueError, match="contiguous"):
        tops.gather_bilinear(torch.zeros(1, 3, 3, 4)[..., :2],
                             torch.zeros(1, 4, 2))
    assert tops.LAUNCHES == {"splat_bilinear": 0, "gather_bilinear": 0}


def test_set_tf32_sets_both_flags():
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    try:
        tops.set_tf32(True)
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        tops.set_tf32(False)
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = old[0]
        torch.backends.cuda.matmul.allow_tf32 = old[1]
