"""The port's warp ops and encodings against the JAX package's, on the same
numpy inputs (CPU: the port's wrappers run their plain PyTorch versions; the
JAX splat/gather run both through Pallas in interpret mode and through
XLA). The autograd Functions are held to the Pallas custom VJPs, and the
fused dual-stencil gather to the Pallas kernel, in interpret mode. The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taming_event_flow_tpu import ops as jops
from taming_event_flow_tpu.ops import encodings as jenc
from taming_event_flow_tpu.ops import pallas_warp as jpallas
from taming_event_flow_tpu.ops import warp as jwarp
from taming_event_flow_tpu_torch import ops as tops

from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

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
    out = tops.cuda_warp.splat_bilinear(loc, vals, (5, 5))[0, ..., 0]
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
    tops.gather_fused(torch.rand(2, 8, 10, 3), torch.from_numpy(loc),
                      torch.from_numpy(vals))
    assert tops.LAUNCHES == {"splat_bilinear": 0, "gather_bilinear": 0,
                             "gather_fused": 0, "row_gather": 0}


def test_wrappers_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel or raises: it is
    never quietly handed to the plain version."""
    loc = torch.zeros(1, 4, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.cuda_warp.splat_bilinear(
            loc, torch.zeros(1, 4, 2, device="meta"), (3, 3))
    with pytest.raises(ValueError, match="no kernel"):
        tops.gather_bilinear(torch.zeros(1, 3, 3, 2, device="meta"), loc)
    with pytest.raises(TypeError):
        tops.cuda_warp.splat_bilinear(
            torch.zeros(1, 4, 2, dtype=torch.float64), torch.zeros(1, 4, 1),
            (3, 3))
    with pytest.raises(ValueError, match="contiguous"):
        tops.gather_bilinear(torch.zeros(1, 3, 3, 4)[..., :2],
                             torch.zeros(1, 4, 2))
    with pytest.raises(ValueError, match="no kernel"):
        tops.gather_fused(torch.zeros(1, 3, 3, 2, device="meta"), loc,
                          torch.zeros(1, 4, 2, device="meta"))
    with pytest.raises(ValueError, match="disagree"):
        tops.gather_fused(torch.zeros(1, 3, 3, 2), torch.zeros(1, 4, 2),
                          torch.zeros(1, 4, 3))
    assert tops.LAUNCHES == {"splat_bilinear": 0, "gather_bilinear": 0,
                             "gather_fused": 0, "row_gather": 0}


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


# ----------------------------------------------- fused gather and autograd


@pytest.mark.parametrize("res,m", SHAPES)
@pytest.mark.parametrize("c", [2, 4])
def test_gather_fused_matches_pallas(rng, res, m, c):
    """Non-integer and exactly integer coordinates (on y, on x, on both),
    in frame and out of frame, and rows whose values are all zero (at
    random locations and purged to (0, 0)), against ``_gather_fused_raw`` in
    interpret mode."""
    loc, vals = make_events(rng, res, m, c=c)
    loc[:, m // 4: m // 3, 1] = np.round(loc[:, m // 4: m // 3, 1])
    loc[:, m // 3: m // 2, 0] = np.round(loc[:, m // 3: m // 2, 0])
    loc[:, -m // 16:] = 0.0  # zero-valued rows moved to (0, 0)
    assert not vals[:, -m // 8:].any()
    maps = rng.normal(size=(2, res[0], res[1], c)).astype(np.float32)
    ref = jpallas._gather_fused_raw(jnp.asarray(maps), jnp.asarray(loc),
                                    jnp.asarray(vals))
    out = tops.gather_fused_plain(torch.from_numpy(maps),
                                  torch.from_numpy(loc),
                                  torch.from_numpy(vals))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    gv, dy, dx = tops.gather_fused(torch.from_numpy(maps),
                                   torch.from_numpy(loc),
                                   torch.from_numpy(vals), with_gv=False)
    assert gv is None
    torch.testing.assert_close(dy, out[1], rtol=0, atol=0)
    torch.testing.assert_close(dx, out[2], rtol=0, atol=0)


@pytest.mark.parametrize("with_gv", [True, False])
@pytest.mark.parametrize("c", [2, 4])
def test_gather_fused_dloc_is_the_stacked_columns(rng, with_gv, c):
    """``gather_fused_dloc`` returns ``(gv, d_loc)`` with ``d_loc`` exactly
    ``torch.stack([dy, dx], -1)`` of ``gather_fused``'s output."""
    res, m = (9, 13), 64
    loc, vals = make_events(rng, res, m, c=c)
    t = torch.from_numpy
    maps = t(rng.normal(size=(2,) + res + (c,)).astype(np.float32))
    gv, dy, dx = tops.gather_fused(maps, t(loc), t(vals), with_gv=with_gv)
    gv2, d_loc = tops.gather_fused_dloc(maps, t(loc), t(vals),
                                        with_gv=with_gv)
    assert d_loc.shape == (2, m, 2) and d_loc.is_contiguous()
    assert torch.equal(d_loc.view(torch.int32),
                       torch.stack([dy, dx], -1).view(torch.int32))
    assert (gv is None) == (gv2 is None) == (not with_gv)
    if with_gv:
        assert torch.equal(gv, gv2)


@pytest.mark.parametrize("c", [2, 4])
def test_gather_fused_zero_rows_give_positive_zero(rng, c):
    """A row whose values are all zero (+0 or -0) gets ``d_loc = (+0, +0)``
    with the sign bit clear, wherever it sits and whatever the map holds
    there; with ``with_gv`` its gather values are still read. The CUDA
    kernel skips such a row's taps on this ground."""
    res = (6, 7)
    maps = -torch.from_numpy(np.abs(rng.normal(size=(1,) + res + (c,)))
                             .astype(np.float32)) - 1.0
    loc = torch.tensor([[[0.0, 0.0], [2.5, 3.25], [3.0, 4.0], [-0.5, 6.5],
                         [1.75, 2.0]]])
    vals = torch.zeros(1, 5, c)
    vals[0, 1:, 0] = -0.0
    vals[0, 4] = 1.0  # one real row beside them
    for with_gv in (False, True):
        gv, d_loc = tops.gather_fused_dloc(maps, loc, vals, with_gv=with_gv)
        zero = d_loc[0, :4]
        assert torch.equal(zero, torch.zeros_like(zero))
        assert not torch.signbit(zero).any()
        assert d_loc[0, 4].abs().min() > 0
    # the zero rows' gather values: the bilinear weights of a negative map
    assert (gv[0, :3] < 0).all()
    torch.testing.assert_close(gv, tops.gather_bilinear(maps, loc), **TOL)


def test_gather_fused_dual_stencil_at_integers():
    """At an integer coordinate the derivative stencil spans three taps,
    (-0.5, -1, +0.5) at (y-1, y, y+1); at a fractional one two, (-1, +1)."""
    h, w = 5, 6
    maps = torch.zeros(1, h, w, 1)
    maps[0, :, :, 0] = torch.arange(h, dtype=torch.float32)[:, None] ** 2
    loc = torch.tensor([[[2.0, 3.0], [2.25, 3.0], [0.0, 3.0]]])
    gv, dy, dx = tops.gather_fused(maps, loc, torch.ones(1, 3, 1))
    # y = 2: -0.5 * 1 - 1 * 4 + 0.5 * 9; y = 2.25: -4 + 9; y = 0: tap -1
    # is out of frame: -1 * 0 + 0.5 * 1
    torch.testing.assert_close(dy[0], torch.tensor([0.0, 5.0, 0.5]),
                               rtol=0, atol=0)
    torch.testing.assert_close(gv[0, :, 0], torch.tensor([4.0, 5.25, 0.0]),
                               rtol=0, atol=0)
    # x = 3 is an integer on a map constant along x: the stencil's weights
    # sum to -1 there (jax's tie rule), so dx = -gv
    torch.testing.assert_close(dx[0], -gv[0, :, 0], rtol=0, atol=0)


@pytest.mark.parametrize("res,m", SHAPES)
def test_splat_fn_grads_match_pallas(rng, res, m):
    """``SplatBilinearFn`` against ``pallas_warp.splat_grad`` (the Pallas
    custom VJP, interpret mode): values 1e-5, location gradients atol 1e-4
    (the ``tests/test_pallas.py`` tolerances)."""
    loc, vals = make_events(rng, res, m, integers=False)
    cot = rng.normal(size=(2, res[0], res[1], 3)).astype(np.float32)

    def jloss(lc, v):
        return jnp.sum(jpallas.splat_grad(lc, v, res) * cot)

    ref_v = jpallas.splat_grad(jnp.asarray(loc), jnp.asarray(vals), res)
    ref_dl, ref_dv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(loc),
                                                     jnp.asarray(vals))
    tl = torch.from_numpy(loc).requires_grad_()
    tv = torch.from_numpy(vals).requires_grad_()
    out = tops.SplatBilinearFn.apply(tl, tv, res)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_v),
                               **TOL)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(ref_dv), **TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(ref_dl),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("res,m", SHAPES)
def test_gather_fn_grads_match_pallas(rng, res, m):
    """``GatherBilinearFn`` against ``pallas_warp.gather_grad``, with the
    same tolerances."""
    loc, _ = make_events(rng, res, m, integers=False)
    maps = rng.normal(size=(2, res[0], res[1], 3)).astype(np.float32)
    cot = rng.normal(size=(2, m, 3)).astype(np.float32)

    def jloss(mp, lc):
        return jnp.sum(jpallas.gather_grad(mp, lc) * cot)

    ref_v = jpallas.gather_grad(jnp.asarray(maps), jnp.asarray(loc))
    ref_dm, ref_dl = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(maps),
                                                     jnp.asarray(loc))
    tm = torch.from_numpy(maps).requires_grad_()
    tl = torch.from_numpy(loc).requires_grad_()
    out = tops.GatherBilinearFn.apply(tm, tl)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_v),
                               **TOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(ref_dm), **TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(ref_dl),
                               rtol=1e-5, atol=1e-4)


def test_functions_skip_the_halves_nobody_needs(rng, monkeypatch):
    """A constant location skips the fused gather (the splat's value
    gradient is then a plain gather); constant values skip the gather
    values; under inference mode only the forward runs."""
    loc, vals = make_events(rng, (8, 10), 32, c=2, integers=False)
    maps = torch.rand(2, 8, 10, 2, requires_grad=True)
    calls = []
    real = tops.cuda_warp.gather_fused_dloc

    def spy(*args, **kwargs):
        calls.append(kwargs.get("with_gv", True))
        return real(*args, **kwargs)

    monkeypatch.setattr(tops.cuda_warp, "gather_fused_dloc", spy)
    tl = torch.from_numpy(loc)
    tops.gather_values(maps, tl).sum().backward()
    assert calls == [] and maps.grad is not None
    tops.splat_values(tl.clone().requires_grad_(), torch.from_numpy(vals),
                      (8, 10)).sum().backward()
    assert calls == [False]
    tv = torch.from_numpy(vals).requires_grad_()
    tops.splat_values(tl, tv, (8, 10)).sum().backward()
    assert calls == [False]
    # d_values of a summed splat: each event's in-frame tap weights
    ones = torch.ones(2, 8, 10, vals.shape[-1])
    torch.testing.assert_close(tv.grad, tops.gather_values(ones, tl),
                               rtol=0, atol=0)
    with torch.inference_mode():
        out = tops.splat_values(tl.clone().requires_grad_(),
                                torch.from_numpy(vals), (8, 10))
    assert not out.requires_grad and calls == [False]


def test_backward_takes_strided_cotangents(rng):
    """``get_event_flow`` flips the gather's output: its cotangent arrives
    as a strided view and is made contiguous before the kernels."""
    loc, _ = make_events(rng, (8, 10), 32, c=2, integers=False)
    tl = torch.from_numpy(loc).requires_grad_()
    maps = torch.rand(2, 8, 10, 2, requires_grad=True)
    flow = tops.get_event_flow(maps, tl)
    (flow[..., :1] * 3.0).sum().backward()
    assert torch.isfinite(tl.grad).all() and torch.isfinite(maps.grad).all()


# ------------------------------------------- row gather and the warp module


@pytest.mark.parametrize("res", [(8, 10), (140, 200), (200, 220)])
def test_gather_pixels_matches_jax(rng, res):
    """All three JAX formulations (one-hot matmul, take_along_axis, the
    128-lane row trick) against one row gather: exact; a [B, T, W] table
    gathers whole rows in one call."""
    t = res[0] * res[1]
    table = rng.normal(size=(2, t)).astype(np.float32)
    idx = rng.integers(0, t, (2, 300)).astype(np.int32)
    ref = np.asarray(jwarp.gather_pixels(jnp.asarray(table),
                                         jnp.asarray(idx)))
    out = tops.gather_pixels(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), ref)
    rows = rng.normal(size=(2, t, 2)).astype(np.float32)
    out = tops.gather_pixels(torch.from_numpy(rows), torch.from_numpy(idx))
    assert out.shape == (2, 300, 2)
    np.testing.assert_array_equal(
        out.numpy(), np.take_along_axis(rows, idx[..., None], 1))


def _deblur_inputs(rng, res, n=120, fractional=False):
    ev = np.zeros((2, n, 4), np.float32)
    ev[..., 0] = rng.uniform(0, 1, (2, n))
    ev[..., 1] = rng.integers(-1, res[0] + 1, (2, n))  # some out of frame
    ev[..., 2] = rng.integers(-1, res[1] + 1, (2, n))
    if fractional:  # rectified coordinates
        ev[..., 1:3] += rng.uniform(-0.45, 0.45, (2, n, 2))
        # y * W + x of a fractional y in (H - 1, H) indexes past the flow
        # map: the JAX formulations differ there (the one-hot form reads
        # zero), the port clamps; keep to the range where all agree
        y = ev[..., 1]
        ev[..., 1] = np.where((y > res[0] - 1) & (y < res[0]), res[0] - 1, y)
    ev[..., 3] = rng.choice([-1.0, 1.0], (2, n))
    ev[:, -n // 8:] = 0.0  # padding rows
    pol = np.stack([ev[..., 3] > 0, ev[..., 3] < 0], -1).astype(np.float32)
    flow = rng.normal(size=(2, res[0], res[1], 2)).astype(np.float32) * 2
    return flow, ev, pol


@pytest.mark.parametrize("res", [(9, 13), (140, 200)])
@pytest.mark.parametrize("rounding", [(True, True), (False, False)])
@pytest.mark.parametrize("fractional", [False, True])
def test_compute_pol_iwe_and_deblur_match_jax(rng, res, rounding,
                                              fractional):
    """``(round_idx, round_flow)`` at the default ``(True, True)`` and at
    ``(False, False)`` as the eval CLI draws its ``iwe``, on integer and
    rectified (fractional) event coordinates."""
    round_idx, round_flow = rounding
    flow, ev, pol = _deblur_inputs(rng, res, fractional=fractional)
    kw = dict(round_idx=round_idx, round_flow=round_flow)
    t = torch.from_numpy
    ref = np.asarray(jwarp.compute_pol_iwe(jnp.asarray(flow),
                                           jnp.asarray(ev), res,
                                           jnp.asarray(pol), **kw))
    out = tops.compute_pol_iwe(t(flow), t(ev), res, t(pol), **kw)
    assert out.shape == ref.shape == (2,) + res + (2,)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    for mask in (None, pol[..., 1:2]):
        ref = np.asarray(jwarp.deblur_events(
            jnp.asarray(flow), jnp.asarray(ev), res,
            polarity_mask=None if mask is None else jnp.asarray(mask), **kw))
        out = tops.deblur_events(t(flow), t(ev), res,
                                 polarity_mask=None if mask is None
                                 else t(mask), **kw)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_compute_pol_iwe_launch_routes(rng):
    """On the CPU nothing launches; the nearest flow lookup is one row
    gather of both flow channels, the bilinear one a bilinear gather."""
    flow, ev, pol = _deblur_inputs(rng, (9, 13))
    calls = []
    real_row = tops.cuda_warp.row_gather
    real_bil = tops.GatherBilinearFn.forward

    def spy_row(table, idx):
        calls.append(("row", table.shape[1]))
        return real_row(table, idx)

    def spy_bil(ctx, maps, loc):
        calls.append(("bilinear", maps.shape[-1]))
        return real_bil(ctx, maps, loc)

    import taming_event_flow_tpu_torch.ops.warp as twarp
    t = torch.from_numpy
    tops.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twarp, "row_gather", spy_row)
        mp.setattr(tops.GatherBilinearFn, "forward", staticmethod(spy_bil))
        tops.compute_pol_iwe(t(flow), t(ev), (9, 13), t(pol))
        assert calls == [("row", 2)]
        tops.compute_pol_iwe(t(flow), t(ev), (9, 13), t(pol),
                             round_idx=False, round_flow=False)
        assert calls == [("row", 2), ("bilinear", 2)]
    assert all(v == 0 for v in tops.LAUNCHES.values())


@pytest.mark.parametrize("round_idx", [False, True])
def test_get_interpolation_and_interpolate_match_jax(rng, round_idx):
    res = (11, 17)
    loc, _ = make_events(rng, res, 60, c=1)
    mask = (rng.uniform(size=(2, 60 if round_idx else 240, 1)) > 0.3
            ).astype(np.float32)
    ref_idx, ref_w = jwarp.get_interpolation(jnp.asarray(loc), res,
                                             round_idx=round_idx)
    idx, w = tops.get_interpolation(torch.from_numpy(loc), res,
                                    round_idx=round_idx)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), **TOL)
    ref = jwarp.interpolate(ref_idx, ref_w, res,
                            polarity_mask=jnp.asarray(mask))
    out = tops.interpolate(idx, w, res, polarity_mask=torch.from_numpy(mask))
    assert out.shape == (2,) + res + (1,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the bilinear splat of the same events is the 4-tap interpolation
    if not round_idx:
        ones = torch.ones(2, 60, 1)
        np.testing.assert_allclose(
            tops.interpolate(idx, w, res).numpy(),
            tops.splat_values(torch.from_numpy(loc), ones, res).numpy(),
            **TOL)


def test_splat_channels_and_bilinear_sample_match_jax(rng):
    res = (140, 200)  # > 16384 px: the JAX scatter path
    hw = res[0] * res[1]
    idx = rng.integers(-3, hw + 3, (2, 500)).astype(np.int32)  # some drop
    w = rng.normal(size=(2, 500, 3)).astype(np.float32)
    ref = np.asarray(jwarp.splat_channels(jnp.asarray(idx), jnp.asarray(w),
                                          res))
    out = tops.splat_channels(torch.from_numpy(idx), torch.from_numpy(w), res)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    ref1 = np.asarray(jwarp.splat_bilinear(jnp.asarray(idx),
                                           jnp.asarray(w[..., :1]), res))
    out1 = tops.splat_bilinear(torch.from_numpy(idx),
                               torch.from_numpy(w[..., :1]), res)
    np.testing.assert_allclose(out1.numpy(), ref1, **TOL)
    loc, _ = make_events(rng, res, 80, c=1)
    img = rng.normal(size=(2,) + res).astype(np.float32)
    np.testing.assert_allclose(
        tops.bilinear_sample(torch.from_numpy(img),
                             torch.from_numpy(loc)).numpy(),
        np.asarray(jwarp.bilinear_sample(jnp.asarray(img),
                                         jnp.asarray(loc))), **TOL)


# ------------------------------------------ what the redesigned kernels rely on


def _with_zero_rows(rng, loc, vals, res, n_zero):
    """``n_zero`` zero-valued rows inserted among the rows of ``loc`` and
    ``vals`` (the real rows keep their order): half at (0, 0), as padding
    and purged rows sit, half out of frame."""
    b, m, c = vals.shape
    at = np.sort(rng.integers(0, m + 1, n_zero))
    pad = np.zeros((n_zero, 2), np.float32)
    outside = [[-3.5, 2.0], [res[0] + 2.0, 1.5], [4.0, -1.25],
               [1.0, res[1] + 0.5]]
    pad[n_zero // 2:] = np.resize(outside, (n_zero - n_zero // 2, 2))
    return (np.insert(loc, at, pad, axis=1),
            np.insert(vals, at, np.zeros((n_zero, c), np.float32), axis=1))


@pytest.mark.parametrize("round_idx", [False, True])
@pytest.mark.parametrize("c", [2, 4])
def test_splat_zero_rows_add_nothing(rng, backends, round_idx, c):
    """Zero-valued rows at (0, 0) and out of frame leave the splat as it
    is: bitwise in the port's plain version, and within the kernel
    tolerance of the JAX Pallas splat (interpret mode) with or without
    them. The CUDA splat issues no atomics for such rows on this ground."""
    res = (12, 15)
    loc, _ = make_events(rng, res, 96, c=c)
    vals = rng.normal(size=(2, 96, c)).astype(np.float32)
    loc_z, vals_z = _with_zero_rows(rng, loc, vals, res, 40)
    t = torch.from_numpy
    out = tops.splat_values(t(loc), t(vals), res, round_idx=round_idx)
    out_z = tops.splat_values(t(loc_z), t(vals_z), res, round_idx=round_idx)
    assert torch.equal(out, out_z)
    jops.set_warp_backend("pallas")
    for lc, vl in ((loc, vals), (loc_z, vals_z)):
        ref = np.asarray(jops.splat_values(jnp.asarray(lc), jnp.asarray(vl),
                                           res, round_idx=round_idx))
        np.testing.assert_allclose(out_z.numpy(), ref, **TOL)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("c", [2, 4])
def test_gather_at_integer_coordinates_matches_jax(rng, backends, backend,
                                                   c):
    """Every integer coordinate from -1 to H (y) and W (x): the last row
    and column read their pixel, the borders -1, H and W read nothing. The
    CUDA gather reads one tap per axis there; the value is the pixel,
    exactly."""
    res = (9, 13)
    ys, xs = np.meshgrid(np.arange(-1, res[0] + 1), np.arange(-1, res[1] + 1),
                         indexing="ij")
    grid = np.stack([ys, xs], -1).reshape(1, -1, 2).astype(np.float32)
    loc = np.concatenate([grid, grid[:, ::-1]])  # lane 1 in reverse order
    maps = rng.normal(size=(2,) + res + (c,)).astype(np.float32)
    jops.set_warp_backend(backend)
    ref = np.asarray(jops.gather_values(jnp.asarray(maps), jnp.asarray(loc)))
    out = tops.gather_values(torch.from_numpy(maps), torch.from_numpy(loc))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    y, x = loc[..., 0].astype(int), loc[..., 1].astype(int)
    inside = (y >= 0) & (y < res[0]) & (x >= 0) & (x < res[1])
    lane = np.arange(2)[:, None]
    pixel = maps[lane, y.clip(0, res[0] - 1), x.clip(0, res[1] - 1)]
    np.testing.assert_array_equal(out.numpy(),
                                  np.where(inside[..., None], pixel, 0.0))


@pytest.mark.parametrize("kernel", ["splat", "gather", "fused",
                                    "row_gather"])
def test_cpu_calls_never_load_the_kernel_library(rng, monkeypatch, kernel):
    """A wrapper given CPU tensors serves them from its plain version
    without building or loading the CUDA library."""
    from taming_event_flow_tpu_torch.ops import kernel_build

    def refuse():
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(kernel_build, "load", refuse)
    monkeypatch.setattr(tops.cuda_warp, "_lib", None)
    cw = tops.cuda_warp
    loc, vals = (torch.from_numpy(a) for a in make_events(rng, (8, 10), 32))
    maps = torch.from_numpy(rng.normal(size=(2, 8, 10, 3))
                            .astype(np.float32))
    if kernel == "splat":
        got, ref = (cw.splat_bilinear(loc, vals, (8, 10)),
                    cw.splat_bilinear_plain(loc, vals, (8, 10)))
    elif kernel == "gather":
        got, ref = cw.gather_bilinear(maps, loc), cw.gather_bilinear_plain(
            maps, loc)
    elif kernel == "fused":
        got = torch.cat(cw.gather_fused(maps, loc, vals)[1:])
        ref = torch.cat(cw.gather_fused_plain(maps, loc, vals)[1:])
    else:
        idx = torch.from_numpy(rng.integers(-2, 162, 50).astype(np.int32))
        table = maps.reshape(160, 3)
        got, ref = cw.row_gather(table, idx), cw.row_gather_plain(table, idx)
    assert torch.equal(got, ref)
    assert cw._lib is None


def test_kernel_library_loads_once(monkeypatch):
    """The wrappers ask the build module for the library once per process,
    not under its lock on every launch."""
    from types import SimpleNamespace

    from taming_event_flow_tpu_torch.ops import kernel_build

    loads = []

    def fake_load():
        loads.append(1)
        return SimpleNamespace(lib=object())

    monkeypatch.setattr(kernel_build, "load", fake_load)
    monkeypatch.setattr(tops.cuda_warp, "_lib", None)
    first = tops.cuda_warp._library()
    assert tops.cuda_warp._library() is first and loads == [1]
