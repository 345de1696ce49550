"""The pieces that make a seeded run of the port repeat bit for bit on the
card, held on the CPU: the bilinear upsample whose backward is a gather
(``ops/resize.py``) against ``F.interpolate`` and ``jax.image.resize``,
the model's first-step gradients through it against the JAX model's, and
the splat kernel's fixed-point scale, one a batch lane
(``ops/cuda_warp.py``), with a numpy model of its arithmetic. The kernels
themselves, and a run against itself, are checked on the card by
``chip_smoke.py`` phase 14.

Tolerances:

* the upsample's forward: bitwise ``F.interpolate``'s (it is that call);
* its backward: 1e-6 x max |g| against autograd through ``F.interpolate``
  in float32 and in bfloat16 (both sum in float32, in other orders;
  measured up to 5.9e-7 at factor 8, where a gradient sums up to 81
  terms, and 0 in bfloat16, where each side rounds once), and in float32
  1e-5 x max |g| against ``jax.vjp`` of ``jax.image.resize`` (measured
  1.9e-7);
* the first step's gradients: ``tests/test_torch_training.py``'s, 1e-4 x
  max |g| per tensor, and the loss to rtol 1e-5;
* the fixed-point sum: its error bound, n taps x 2^(-k-1), exactly.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from taming_event_flow_tpu.models import RecEVFlowNet as JRecEVFlowNet
from taming_event_flow_tpu.objectives import LossConfig as JLossConfig
from taming_event_flow_tpu.objectives import iterative_loss as j_iterative
from taming_event_flow_tpu_torch.models import (
    build_model,
    flax_params_to_state_dict,
)
from taming_event_flow_tpu_torch.models.model import _upsampled
from taming_event_flow_tpu_torch.objectives import LossConfig
from taming_event_flow_tpu_torch.ops import (
    set_deterministic,
    upsample_bilinear,
)
from taming_event_flow_tpu_torch.ops.cuda_warp import splat_scale_exponent
from taming_event_flow_tpu_torch.training import (
    build_optimizer,
    init_train_state,
    make_train_step,
)

from .test_training import P_PASSES, RES, make_window
from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FACTORS = (2, 4, 8)
SIZES = ((5, 7), (4, 6), (1, 3))  # odd, even, a single row
DTYPES = (torch.float32, torch.bfloat16)
F32_TOL = 1e-6
JAX_TOL = 1e-5
GRAD_TOL = 1e-4
FLOW_SCALING = 4.0
OPT = {"name": "Adam", "lr": 1e-3}
CLIP = 100.0
TINY = {"name": "RecEVFlowNet", "base_channels": 8, "num_encoders": 2,
        "num_residual_blocks": 1, "min_size": 4, "final_w_scale": 0.01}


def _pair(rng, factor, size, dtype):
    """``(x [2, 3, H, W], g [2, 3, sH, sW])`` from numpy, in ``dtype``."""
    h, w = size
    x = rng.normal(size=(2, 3, h, w)).astype(np.float32)
    g = rng.normal(size=(2, 3, h * factor, w * factor)).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype))


def _grad(fn, x, g):
    x = x.detach().clone().requires_grad_()
    (gx,) = torch.autograd.grad(fn(x), x, g)
    return gx


def _interpolate(factor):
    return lambda x: F.interpolate(x, scale_factor=factor, mode="bilinear",
                                   align_corners=False)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("factor", FACTORS)
def test_upsample_forward_is_interpolate(rng, factor, size, dtype):
    x, _ = _pair(rng, factor, size, dtype)
    got = upsample_bilinear(x, factor)
    assert got.dtype == dtype
    assert torch.equal(got, _interpolate(factor)(x))


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("factor", FACTORS)
def test_upsample_backward_matches_interpolate(rng, factor, size, dtype):
    x, g = _pair(rng, factor, size, dtype)
    got = _grad(lambda t: upsample_bilinear(t, factor), x, g)
    ref = _grad(_interpolate(factor), x, g)
    assert got.dtype == dtype and got.shape == x.shape
    scale = float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    assert err <= F32_TOL * scale, (err, scale)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("factor", FACTORS)
def test_upsample_backward_matches_jax(rng, factor, size):
    x, g = _pair(rng, factor, size, torch.float32)
    got = _grad(lambda t: upsample_bilinear(t, factor), x, g).numpy()
    b, c, h, w = x.shape

    def resize(z):
        return jax.image.resize(z, (b, h * factor, w * factor, c),
                                method="bilinear")

    # the JAX package's layout is NHWC
    _, vjp = jax.vjp(resize, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))
    (ref,) = vjp(jnp.asarray(g.numpy().transpose(0, 2, 3, 1)))
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= JAX_TOL * scale


def test_upsample_backward_repeats_bitwise(rng):
    x, g = _pair(rng, 4, (6, 5), torch.float32)
    fn = lambda t: upsample_bilinear(t, 4)  # noqa: E731
    assert torch.equal(_grad(fn, x, g), _grad(fn, x, g))


@pytest.mark.parametrize("factor", (1.5, 2.0, 0, -2, True, "2"))
def test_upsample_refuses_a_non_integer_factor(factor):
    with pytest.raises(ValueError, match="positive integer"):
        upsample_bilinear(torch.zeros(1, 2, 3, 3), factor)


def test_model_upsample_refuses_a_non_multiple():
    """The model's per-scale upsampling takes the integer factor between
    a prediction and the padded input, and raises where there is none."""
    flow = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError, match="integer multiple"):
        _upsampled([flow], 1, (7, 8), (0, 0))
    with pytest.raises(ValueError, match="integer multiple"):
        _upsampled([flow], 1, (6, 12), (0, 0))  # factors 2 and 3
    out = _upsampled([flow], 1, (6, 8), (0, 0))
    assert out.shape == (1, 1, 6, 8, 2)


@pytest.mark.parametrize("upsample_conv", (True, False),
                         ids=("upsample_conv", "transposed_conv"))
def test_first_step_gradients_match_jax(rng, upsample_conv):
    """A tiny RecEVFlowNet's first training step, both decoders: the
    upsample sits in the default decoders and in every scale's upsampled
    prediction of both."""
    cfg = dict(TINY, use_upsample_conv=upsample_conv)
    jm = JRecEVFlowNet(**{k: v for k, v in cfg.items() if k != "name"},
                       num_bins=2)
    # j_init_state's parameters, initialised as one XLA program
    carry0 = jm.init_state(1, *RES)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, *RES, 2)), carry0)["params"]
    w = make_window(rng, 1)
    jcfg = JLossConfig(res=RES, passes_loss=P_PASSES)

    def jloss(params):
        def body(carry, x):
            flows, carry = jm.apply({"params": params}, x, carry)
            return carry, flows * FLOW_SCALING

        _, flows = jax.lax.scan(body, carry0,
                                jnp.asarray(w["net_input"]))
        return j_iterative(flows, jnp.asarray(w["event_list"]),
                           jnp.asarray(w["pol_mask"]),
                           jnp.asarray(w["grad_mask"]), jcfg)

    # one XLA program: compiled once, not op by op
    jv, jg = jax.jit(jax.value_and_grad(jloss))(params)
    jgrads = flax_params_to_state_dict(jax.tree.map(np.asarray, jg))

    tm = build_model(cfg, num_bins=2, device="cpu")
    tm.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, params)))
    opt = build_optimizer(OPT, tm.parameters(), clip_grad=CLIP, device="cpu")
    step = make_train_step(tm, opt, LossConfig(res=RES, passes_loss=P_PASSES),
                           flow_scaling=FLOW_SCALING, res=RES)
    state = init_train_state(tm, 1, RES[0], RES[1], device="cpu")
    _, loss = step(state, {k: torch.from_numpy(v) for k, v in w.items()})
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-5)
    named = dict(tm.named_parameters())
    assert set(named) == set(jgrads)
    for name, p in named.items():
        ref = jgrads[name].numpy()
        scale = np.abs(ref).max()
        assert scale > 0, name
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_set_deterministic_sets_cudnn():
    flags = torch.backends.cudnn
    saved = flags.deterministic, flags.benchmark
    try:
        flags.deterministic, flags.benchmark = False, True
        set_deterministic()
        assert flags.deterministic and not flags.benchmark
    finally:
        flags.deterministic, flags.benchmark = saved


# ------------------------------------------------- the splat's fixed point

# rows of a lane with a non-zero value: from one point to a DSEC window's
# event slots and the batched sweep's [T*B] lanes' ten windows of 8,192
ROWS = (1, 3, 81_920, 655_360)
# max |v|: none, the smallest subnormal, the largest subnormal, the main
# path's counts, powers of two, the largest float32
MAXIMA = (0.0, 2.0 ** -149, 1.1754942e-38, 1.0, 10.0, 2.0 ** 20,
          3.4028235e38)


def _lane(rows, top, pad=0, extra=()):
    """``[1, rows + pad, 1]`` float32: ``rows`` non-zero values whose
    largest finite |v| is ``top`` (all of them ``top`` but one ``-top /
    2``), ``pad`` zero rows, then ``extra`` values over the first rows."""
    v = torch.full((rows + pad,), float(np.float32(top)))
    v[rows:] = 0.0
    if rows > 1:
        v[1] = -v[0] / 2
    v[: len(extra)] = torch.tensor(extra, dtype=torch.float32)
    return v.view(1, -1, 1)


@pytest.mark.parametrize("top", MAXIMA)
@pytest.mark.parametrize("rows", ROWS)
def test_splat_scale_keeps_the_sum_in_int64(rows, top):
    """``4 n max|v| 2^k <= 2^62`` for a lane of ``n`` non-zero rows: every
    pixel's int64 sum of scaled products fits, even with all of them at
    max |v| on one pixel. And the scale is tight: above ``2^60`` (frexp's
    mantissa and the ceiling each cost at most a bit)."""
    (k,) = splat_scale_exponent(_lane(rows, top))
    n = rows if top > 0 else 1
    bound = 4 * n * Fraction(float(np.float32(top))) * Fraction(2) ** k
    assert bound <= 2 ** 62
    if top > 0:
        assert bound > 2 ** 60


def test_splat_scale_is_the_lanes_own():
    """A lane's exponent depends on its own values alone: not on its zero
    rows (the padding of a bucket, the batched sweep's masked windows) and
    not on the other lanes of the call, so a lane splats to the same bits
    alone, padded or in a batch."""
    alone = splat_scale_exponent(_lane(1000, 3.0))
    assert splat_scale_exponent(_lane(1000, 3.0, pad=64_536)) == alone
    batch = torch.cat([_lane(1000, 3.0), _lane(1000, 1e6),
                       _lane(1000, 0.0)], 0)
    ks = splat_scale_exponent(batch)
    assert ks[0] == alone[0] and ks[1] < ks[0]
    assert ks[2] == splat_scale_exponent(torch.zeros(1, 1000, 1))[0]


@pytest.mark.parametrize("bad", (float("nan"), float("inf"), -float("inf")))
def test_splat_scale_ignores_non_finite_values(bad):
    """A NaN or infinite value goes to the flag word, not into the scale:
    ``k`` is that of the finite values, and that of no non-zero row (n = 1,
    e = 0) when there is none."""
    assert splat_scale_exponent(_lane(16, 3.0, extra=(3.0, bad))) == \
        splat_scale_exponent(_lane(16, 3.0, extra=(3.0, 0.0)))
    none = splat_scale_exponent(torch.zeros(1, 4, 2))
    assert none == [60]
    assert splat_scale_exponent(torch.full((1, 4, 2), bad)) == none


def test_fixed_point_sum_within_its_bound(rng):
    """The kernel's arithmetic in numpy at the adversarial case of
    ``chip_smoke.py`` phase 14: 65,536 points on one pixel, random-sign
    values over 1e-6 to 1e3. Each product rounds to ``llrint(t 2^k)``; the
    int64 sum lies within ``n 2^(-k-1)`` of the exact sum, and after the
    one rounding to float32 within that plus half an ulp."""
    n = 65_536
    mags = 10.0 ** rng.uniform(-6, 3, n)
    t = (mags * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    (k,) = splat_scale_exponent(torch.from_numpy(t).view(1, n, 1))
    q = np.rint(t.astype(np.float64) * 2.0 ** k).astype(np.int64)
    assert int(np.abs(q).astype(object).sum()) < 2 ** 62
    acc = int(q.astype(object).sum())
    exact = sum(Fraction(float(x)) for x in t)
    err = abs(Fraction(acc) * Fraction(2) ** -k - exact)
    assert err <= Fraction(n) * Fraction(2) ** (-k - 1)
    assert abs(acc) < 2 ** 53  # so float(acc) is exact: one rounding below
    out = np.float32(math.ldexp(float(np.float32(float(acc))), -k))
    half_ulp = Fraction(float(np.spacing(np.abs(out)))) / 2
    assert abs(Fraction(float(out)) - exact) <= err + half_ulp
