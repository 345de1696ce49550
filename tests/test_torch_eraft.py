"""E-RAFT in the port (``models/eraft.py``) against the plain reference
(``tests/reference_eraft.py``) on seeded weights, on the CPU: the forward
with its carry in float32 and under the bfloat16 cast, the correlation
lookup's tap order, a training step's loss and gradients, one model object
alternating training steps and eval windows, a DSEC-shaped eval window on
the u32 wire through the benchmark's eval cell code, the spans and the
counter, and the benchmark's frozen copy of the reference.

The test size is 100 x 150 or 128 x 128 (padded to 128 x 160 and 128 x
128): RAFT's sampler needs every pyramid level at least 2 wide, which at
4 levels is 128 padded pixels. Every width is the published one; ``iters``
is 3 (the test says so) where the cell has 12.
"""

import copy
import importlib.util
import json
import os
import re
import sys
import time

import numpy as np
import pytest
import torch

from taming_event_flow_tpu_torch.models import build_model, eraft
from taming_event_flow_tpu_torch.objectives import LossConfig
from taming_event_flow_tpu_torch.training import (build_optimizer,
                                                  init_train_state,
                                                  make_train_step)
from taming_event_flow_tpu_torch.utils import diagnostics

from . import reference_eraft as ref
from .torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmark")
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import compare, events  # noqa: E402
from reference.losses import LOSSES  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")

CFG = {"name": "ERAFT", "num_bins": 2, "iters": 3, "corr_levels": 4,
       "corr_radius": 4, "hidden_dim": 128, "context_dim": 128,
       "fnet_dim": 256, "fnet_norm": "instance", "cnet_norm": "batch"}
TRAIN_MIX = {"resolution": [128, 128], "batch": 2, "passes": 2,
             "slots": 1024, "events_per_pass": [400, 800], "pool": 3,
             "shapes": [2, 4], "speed_px_per_pass": [0.5, 4.0],
             "noise_share": 0.1}
LOSS = LossConfig(res=(128, 128), passes_loss=2, scales_loss=1,
                  iterative_mode="two")
REF_LOSS = {"res": (128, 128), "passes_loss": 2, "scales_loss": 1,
            "iterative_mode": "two"}


def _model(seed=1, **over):
    model = build_model(dict(CFG, **over), num_bins=2, device="cpu",
                        seed=seed)
    # running statistics away from the init, so that eval mode shows
    gen = torch.Generator().manual_seed(seed)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
        elif name.endswith("running_var"):
            buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    return model


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def test_forward_with_carry_matches_the_reference():
    """Three passes in eval mode, float32. Tolerance 1e-5 of the largest
    flow: the two differ only where the reference's sampler normalises each
    tap coordinate to [-1, 1] and grid_sample maps it back (a few float32
    ulps of a coordinate, ~1e-6 px at x ~ 20), which the refinements carry
    to the flow (5e-7 of it measured)."""
    model = _model().eval()
    params = _snapshot(model)
    gen = torch.Generator().manual_seed(7)
    carry = model.init_state(2, 100, 150)
    rcarry = ref.init_state(CFG, 2, 100, 150)
    with torch.no_grad():
        for _ in range(3):
            x = 3 * torch.rand(2, 100, 150, 2, generator=gen)
            flows, carry = model(x, carry)
            want, rcarry = ref.forward(params, CFG, x, rcarry)
            assert flows.shape == (1, 2, 100, 150, 2)
            assert flows.dtype == torch.float32
            assert _rel(flows, want) <= 1e-5
            assert torch.equal(carry[0], rcarry[0])


def test_bfloat16_split_matches_the_reference(monkeypatch):
    """Under the bf16 cast of the eval steps (``_eval_net``): the
    convolutions, norms and GRU in bf16, the correlation, pyramid,
    lookups, coordinates and upsampling in float32, recorded where the
    model hands them over. Tolerance 1e-2 of the largest flow: the
    lookup's few-ulp differences (see the float32 test) move the bf16
    inputs of the motion encoder across a rounding step now and then
    (bf16 keeps 8 bits), which three refinements carry to the flow; a
    bf16 forward is 1e-2 to 1e-1 away from the float32 one here."""
    seen = []

    def spy(fn, name):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            for t in list(args) + (out if isinstance(out, list) else [out]):
                if torch.is_tensor(t) and t.is_floating_point():
                    seen.append((name, t.dtype))
            return out
        return wrapped

    for name in ("corr_pyramid", "lookup", "upsample_flow"):
        monkeypatch.setattr(eraft, name, spy(getattr(eraft, name), name))
    model = _model().eval()
    params = _snapshot(model)
    net = copy.deepcopy(model).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(8)
    carry = net.init_state(1, 100, 150, dtype=torch.bfloat16)
    rcarry = ref.init_state(CFG, 1, 100, 150, dtype=torch.bfloat16)
    with torch.no_grad():
        for _ in range(2):
            x = (3 * torch.rand(1, 100, 150, 2, generator=gen)).round()
            flows, carry = net(x.bfloat16(), carry)
            want, rcarry = ref.forward(params, CFG, x, rcarry,
                                       dtype=torch.bfloat16)
            f32, _ = ref.forward(params, CFG, x, rcarry)
            assert flows.dtype == torch.float32
            assert _rel(flows, want) <= 1e-2
            assert _rel(flows, want) < _rel(f32, want)
            assert carry[0].dtype == torch.bfloat16
    pyramid = [d for n, d in seen if n == "corr_pyramid"]
    # the pyramid takes the bf16 feature maps and gives float32 levels
    assert torch.bfloat16 in pyramid and torch.float32 in pyramid
    assert {d for n, d in seen if n != "corr_pyramid"} == {torch.float32}


def test_lookup_order_and_grid_sample():
    """The port's lookup (one gather a level) against RAFT's
    ``CorrBlock.__call__`` (``grid_sample``), with centres in and far out
    of frame, at 1e-5 of the largest value: the same bilinear weights but
    for the sampler's coordinate round trip, a few float32 ulps of a tap's
    coordinate (~4e-6 px at 30), times neighbouring values that differ by
    up to ~4 (1.3e-6 measured); and the tap order on a map
    that holds each pixel's (y, x): tap ``k = 9 i + j`` reads x offset
    ``i - 4`` and y offset ``j - 4``."""
    gen = torch.Generator().manual_seed(3)
    b, h, w = 2, 16, 20
    fmap1 = torch.randn(b, 32, h, w, generator=gen)
    fmap2 = torch.randn(b, 32, h, w, generator=gen)
    coords = ref.coords_grid(b, h, w, "cpu") + 6 * torch.randn(
        b, 2, h, w, generator=gen)
    coords[0, :, 0, :3] = torch.tensor([[-100.0, 50.0, 3.5],
                                        [300.0, -9.0, 40.0]])
    got = eraft.lookup(eraft.corr_pyramid(fmap1, fmap2, 4), coords, 4)
    want = ref.corr_lookup(ref.corr_pyramid(fmap1, fmap2, 4), coords, 4)
    assert got.shape == want.shape == (b, 4 * 81, h, w)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float(got[0, :, 0, 0].abs().max()) == 0.0  # every tap outside

    yx = torch.stack(torch.meshgrid(torch.arange(h), torch.arange(w),
                                    indexing="ij"), -1).float()
    plane = (100 * yx[..., 0] + yx[..., 1]).reshape(1, h, w, 1)
    centre = torch.tensor([[7.0], [9.0]]).reshape(1, 2, 1, 1)  # x 7, y 9
    taps = eraft.lookup([plane], centre, 4)[0, :, 0, 0]
    i, j = torch.arange(81) // 9, torch.arange(81) % 9
    assert torch.equal(taps, 100 * (9 + j - 4) + (7 + i - 4).float())


def _windows(seed, n):
    out = []
    for win in events.train_pool(TRAIN_MIX, seed, first=n):
        ev = torch.from_numpy(win.events)
        out.append({"event_list": ev,
                    "pol_mask": torch.stack([ev[..., 3] > 0, ev[..., 3] < 0],
                                            -1).float(),
                    "grad_mask": torch.from_numpy(win.grad)})
    return out


def _reference_step(params, carry, window):
    """The reference's training-mode passes and Iterative loss
    (``benchmark/reference/losses.py``) from ``params``: ``(loss, {name:
    gradient}, carry, params)``, the BatchNorm statistics updated in the
    returned dict as training mode updates them."""
    p = {k: v.clone().requires_grad_(v.is_floating_point()
                                     and not k.endswith(("running_mean",
                                                         "running_var")))
         for k, v in params.items()}
    from reference.train import count_input

    xs = count_input(window["event_list"], (128, 128))
    flows = []
    for x in xs:
        f, carry = ref.forward(p, CFG, x, carry, training=True)
        flows.append(f)
    loss = LOSSES["Iterative"](torch.stack(flows), window["event_list"],
                               window["pol_mask"], window["grad_mask"],
                               REF_LOSS)
    names = [k for k, v in p.items() if v.requires_grad]
    grads = torch.autograd.grad(loss, [p[k] for k in names])
    return (float(loss.detach()), dict(zip(names, grads)),
            tuple(c.detach() for c in carry), p)


# an encoder conv's bias that a norm follows: the norm takes the channel's
# mean out, so its gradient is zero in exact arithmetic and what float32
# leaves of it is rounding, which an all-zero first image1 (a zero-variance
# instance norm, 1 / sqrt(eps) = 316) amplifies to the size of real leaves
SHIFT_FREE = re.compile(r"^[fc]net\.(layer\d\.\d\.(conv[12]|downsample\.0)"
                        r"|conv1)\.bias$")


def _check_step(model, step, state, window):
    """One port step against the reference from the model's state before
    it. Loss within 1e-5 relative, each parameter's gradient (but those of
    ``SHIFT_FREE``) within 1e-4 of the largest leaf gradient norm, the
    BatchNorm statistics within 1e-6: the forward differs by the lookup's
    coordinate round trip (see the float32 test), which the Iterative
    loss's splats and the backward's gather-splat pairs carry at float32
    rounding (1.2e-5 of the largest leaf measured)."""
    before = _snapshot(model)
    rloss, rgrads, rcarry, rparams = _reference_step(before, state.carry,
                                                     window)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        state, loss = step(state, window)
    assert abs(float(loss) - rloss) <= 1e-5 * abs(rloss)
    named = dict(model.named_parameters())
    assert set(named) == set(rgrads)
    kept = {k: g for k, g in rgrads.items() if not SHIFT_FREE.match(k)}
    assert len(rgrads) - len(kept) == 30
    top = max(float(g.norm()) for g in kept.values())
    for k, g in kept.items():
        assert float((named[k].grad - g).norm()) <= 1e-4 * top, k
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert float((v - rparams[k]).abs().max()) <= 1e-6, k
    assert torch.equal(state.carry[0], rcarry[0])
    return state


def _train_step(model):
    opt = build_optimizer({"name": "Adam", "lr": 1e-3}, model.parameters(),
                          device="cpu")
    step = make_train_step(model, opt, LOSS, "Iterative", flow_scaling=1.0,
                           res=(128, 128))
    return step, init_train_state(model, 2, 128, 128, device="cpu")


def test_train_step_matches_the_reference():
    """One ``make_train_step`` step under the Iterative loss, the model in
    training mode (BatchNorm on the batch's statistics, the running ones
    updated); its spans open inside ``train.forward``."""
    model = _model(seed=2).eval()  # the step must set training mode itself
    step, state = _train_step(model)
    window = _windows(11, 1)[0]
    t0 = time.time_ns()
    _check_step(model, step, state, window)
    assert model.training
    spans = {e.name: e.parent for e in diagnostics.recorded()
             if e.name.startswith("eraft.") and e.start_ns >= t0}
    assert spans == {"eraft.encode": "train.forward",
                     "eraft.corr": "train.forward",
                     "eraft.refine": "train.forward",
                     "eraft.upsample": "train.forward"}


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _eval_mix(dtype):
    with open(os.path.join(BENCH_DIR, "traffic", "dsec_rect.json")) as f:
        mix = json.load(f)
    mix.update({"resolution": [128, 160], "passes": 2, "slots": 2048,
                "events_per_pass": [600, 1200], "pool": 1,
                "shapes": [2, 4]})
    mix["pipeline"]["metrics"]["inference_dtype"] = dtype
    return mix


def _eval_cfg():
    with open(os.path.join(BENCH_DIR, "configs", "eraft_iterative.json")) as f:
        cfg = json.load(f)
    cfg["model"]["iters"] = 3
    return cfg


def test_one_model_alternates_training_and_eval():
    """One E-RAFT object: a training step, an eval window through
    ``EvalPipeline`` (float32, the u32 wire), a second training step. Each
    gets the reference's result from the model's state before it: the
    steps in training mode, the window in eval mode (running statistics),
    and the window leaves the model in training mode for the next step."""
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    drv = _load(os.path.join(BENCH_DIR, "drivers", "eval.py"),
                "eraft_test_bench_eval")
    from reference.eval import replay

    model = _model(seed=4)
    step, state = _train_step(model)
    wins = _windows(12, 2)
    state = _check_step(model, step, state, wins[0])

    mix, cfg = _eval_mix(None), _eval_cfg()
    seq = events.eval_sequence(mix, 5)
    before = _snapshot(model)
    pipe = EvalPipeline(drv.pipeline_config(mix, cfg), model, device="cpu")
    pipe.cur_ridx = seq.rect.remap_idx
    pipe.cur_rect = seq.rect.rect_map
    meta = {"sequence": "t", "ts": seq.meta_ts}
    pipe.start_sequence()
    with torch.inference_mode():
        for batch in seq.batches[:2]:
            batch = pipe.ensure_bucket(batch)
            pipe.ingest(batch, meta)
        mets, flow_bw = pipe.boundary_outputs(batch, meta)
    prog = {k: float(v) for k, v in mets.items()}
    prog["flow_bw"] = flow_bw.numpy()
    want = replay(seq, before, cfg["model"], mix, 1.0, torch.device("cpu"))
    gaps = compare.eval_numbers([prog], want)
    assert model.training
    # float32 both sides: the lookup's round trip alone (float32 test)
    assert gaps["fwl_gap"] <= 1e-5 and gaps["rsat_gap"] <= 1e-5
    assert gaps["aee_gap"] <= 1e-5 and gaps["flow_bw_mean_steps"] <= 1e-2

    _check_step(model, step, state, wins[1])


def test_dsec_eval_window_through_the_benchmark():
    """The benchmark's eval cell (``benchmark/drivers/eval.py: run``) at a
    cut size (128 x 160, P = 2, one GT window a sequence) in the cell's
    precision, bfloat16: the port's
    windows on the u32 wire with the card's rectification lookup, held to
    the reference replay by the cell's own limits
    (``benchmark/limits/eraft_dsec_eval.json``); and, in its traced
    stretch, the spans inside ``window_call`` and the counter inside
    ``eraft.refine``."""
    drv = _load(os.path.join(BENCH_DIR, "drivers", "eval.py"),
                "eraft_test_bench_eval")
    with open(os.path.join(BENCH_DIR, "limits",
                           "eraft_dsec_eval.json")) as f:
        limits = json.load(f)["limits"]
    mix, cfg = _eval_mix("bfloat16"), _eval_cfg()
    seed = 2 ** 33 + 9
    t0 = time.time_ns()
    out = drv.run(cfg, mix, seed, 0.0, True, torch.device("cpu"), 0.0)
    assert out["failed"] == 0
    ok, checks = compare.check(compare.eval_numbers(out["program"],
                                                    out["reference"]),
                               limits)
    assert ok, checks
    rows = [e for e in diagnostics.recorded() if e.start_ns >= t0]
    spans = {e.name: e.parent for e in rows if e.name.startswith("eraft.")}
    assert spans == {"eraft.encode": "window_call",
                     "eraft.corr": "window_call",
                     "eraft.refine": "window_call",
                     "eraft.upsample": "window_call"}
    taps = [e for e in rows if e.name == "corr_taps"]
    assert taps and {e.parent for e in taps} == {"eraft.refine"}
    assert {e.value for e in taps} == {16 * 20 * 4 * 81}


def _bench_copy():
    return _load(os.path.join(BENCH_DIR, "reference", "models", "eraft.py"),
                 "eraft_bench_copy")


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_benchmark_copy_equals_the_reference(dtype):
    """``benchmark/reference/models/eraft.py`` computes what
    ``tests/reference_eraft.py`` does, bit for bit, on one seeded input
    and carry, and names every entry of the port's ``state_dict``."""
    bench = _bench_copy()
    model = _model(seed=6)
    sd = model.state_dict()
    shapes = bench.weight_shapes(CFG)
    assert set(shapes) == set(sd)
    assert all(tuple(sd[k].shape) == s for k, s in shapes.items())
    params = _snapshot(model.eval())
    gen = torch.Generator().manual_seed(9)
    x = 3 * torch.rand(1, 100, 150, 2, generator=gen)
    carry = (3 * torch.rand(1, 2, 128, 160, generator=gen),)
    a, ca = ref.forward(params, CFG, x, carry, dtype=dtype)
    b, cb = bench.forward(params, CFG, x, carry, dtype=dtype)
    assert torch.equal(a, b) and torch.equal(ca[0], cb[0])
    assert np.isfinite(a.numpy()).all()


@pytest.mark.parametrize("norms", [{"fnet_norm": "batch"},
                                   {"cnet_norm": "instance"},
                                   {"cnet_norm": "none"}])
def test_a_norm_it_does_not_build_is_refused(norms):
    """``build_model`` hands the configuration's norms to ``ERAFT``, which
    builds only the published pair (instance in ``fnet``, batch in
    ``cnet``) and refuses any other instead of running the pair quietly."""
    with pytest.raises(ValueError, match="norm"):
        build_model(dict(CFG, **norms), num_bins=2, device="cpu")
