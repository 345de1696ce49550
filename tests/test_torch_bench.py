"""``bench_torch.py`` against ``bench.py`` (loaded by path; its JAX imports
sit inside its functions), at tiny sizes on the CPU.

The same numpy draws go through both benches: ``_synthetic_events``
bitwise; the training program ``bench_train`` times, from the JAX bench's
initial parameters (converted by ``models.port``), first-step loss to rel
1e-4 (``tests/test_torch_training.py``'s history tolerance: the
convolutions and the warp sum in other orders); the eval window program
with and without its boundary metrics, metrics to rtol 2e-3, atol 2e-4
(the pipeline-parity tolerance) and ``flow_bw`` within one u16 lattice
step. Then the work counts, the gates (passing, and failing on a wrong
plain version, which makes ``main`` exit 1), the peak table and the
device rule.
"""

import ast
import importlib.util
import inspect
import json
import os
import textwrap

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

import jax
import jax.numpy as jnp

import bench_torch as bt
from taming_event_flow_tpu.metrics import IterativeValidation as JVal
from taming_event_flow_tpu.metrics import ValConfig as JValConfig
from taming_event_flow_tpu.metrics import compute_aee as j_compute_aee
from taming_event_flow_tpu.models import RecEVFlowNet as JRecEVFlowNet
from taming_event_flow_tpu.objectives import LossConfig as JLossConfig
from taming_event_flow_tpu.training import build_optimizer as j_build_opt
from taming_event_flow_tpu.training import (
    make_eval_window_step as j_window_step,
)
from taming_event_flow_tpu.training import make_train_step as j_make_step
from taming_event_flow_tpu.training.step import (
    init_train_state as j_init_state,
)
from taming_event_flow_tpu.utils.visualization import (
    flow_to_u16 as j_flow_to_u16,
)
from taming_event_flow_tpu_torch.models import (
    build_model,
    flax_params_to_state_dict,
)
from taming_event_flow_tpu_torch.ops import cuda_warp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"base_channels": 8, "num_encoders": 2}
TRAIN_RES, TRAIN_P, TRAIN_N = (32, 32), 2, 256
EVAL_RES, EVAL_P, EVAL_N = (24, 32), 2, 64
LOSS_RTOL = 1e-4
MET_RTOL, MET_ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module")
def jb():
    """``bench.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def torch_model(params, **extra):
    """The port's tiny RecEVFlowNet holding the JAX ``params``."""
    model = build_model(dict(TINY, name="RecEVFlowNet", **extra),
                        num_bins=2, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, params)))
    return model


def tiny_program(batch=1, model=None):
    if model is None:
        model = build_model(dict(TINY, name="RecEVFlowNet",
                                 final_w_scale=0.01), num_bins=2,
                            device="cpu", seed=0)
    return bt.train_program(batch, TRAIN_RES, TRAIN_P, TRAIN_N, "cpu",
                            model)


def test_synthetic_events_match_bench_py(jb):
    shape = (3, 2, 100)
    ev_j, pol_j = jb._synthetic_events(np.random.default_rng(7), shape,
                                       EVAL_RES)
    ev_t, pol_t = bt._synthetic_events(np.random.default_rng(7), shape,
                                       EVAL_RES, device="cpu")
    np.testing.assert_array_equal(ev_t.numpy(), np.asarray(ev_j))
    np.testing.assert_array_equal(pol_t.numpy(), np.asarray(pol_j))


def test_train_program_first_step_matches_jax(jb):
    """The program ``bench_train`` times, at a tiny width, against the JAX
    step built as ``bench.bench_train`` builds it, from its initial
    parameters and its window."""
    model = JRecEVFlowNet(num_bins=2, final_w_scale=0.01, **TINY)
    cfg = JLossConfig(res=TRAIN_RES, passes_loss=TRAIN_P, scales_loss=1,
                      iterative_mode="two")
    opt = j_build_opt({"name": "Adam", "lr": 1e-5}, clip_grad=100.0)
    state = j_init_state(model, opt, 1, TRAIN_RES[0], TRAIN_RES[1], 2)
    params = jax.tree.map(np.asarray, state.params)
    step = j_make_step(model, opt, cfg, "Iterative", flow_scaling=32.0,
                       donate=False)
    rng = np.random.default_rng(0)
    ev, pol = jb._synthetic_events(rng, (TRAIN_P, 1, TRAIN_N), TRAIN_RES)
    window = {
        "net_input": jnp.asarray(
            rng.normal(size=(TRAIN_P, 1, *TRAIN_RES, 2)), jnp.float32),
        "event_list": ev,
        "pol_mask": pol,
        "grad_mask": jnp.ones((TRAIN_P, 1, TRAIN_N, 1), jnp.float32),
    }
    _, loss_j = step(state, window)

    t_step, t_state, t_window = tiny_program(
        model=torch_model(params, final_w_scale=0.01))
    for k, v in window.items():
        np.testing.assert_array_equal(t_window[k].numpy(), np.asarray(v))
    _, loss_t = t_step(t_state, t_window)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)


@pytest.mark.parametrize("with_metrics,full_vis", [(False, True),
                                                   (True, False)])
def test_eval_program_matches_jax(jb, with_metrics, full_vis):
    """The window program ``bench_eval_protocol`` times (float32), against
    the JAX program built as ``bench.bench_eval_protocol`` builds it."""
    res, passes, n = EVAL_RES, EVAL_P, EVAL_N
    model = JRecEVFlowNet(num_bins=2, **TINY)
    carry = model.init_state(1, *res)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, *res, 2), jnp.float32),
                        carry)["params"]
    val = JVal(JValConfig(res=res, passes=passes, track_fw_prop=full_vis,
                          track_bw=full_vis), 1, n)
    extras = None
    if with_metrics:
        def extras(vstate, gtflow):
            rsat, fwl = val.rsat_fwl(vstate)
            flow_bw = val.window_flow(vstate, mode="backward",
                                      mask=False) * passes
            return {"rsat": rsat[0], "fwl": fwl,
                    "flow_bw": j_flow_to_u16(flow_bw),
                    "aee": j_compute_aee(flow_bw, gtflow)}
    step = j_window_step(model, val, reset_first=True, extras=extras)
    rng = np.random.default_rng(0)
    ev, pol = jb._synthetic_events(rng, (passes, 1, n), res)
    xs = jnp.zeros((passes, 1, *res, 2), jnp.float32)
    emasks = jnp.ones((passes, 1, *res, 1), jnp.float32)
    gt = jnp.asarray(rng.normal(size=(1, *res, 2)), jnp.float32)
    out_j = step(jax.jit(val.init)(), carry, params, xs, ev, pol, emasks, gt)

    run, vstate, t_carry = bt.eval_program(
        res, passes, n, full_vis=full_vis, with_metrics=with_metrics,
        device="cpu", model=torch_model(params))
    vs_t, _, mets_t = run(vstate, t_carry)

    if with_metrics:
        mets_j = out_j[3]
        for k in ("rsat", "fwl", "aee"):
            np.testing.assert_allclose(float(mets_t[k]), float(mets_j[k]),
                                       rtol=MET_RTOL, atol=MET_ATOL)
        steps = np.abs(mets_t["flow_bw"].numpy().astype(np.int64)
                       - np.asarray(mets_j["flow_bw"]).astype(np.int64))
        assert steps.max() <= 1
    else:
        assert mets_t is None
        from taming_event_flow_tpu_torch.metrics import (
            IterativeValidation,
            ValConfig,
        )
        t_val = IterativeValidation(ValConfig(res=res, passes=passes), 1, n,
                                    device="cpu")
        rsat_t, fwl_t = t_val.rsat_fwl(vs_t)
        rsat_j, fwl_j = val.rsat_fwl(out_j[0])
        np.testing.assert_allclose(
            [float(rsat_t[0]), float(fwl_t)],
            [float(rsat_j[0]), float(fwl_j)], rtol=MET_RTOL, atol=MET_ATOL)


@pytest.mark.parametrize("batch,passes,n_events", [(8, 10, 8192),
                                                   (1, 10, 8192),
                                                   (3, 2, 100)])
def test_warps_per_step_is_bench_py_formula(jb, batch, passes, n_events):
    """``bench.bench_train``'s own ``warps_per_step`` expression, read from
    its source, against the port's."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(jb.bench_train)))
    expr = next(node.value for node in ast.walk(tree)
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "warps_per_step")
    want = eval(compile(ast.Expression(expr), "bench.py", "eval"), {},
                {"batch": batch, "passes": passes, "n_events": n_events})
    assert bt.warps_per_step(batch, passes, n_events) == want


def conv_flops(model, run):
    """The analytic FLOPs of the convolutions ``run()`` executes through
    ``model``: 2 multiply-adds a weight tap and output element forward,
    the same again for the input gradient and for the weight gradient,
    each when its tensor requires grad."""
    total = [0]

    def hook(conv, args, out):
        x = args[0]
        kh, kw = conv.kernel_size
        fwd = 2 * out.numel() * (conv.in_channels // conv.groups) * kh * kw
        total[0] += fwd * (1 + int(x.requires_grad)
                           + int(conv.weight.requires_grad))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def hidden(fn):
    """``fn`` unseen by the dispatch modes, as a kernel's ctypes launch
    is."""
    def call(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return call


def test_flop_count_is_the_convolutions(monkeypatch):
    """One step's counted FLOPs are the analytic sum over the model's
    convolutions, and stay so when the warp's plain versions are hidden
    from the counters, as the kernels' launches are on the card; their
    bytes then leave the byte count."""
    model = build_model(dict(TINY, name="RecEVFlowNet", final_w_scale=0.01),
                        num_bins=2, device="cpu", seed=0)
    step, state, window = tiny_program(model=model)
    flops, nbytes, _ = bt.count_step_work(step, state, window)
    want = conv_flops(model, lambda: tiny_program(model=model)[0](
        state, window))
    assert flops == want > 0

    for name in ("splat_bilinear_plain", "gather_bilinear_plain",
                 "gather_fused_dloc_plain"):
        monkeypatch.setattr(cuda_warp, name, hidden(getattr(cuda_warp,
                                                            name)))
    flops_h, nbytes_h, _ = bt.count_step_work(*tiny_program())
    assert flops_h == flops
    assert 0 < nbytes_h < nbytes


def test_byte_count_skips_views_and_allocations():
    counter = bt._ByteCounter()
    x = torch.ones(4, 8)
    with counter:
        y = x.view(32)
        torch.empty(1000)
        z = x.transpose(0, 1)
        w = y + 1.0
    assert counter.bytes == 2 * 32 * 4  # the add: one read, one write
    assert z.shape == (8, 4) and w.shape == (32,)


def test_kernel_correctness_check_passes_on_the_cpu():
    assert bt.kernel_correctness_check("cpu") == "ok"


@pytest.mark.parametrize("name", ["splat_bilinear_plain",
                                  "gather_bilinear_plain",
                                  "gather_fused_dloc_plain"])
def test_kernel_correctness_check_fails_on_a_wrong_plain_version(
        monkeypatch, name):
    """The wrappers' route takes ``cuda_warp``'s plain versions on the CPU;
    one of them off by 1% fails the gate."""
    real = getattr(cuda_warp, name)

    def wrong(*args, **kwargs):
        out = real(*args, **kwargs)
        if isinstance(out, tuple):
            return tuple(None if o is None else o * 1.01 for o in out)
        return out * 1.01

    monkeypatch.setattr(cuda_warp, name, wrong)
    got = bt.kernel_correctness_check("cpu")
    assert got.startswith("(128, 128) C=4: numerical divergence"), got


def test_sharded_check_passes_on_gloo():
    assert bt.sharded_check("cpu") == "ok"
    assert not torch.distributed.is_initialized()


def small_benches(monkeypatch):
    """``main``'s benches cut to the tiny sizes (the gates stay as
    they are)."""
    real_eval, real_train = bt.bench_eval_protocol, bt.bench_train

    def small_eval(res, passes, n_events, **kw):
        model = build_model(dict(TINY, name="RecEVFlowNet"), num_bins=2,
                            device="cpu")
        return real_eval(EVAL_RES, min(passes, EVAL_P), EVAL_N, iters=2,
                         model=model, **kw)

    def small_train(batch, device):
        model = build_model(dict(TINY, name="RecEVFlowNet"), num_bins=2,
                            device="cpu")
        return real_train(batch, TRAIN_RES, TRAIN_P, TRAIN_N, iters=1,
                          device=device, model=model)

    monkeypatch.setattr(bt, "bench_eval_protocol", small_eval)
    monkeypatch.setattr(bt, "bench_train", small_train)


def test_main_prints_bench_py_form_on_the_cpu(monkeypatch, capsys, jb):
    small_benches(monkeypatch)
    assert bt.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert out["metric"] == "iterative_cm_train_warp_throughput"
    assert out["unit"] == "Mevents/s"
    d = out["detail"]
    assert d["kernel_correctness"] == d["sharded_check"] == "ok"
    assert d["regression_guard"] == {
        "prev_round_mevents": None, "throughput_ok": None,
        "kernel_correctness_ok": True, "sharded_check_ok": True, "ok": True}
    # no share of a card from a CPU run
    assert d["mfu"] is d["bandwidth_util"] is d["hw_peaks"] is None
    assert d["device"] == "cpu"
    assert d["dsec_480x640_protocol"]["in_program_metrics"] == [
        "AEE", "RSAT", "FWL", "flow_bw_u16"]
    assert d["dsec_480x640_inference"]["inference_dtype"] == "bfloat16"
    assert all(n == 0 for launches in d["kernel_launches"].values()
               for n in launches.values())
    assert str(jb.PREV_ROUND_MEVENTS) not in json.dumps(out)


def test_main_exits_1_when_a_gate_fails(monkeypatch, capsys):
    small_benches(monkeypatch)
    real = cuda_warp.gather_fused_dloc_plain
    monkeypatch.setattr(cuda_warp, "gather_fused_dloc_plain",
                        lambda *a, **k: tuple(
                            None if o is None else o * 1.01
                            for o in real(*a, **k)))
    assert bt.main(["--device", "cpu"]) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    guard = out["detail"]["regression_guard"]
    assert not guard["kernel_correctness_ok"] and not guard["ok"]
    assert guard["sharded_check_ok"]


def test_card_peaks():
    assert bt.card_peaks("NVIDIA H100 80GB HBM3") == {
        "fp32_tflops": 66.9, "tf32_tflops": 494.7, "bf16_tflops": 989.4,
        "hbm_gbps": 3350.0}
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "TPU v5e"):
        with pytest.raises(KeyError, match="no peaks known"):
            bt.card_peaks(name)


def test_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.train_program(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.eval_program((24, 32), 2, 64)
