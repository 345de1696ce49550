"""Checkpoint interop between the packages, on the CPU at tiny widths: the
port's decoder of flax's msgpack (``tracking.flax_msgpack``) against
``flax.serialization``, the parameter layouts both ways
(``models.port``), optax states loaded into torch optimizers
(``optax_state_to_torch``) and stepped on against optax, ``load_checkpoint``
on JAX runs, ``chip_smoke.py``'s msgpack writer against flax's bytes, the
profiler hooks, the streaming example against the JAX loop, and the
reference-import script. One tiny JAX training run is shared by the module.
"""

import argparse
import importlib.util
import json
import os

import msgpack
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax
from flax import serialization

import chip_smoke
import eval_flow_torch
import train_flow
from taming_event_flow_tpu.configs import YAMLParser as JaxParser
from taming_event_flow_tpu.models import build_model as jax_build_model
from taming_event_flow_tpu.models.port import torch_state_dict_to_flax
from taming_event_flow_tpu.ops.encodings import (
    events_to_channels as jax_events_to_channels,
)
from taming_event_flow_tpu.tracking import load_checkpoint as jax_load_ckpt
from taming_event_flow_tpu.tracking import save_checkpoint as jax_save_ckpt
from taming_event_flow_tpu.tracking.store import TrackingStore as JaxStore
from taming_event_flow_tpu.training import build_optimizer as jax_build_opt
from taming_event_flow_tpu.training import make_forward_fn as jax_forward_fn
from taming_event_flow_tpu_torch import tracking
from taming_event_flow_tpu_torch.configs import YAMLParser
from taming_event_flow_tpu_torch.data import write_synthetic_h5
from taming_event_flow_tpu_torch.models import (
    build_model,
    flax_params_to_state_dict,
    optax_state_to_torch,
    state_dict_to_flax_params,
)
from taming_event_flow_tpu_torch.tracking import flax_msgpack, load_checkpoint
from taming_event_flow_tpu_torch.training import build_optimizer
from taming_event_flow_tpu_torch.utils import annotate, profile_trace

from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (32, 32)
TINY = {"name": "RecEVFlowNet", "base_channels": 8, "num_encoders": 2,
        "num_residual_blocks": 1, "min_size": 4, "final_w_scale": 0.01}
# one optimizer step after the load, port vs optax: rtol 1e-6 plus an atol
# of 1e-4 x lr, tests/test_torch_training.py's optimizer tolerance (optax
# computes Adam's bias correction 1 - 0.999**t in float32, ~2e-5 off at
# t = 3; torch in float64)
STEP_RTOL, STEP_ATOL_LR = 1e-6, 1e-4
FLOW_TOL = 1e-5  # streaming flows, x max |flow| (the model-parity level)
LATTICE = 1.0 / 128  # the u16 wire's step, px


def load_path(name, *parts):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *parts))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


streaming = load_path("streaming_inference_torch", "examples",
                      "streaming_inference_torch.py")
import_script = load_path("import_torch_checkpoint_torch", "scripts",
                          "import_torch_checkpoint_torch.py")


def train_cfg(ds):
    """``tests/test_e2e.py``'s tiny training config."""
    return {
        "experiment": "e2e",
        "data": {"path": ds, "mode": "time", "window": 0.2,
                 "passes_loss": 2, "scales_loss": 1, "voxel": None,
                 "cache": False},
        "model": dict(TINY),
        "loss": {"warping": "Iterative", "iterative_mode": "two",
                 "round_ts": False, "flow_scaling": 8,
                 "flow_spat_smooth_weight": None,
                 "flow_temp_smooth_weight": None, "clip_grad": 100.0},
        "optimizer": {"name": "Adam", "lr": 0.0001},
        "loader": {"n_epochs": 1, "batch_size": 1, "resolution": list(RES),
                   "augment": [], "augment_prob": [],
                   "max_num_grad_events": None, "seed": 11},
        "vis": {"verbose": False, "enabled": False, "store": False},
    }


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A run of the JAX trainer: ``(store root, config path, run id)``."""
    root = tmp_path_factory.mktemp("jax_run")
    ds = root / "data"
    write_synthetic_h5(str(ds / "seq0.h5"), n_events=1500, res=RES,
                       duration=1.0, seed=1)
    path = str(root / "train.yml")
    with open(path, "w") as f:
        yaml.safe_dump(train_cfg(str(ds)), f)
    args = argparse.Namespace(config=path, path_mlflow=str(root),
                              path_cache="", prev_runid="")
    return root, path, train_flow.train(args, JaxParser(path))


def checkpoint_bytes(root, runid):
    path = os.path.join(str(root), "mlruns", "0", runid, "artifacts", "model",
                        "checkpoint.msgpack")
    with open(path, "rb") as f:
        return f.read()


def assert_same(got, ref, where="tree"):
    """Leaf for leaf and bit for bit, types and key order included."""
    assert type(got) is type(ref), (where, type(got), type(ref))
    if isinstance(ref, dict):
        assert list(got) == list(ref), where
        for k in ref:
            assert_same(got[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), where
        for i, (a, b) in enumerate(zip(got, ref)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, where
        assert got.tobytes() == ref.tobytes(), where
    else:
        assert got == ref, where


def rich_tree():
    """Every msgpack type flax writes, at sizes that reach each header."""
    rng = np.random.default_rng(0)
    return {
        "f32_0d": np.asarray(1.5, np.float32),
        "i32": np.arange(-3, 3, dtype=np.int32),
        "i64": np.arange(5, dtype=np.int64).reshape(1, 5),
        "u32": np.array([0, 2**32 - 1], np.uint32),
        "bool": np.array([[True], [False]]),
        "f64": rng.normal(size=(3, 2)),
        "big": rng.normal(size=20000).astype(np.float32),  # ext32
        "scalars": {"i64": np.int64(-7), "f32": np.float32(0.25),
                    "b": np.bool_(True)},
        "none": None, "empty": {},
        "py": [0, 127, 128, 255, 256, 65536, 2**33, -1, -32, -33, -200,
               -40000, -2**40, 1.25, True, False, "s" * 31, "t" * 40,
               "u" * 300],
        "wide_map": {f"k{i}": i for i in range(20)},
        "long_list": list(range(20)),
        "bin": b"\x00\x01" * 200,
    }


@pytest.mark.parametrize("source", ["tree", "checkpoint"])
def test_loads_matches_flax_restore(jax_run, source):
    """``flax_msgpack.loads`` gives what ``msgpack_restore`` gives, leaf
    for leaf and bitwise, on every type and header flax writes and on a
    real ``checkpoint.msgpack`` of the JAX trainer."""
    if source == "tree":
        blob = serialization.msgpack_serialize(rich_tree())
    else:
        root, _, runid = jax_run
        blob = checkpoint_bytes(root, runid)
    got = flax_msgpack.loads(blob)
    assert_same(got, serialization.msgpack_restore(blob))
    if source == "checkpoint":
        assert set(got) == {"params", "opt_state", "step", "epoch"}
        assert got["params"]["arch"]["pred_0"]["Conv_0"]["kernel"].flags[
            "WRITEABLE"]


def _chunked():
    saved = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 16
    try:
        return serialization.msgpack_serialize(
            {"w": np.arange(10, dtype=np.float32)})
    finally:
        serialization.MAX_CHUNK_SIZE = saved


REFUSED = {
    "complex": (lambda: serialization.msgpack_serialize({"c": 1 + 2j}),
                "complex"),
    "other_ext": (lambda: msgpack.packb({"e": msgpack.ExtType(7, b"abc")}),
                  "extension type 7"),
    "chunked": (_chunked, "chunked"),
    "float16": (lambda: serialization.msgpack_serialize(
        {"h": np.zeros(2, np.float16)}), "float16"),
    "bfloat16": (lambda: serialization.msgpack_serialize(
        {"h": np.asarray(jnp.zeros(2, jnp.bfloat16))}), "bfloat16"),
    "truncated": (lambda: serialization.msgpack_serialize(
        {"w": np.ones(3, np.float32)})[:-1], "truncated"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_loads_refuses_what_no_checkpoint_holds(case):
    make, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        flax_msgpack.loads(make())


def test_state_dict_to_flax_params_matches_jax():
    """RecEVFlowNet's ``state_dict`` converts to the tree the JAX
    package's ``torch_state_dict_to_flax`` builds, bitwise."""
    sd = build_model(TINY, device="cpu", seed=3).state_dict()
    got = state_dict_to_flax_params(sd)
    ref = torch_state_dict_to_flax({k: v.numpy() for k, v in sd.items()})
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


FAMILIES = {
    "RecEVFlowNet": TINY,
    "EVFlowNet": dict(TINY, name="EVFlowNet"),
    "RecFireFlowNet": {"name": "RecFireFlowNet", "base_channels": 4},
    "FireFlowNet": {"name": "FireFlowNet", "base_channels": 4},
    "norm_IN": dict(TINY, norm="IN"),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_flax_params_round_trip(family):
    """``state_dict_to_flax_params`` inverts ``flax_params_to_state_dict``
    on each family's JAX parameters, bitwise, and the port's model loads
    the converted ``state_dict``."""
    cfg = FAMILIES[family]
    jm = jax_build_model(dict(cfg), num_bins=2)
    x = jnp.zeros((1, *RES, 2))
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(4), x, jm.init_state(1, *RES))["params"])
    sd = flax_params_to_state_dict(params)
    build_model(cfg, device="cpu").load_state_dict(sd)
    back = state_dict_to_flax_params(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# name, optimizer config, clip
OPTIMIZERS = {"adam_clip": ({"name": "Adam", "lr": 1e-3}, 100.0),
              "adamw": ({"name": "AdamW", "lr": 1e-3}, None),
              "sgd_clip": ({"name": "SGD", "lr": 1e-3}, 100.0)}


def seeded_grads(params, seed):
    """Gradients of ``params``'s structure, large enough that the clip at
    100 engages."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [
        jnp.asarray(10.0 * rng.normal(size=a.shape).astype(np.float32))
        for a in leaves])


def optax_run(opt_cfg, clip, steps=2):
    """The JAX package's optimizer over a tiny model's parameters after
    ``steps`` updates on seeded gradients: ``(tx, params, opt_state)``."""
    jm = jax_build_model(dict(TINY), num_bins=2)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, *RES, 2)),
                     jm.init_state(1, *RES))["params"]
    tx = jax_build_opt(opt_cfg, clip_grad=clip)
    state = tx.init(params)
    for k in range(steps):
        updates, state = tx.update(seeded_grads(params, k), state, params)
        params = optax.apply_updates(params, updates)
    return tx, params, state


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_pair(ckpt, opt_cfg, clip):
    model = build_model(TINY, device="cpu", seed=9)
    model.load_state_dict(ckpt["model"])
    opt = build_optimizer(opt_cfg, model.parameters(), clip_grad=clip,
                          device="cpu")
    return model, opt


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optax_state_loads_and_steps_on(tmp_path, name):
    """A JAX checkpoint of parameters and optax state after two updates:
    ``load_checkpoint`` + ``optax_state_to_torch`` give the parameters,
    ``exp_avg`` and ``exp_avg_sq`` bitwise and ``step`` equal to optax's
    count; one more step on the same gradients then lands on optax's
    update (clip, Adam and AdamW's decay included) within ``STEP_RTOL``
    plus ``STEP_ATOL_LR`` x lr."""
    opt_cfg, clip = OPTIMIZERS[name]
    tx, params, state = optax_run(opt_cfg, clip)
    store = tracking.TrackingStore(str(tmp_path))
    runid = store.start_run().info.run_id
    jax_save_ckpt(runid, params, state, step=2, epoch=1,
                  store=JaxStore(str(tmp_path)))
    ckpt, epoch = load_checkpoint(runid, store=store)
    assert (epoch, ckpt["step"], ckpt["optimizer"]) == (1, 2, None)
    model, opt = port_pair(ckpt, opt_cfg, clip)
    optax_state_to_torch(ckpt["optax_state"], model, opt)

    named = dict(model.named_parameters())
    ref = flax_params_to_state_dict(np_tree(params))
    assert all(torch.equal(named[k], v) for k, v in ref.items())
    adam = [s for s in jax.tree.leaves(
        state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    if name == "sgd_clip":
        assert not adam and not opt.state
    else:
        mu = flax_params_to_state_dict(np_tree(adam[0].mu))
        nu = flax_params_to_state_dict(np_tree(adam[0].nu))
        for k, p in named.items():
            s = opt.state[p]
            assert torch.equal(s["exp_avg"], mu[k])
            assert torch.equal(s["exp_avg_sq"], nu[k])
            assert s["step"].dtype == torch.float32
            assert float(s["step"]) == int(adam[0].count) == 2

    g = seeded_grads(params, 2)
    updates, state = tx.update(g, state, params)
    want = flax_params_to_state_dict(np_tree(optax.apply_updates(params,
                                                                 updates)))
    grads = flax_params_to_state_dict(np_tree(g))
    for k, p in named.items():
        p.grad = grads[k].clone()
    opt.step()
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=STEP_RTOL,
                                   atol=STEP_ATOL_LR * opt_cfg["lr"],
                                   err_msg=k)


@pytest.fixture(scope="module")
def adam_tree():
    _, _, state = optax_run(*OPTIMIZERS["adam_clip"])
    return serialization.to_state_dict(np_tree(state))


def _drop_one(tree):
    mu = tree["1"]["0"]["mu"]
    del mu["arch"]["pred_0"]
    return tree


def _add_one(tree):
    mu = tree["1"]["0"]["mu"]
    mu["arch"]["pred_9"] = mu["arch"]["pred_0"]
    return tree


# case -> (tree edit, optimizer config, message)
REFUSALS = {
    "adam_into_sgd": (lambda t: t, {"name": "SGD"}, "keeps none"),
    "empty_into_adam": (lambda t: {}, {"name": "Adam"}, "found 0"),
    "missing_param": (_drop_one, {"name": "Adam"}, "missing"),
    "extra_param": (_add_one, {"name": "Adam"}, "extra"),
    "other_model": (lambda t: t, {"name": "Adam"}, "not built over"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_optax_state_refusals(adam_tree, case):
    """The tree and the optimizer must agree; a mismatch raises and names
    what differs."""
    import copy

    edit, opt_cfg, match = REFUSALS[case]
    model = build_model(TINY, device="cpu")
    owner = build_model(TINY, device="cpu") if case == "other_model" \
        else model
    opt = build_optimizer(opt_cfg, owner.parameters(), device="cpu")
    with pytest.raises(ValueError, match=match):
        optax_state_to_torch(edit(copy.deepcopy(adam_tree)), model, opt)
    assert not opt.state


def test_chip_smoke_writer_matches_flax():
    """``chip_smoke.flax_to_bytes`` writes flax's bytes: on every type and
    header flax writes, and on the JAX checkpoint tree the smoke builds
    from a port model and its Adam state (Adam after the clip)."""
    # to_bytes's last step, which keeps the tree's key order
    assert chip_smoke.flax_to_bytes(rich_tree()) == \
        serialization.msgpack_serialize(rich_tree(), in_place=True)
    model = build_model(TINY, device="cpu", seed=2)
    opt = build_optimizer({"name": "Adam", "lr": 1e-3}, model.parameters(),
                          clip_grad=100.0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    tree = chip_smoke.jax_checkpoint_tree(model, opt, step=3, epoch=1)
    blob = chip_smoke.flax_to_bytes(tree)
    assert blob == serialization.to_bytes(tree)
    back = flax_msgpack.loads(blob)
    sd = flax_params_to_state_dict(back["params"])
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    assert int(back["opt_state"]["1"]["0"]["count"]) == 3


def test_profile_trace_and_annotate(tmp_path):
    """``profile_trace(None)`` profiles nothing; ``profile_trace(dir)``
    writes a trace that holds the ``annotate`` range."""
    with profile_trace(None):
        assert not torch.autograd._profiler_enabled()
    logdir = tmp_path / "trace"
    with profile_trace(str(logdir)):
        with annotate("stream_pass"):
            torch.ones(64).cumsum(0)
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "stream_pass" for e in events)


def jax_stream_reference(root, runid, n_events, passes):
    """The JAX example's loop over the same slices: the last pass's
    finest flow map."""
    jm = jax_build_model(dict(TINY), num_bins=2)
    carry = jm.init_state(1, *RES)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *RES, 2)),
                     carry)["params"]
    restored, _ = jax_load_ckpt(
        runid, {"params": params, "opt_state": None, "step": np.int64(0),
                "epoch": np.int64(0)}, store=JaxStore(str(root)))
    forward = jax_forward_fn(jm, flow_scaling=32.0)
    rng = np.random.default_rng(0)
    for _ in range(passes + 1):  # the warm-up slice first
        ev = np.zeros((1, n_events, 4), np.float32)
        ev[..., 0] = np.sort(rng.uniform(0, 1, (1, n_events)))
        ev[..., 1] = rng.integers(0, RES[0], (1, n_events))
        ev[..., 2] = rng.integers(0, RES[1], (1, n_events))
        ev[..., 3] = rng.choice([-1.0, 1.0], (1, n_events))
        ev = jnp.asarray(ev)
        x = jax_events_to_channels(ev[0, :, 2], ev[0, :, 1], ev[0, :, 3],
                                   RES)[None]
        flows, carry = forward(restored["params"], carry, x)
    return np.asarray(flows[-1])


@pytest.mark.parametrize("wire", ["f32", "u16"])
def test_stream_matches_jax_loop(jax_run, wire, capsys):
    """The streaming example on the CPU from the JAX run: the last map
    matches the JAX example's loop over the same slices within 1e-5 of
    max |flow| (the u16 wire within one lattice step more)."""
    root, _, runid = jax_run
    args = streaming.parse_args([
        "--runid", runid, "--path_mlflow", str(root), "--height",
        str(RES[0]), "--width", str(RES[1]), "--n_events", "400",
        "--passes", "3", "--wire", wire, "--device", "cpu"])
    flow, lat = streaming.stream(args)
    assert f"restored run {runid}" in capsys.readouterr().out
    assert lat.shape == (3,) and np.all(lat > 0)
    ref = jax_stream_reference(root, runid, 400, 3)
    assert flow.shape == ref.shape == (1, *RES, 2)
    scale = np.abs(ref).max()
    assert scale > 0
    slack = LATTICE if wire == "u16" else 0.0
    assert np.abs(flow - ref).max() <= FLOW_TOL * scale + slack


def test_stream_refuses_voxel_runs(tmp_path):
    store = tracking.TrackingStore(str(tmp_path))
    run = store.start_run()
    store.log_params({"data": str({"voxel": 4}), "model": str(TINY)})
    args = streaming.parse_args(["--runid", run.info.run_id, "--path_mlflow",
                                 str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="4-bin voxels"):
        streaming.stream(args)


def test_import_script_makes_an_evaluable_run(tmp_path, capsys):
    """A reference ``model.pth`` (here a seeded port model's
    ``state_dict``) imported by the script: the run's params rebuild the
    model, and ``eval_flow_torch.load_weights`` loads the weights
    bitwise."""
    sd = build_model(TINY, device="cpu", seed=7).state_dict()
    pth = str(tmp_path / "model.pth")
    torch.save(sd, pth)
    cfg = str(tmp_path / "train.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(train_cfg(""), f)
    runid = import_script.main([pth, "--path_mlflow", str(tmp_path),
                                "--config", cfg])
    assert f"Imported checkpoint into run: {runid}" in capsys.readouterr().out
    tracking.set_tracking_uri(str(tmp_path))
    params = tracking.get_run(runid).data.params
    model_cfg = YAMLParser().merge_configs(params)["model"]
    model = build_model(dict(model_cfg), device="cpu", seed=8)
    eval_flow_torch.load_weights(model, runid, "cpu")
    loaded = model.state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())
