"""The port's training CLI, ``train_flow_torch.py``, on the CPU at the tiny
config of ``tests/test_e2e.py``: checkpoint and loss metric, the warm start
(history replay, Adam state carried), the configs it refuses, and the loss
history against the JAX CLI's from the same initial weights (the registry
variants: ``tests/test_torch_registry_cli.py``)."""

import argparse
import os
import runpy
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

import train_flow
import train_flow_torch
from taming_event_flow_tpu.configs import YAMLParser as JaxParser
from taming_event_flow_tpu.models import build_model as jax_build_model
from taming_event_flow_tpu.tracking.store import TrackingStore as JaxStore
from taming_event_flow_tpu.training import build_optimizer as jax_build_opt
from taming_event_flow_tpu.training.step import (
    init_train_state as jax_init_state,
)
from taming_event_flow_tpu_torch import tracking
from taming_event_flow_tpu_torch.configs import YAMLParser
from taming_event_flow_tpu_torch.data import write_synthetic_h5
from taming_event_flow_tpu_torch.models import (
    build_model,
    flax_params_to_state_dict,
)
from taming_event_flow_tpu_torch.tracking import load_checkpoint

from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (32, 32)
STEPS_PER_EPOCH = 4  # 9 windows of 0.2 s in a 2 s sequence, 2 passes each
BF16_LOSS_RTOL = 2e-2  # compute_dtype bfloat16, the port's CLI against JAX's


def write_cfg(path, d):
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return str(path)


def train_cfg(ds, **loader):
    """``tests/test_e2e.py``'s tiny training config."""
    return {
        "experiment": "e2e",
        "data": {"path": ds, "mode": "time", "window": 0.2,
                 "passes_loss": 2, "scales_loss": 1, "voxel": None,
                 "cache": False},
        "model": {"name": "RecEVFlowNet", "base_channels": 8,
                  "num_encoders": 2, "num_residual_blocks": 1,
                  "min_size": 4, "final_w_scale": 0.01},
        "loss": {"warping": "Iterative", "iterative_mode": "two",
                 "round_ts": False, "flow_scaling": 8,
                 "flow_spat_smooth_weight": None,
                 "flow_temp_smooth_weight": None, "clip_grad": 100.0},
        "optimizer": {"name": "Adam", "lr": 0.0001},
        "loader": dict({"n_epochs": 2, "batch_size": 1,
                        "resolution": list(RES), "augment": [],
                        "augment_prob": [], "max_num_grad_events": None,
                        "seed": 11}, **loader),
        "vis": {"verbose": False, "enabled": False, "store": False},
    }


def run_port(cfg_path, root, prev_runid="", device="cpu"):
    args = argparse.Namespace(config=cfg_path, path_mlflow=str(root),
                              path_cache="", prev_runid=prev_runid)
    return train_flow_torch.train(args, YAMLParser(cfg_path), device=device)


def losses(root, runid):
    return [v for _, v, _ in JaxStore(str(root)).read_metric(runid, "loss")]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    ds = root / "data"
    write_synthetic_h5(str(ds / "seq0.h5"), n_events=3000, res=RES,
                       n_flow_frames=8, seed=1)
    return root, str(ds)


@pytest.fixture(scope="module")
def trained_run(workspace):
    root, ds = workspace
    cfg_path = write_cfg(root / "train.yml", train_cfg(ds))
    return root, cfg_path, run_port(cfg_path, root)


def test_train_produces_checkpoint_and_metrics(trained_run):
    """The run writes ``checkpoint.pt`` and one finite loss per epoch, and
    the JAX store reads it."""
    root, _, runid = trained_run
    run_dir = os.path.join(str(root), "mlruns", "0", runid)
    assert os.path.isfile(
        os.path.join(run_dir, "artifacts", "model", "checkpoint.pt"))
    found = losses(root, runid)
    assert len(found) == 2 and np.all(np.isfinite(found))
    params = JaxStore(str(root)).get_run(runid).data.params
    assert params["prev_runid"] == ""
    assert yaml.safe_load(open(os.path.join(REPO, "configs", "train_flow.yml"))
                          )["loss"]["warping"] in params["loss"]
    ckpt, _ = load_checkpoint(runid, store=tracking.TrackingStore(str(root)))
    model = build_model(train_cfg("")["model"], num_bins=2, device="cpu")
    model.load_state_dict(ckpt["model"])
    adam = {int(s["step"]) for s in ckpt["optimizer"]["state"].values()}
    assert adam == {ckpt["step"]} and ckpt["step"] % STEPS_PER_EPOCH == 0


def test_warm_start_resume(trained_run, capsys):
    """``--prev_runid`` restores the weights and the Adam state, replays the
    prior loss history into the new run, and counts steps on from the
    checkpoint's."""
    root, cfg_path, runid = trained_run
    ckpt1, epoch1 = load_checkpoint(runid,
                                    store=tracking.TrackingStore(str(root)))
    capsys.readouterr()
    runid2 = run_port(cfg_path, root, prev_runid=runid)
    assert f"Model restored from {runid}" in capsys.readouterr().out
    assert runid2 != runid
    before, after = losses(root, runid), losses(root, runid2)
    new_epochs = 2 - epoch1  # the warm start resumes at the checkpoint's
    assert after[:len(before)] == before and len(after) == len(
        before) + new_epochs
    ckpt2, _ = load_checkpoint(runid2, store=tracking.TrackingStore(str(root)))
    # the warm run's best epoch: one of its new ones
    gained = ckpt2["step"] - ckpt1["step"]
    assert gained in [STEPS_PER_EPOCH * (e + 1) for e in range(new_epochs)]
    # Adam's count goes on from the checkpoint's: its state was restored
    adam = {int(s["step"]) for s in ckpt2["optimizer"]["state"].values()}
    assert adam == {ckpt2["step"]}


@pytest.mark.parametrize("change,error,rtol", [
    ({"parallel": {"event": 2}}, ValueError, None),
    ({"parallel": {"data": 2}}, ValueError, None),
    ({"model": {"norm": "BN"}}, NotImplementedError, None),
    ({"model": {"compute_dtype": "bfloat16"}}, None, BF16_LOSS_RTOL),
    ({"model": {"use_upsample_conv": False}}, None, 1e-4),
], ids=["event", "data", "norm", "compute_dtype", "upsample_conv"])
def test_unported_configs_raise(workspace, tmp_path, change, error, rtol):
    """``norm: BN``, which neither package trains, raises
    ``NotImplementedError``; a ``parallel`` mesh larger than the world
    (here one process) raises ``ValueError``, as ``train_flow.py`` does;
    each names ROADMAP.md. ``model.compute_dtype`` and
    ``use_upsample_conv: false``, once refused here, are ported: their
    cases (``error`` None) hold the port's CLI to ``train_flow.py``'s
    epoch loss from the same initial weights, at ``rtol``: bf16 level for
    the first (2e-2 relative, measured 2.1e-3: the packages' bf16 sigmoids
    round apart, ``tests/test_torch_options.py``), the suite's float32
    loss-history tolerance of 1e-4 for the transposed-conv decoder
    (measured 1.8e-8)."""
    _, ds = workspace
    cfg = train_cfg(ds, n_epochs=1)
    for section, values in change.items():
        cfg.setdefault(section, {}).update(values)
    path = write_cfg(tmp_path / "cfg.yml", cfg)
    if error is not None:
        with pytest.raises(error, match="ROADMAP"):
            run_port(path, tmp_path)
        return
    jargs = argparse.Namespace(config=path, path_mlflow=str(tmp_path / "jax"),
                               path_cache="", prev_runid="")
    ref = losses(tmp_path / "jax", train_flow.train(jargs, JaxParser(path)))
    jm = jax_build_model(dict(cfg["model"]), num_bins=2)
    jstate = jax_init_state(
        jm, jax_build_opt(cfg["optimizer"], clip_grad=100.0), 1, *RES, 2,
        rng_key=jax.random.PRNGKey(cfg["loader"]["seed"]))
    store = tracking.TrackingStore(str(tmp_path / "port"))
    init = store.start_run().info.run_id
    tracking.save_checkpoint(init, flax_params_to_state_dict(
        jax.tree.map(np.asarray, jstate.params)), store=store)
    got = losses(tmp_path / "port",
                 run_port(path, tmp_path / "port", prev_runid=init))
    assert len(ref) == 1 and np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=rtol)


def test_train_raises_without_a_card(workspace, tmp_path, monkeypatch):
    _, ds = workspace
    path = write_cfg(tmp_path / "cfg.yml", train_cfg(ds))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = argparse.Namespace(config=path, path_mlflow=str(tmp_path),
                              path_cache="", prev_runid="")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_flow_torch.train(args, YAMLParser(path))
    assert not os.path.exists(tmp_path / "mlruns")


def test_effective_passes_matches_jax():
    for mode in ("one", "two", "four"):
        for warping in ("Iterative", "Linear"):
            cfg = {"data": {"passes_loss": 5},
                   "loss": {"warping": warping, "iterative_mode": mode}}
            assert train_flow_torch.effective_passes(
                cfg) == train_flow.effective_passes(cfg)


def test_cli_script_trains_on_the_cpu_when_asked(workspace, tmp_path,
                                                monkeypatch, capsys):
    """``python train_flow_torch.py --config ... --device cpu`` runs the
    CLI end to end (its ``__main__`` block, run in this process)."""
    _, ds = workspace
    path = write_cfg(tmp_path / "cfg.yml", train_cfg(ds, n_epochs=1))
    monkeypatch.setattr(sys, "argv", [
        "train_flow_torch.py", "--config", path, "--path_mlflow",
        str(tmp_path), "--device", "cpu"])
    runpy.run_path(os.path.join(REPO, "train_flow_torch.py"),
                   run_name="__main__")
    runid = capsys.readouterr().out.split("Run id:")[1].split()[0]
    assert len(losses(tmp_path, runid)) == 1


def test_cli_loss_history_matches_jax(tmp_path):
    """The gate of the training slice: from the JAX trainer's own initial
    parameters (``init_train_state(..., rng_key=PRNGKey(seed))``, as
    ``train_flow.py`` draws them), converted and saved as a port checkpoint
    that the port's CLI warm-starts from, the port logs the JAX CLI's epoch
    losses on the same file to rtol 1e-4 (``tests/test_torch_training.py``'s
    tolerance for a loss history).

    Three epochs of two optimizer steps each: six steps, measured within
    7.2e-6. The loss's gradient is discontinuous in the flows (ROADMAP.md
    §3), so a longer history parts: on the e2e file (four steps an epoch)
    the first epoch agreed within 2.2e-6 and the second, steps 5-8, parted
    at 3.1e-4."""
    ds = tmp_path / "data"
    write_synthetic_h5(str(ds / "seq0.h5"), n_events=1500, res=RES,
                       duration=1.0, seed=1)
    cfg = train_cfg(str(ds), n_epochs=3)
    path = write_cfg(tmp_path / "train.yml", cfg)

    jargs = argparse.Namespace(config=path, path_mlflow=str(tmp_path / "jax"),
                               path_cache="", prev_runid="")
    jax_runid = train_flow.train(jargs, JaxParser(path))
    ref = losses(tmp_path / "jax", jax_runid)

    jm = jax_build_model(dict(cfg["model"]), num_bins=2)
    jstate = jax_init_state(
        jm, jax_build_opt(cfg["optimizer"], clip_grad=100.0), 1, *RES, 2,
        rng_key=jax.random.PRNGKey(cfg["loader"]["seed"]))
    model = build_model(cfg["model"], num_bins=2, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, jstate.params)))
    store = tracking.TrackingStore(str(tmp_path / "port"))
    init = store.start_run().info.run_id
    tracking.save_checkpoint(init, model.state_dict(), store=store)

    runid = run_port(path, tmp_path / "port", prev_runid=init)
    got = losses(tmp_path / "port", runid)
    assert len(ref) == 3 and len(set(ref)) == 3
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_warm_start_from_a_jax_run(tmp_path, capsys):
    """The JAX trainer makes run A; ``train_flow.train --prev_runid A`` and
    ``train_flow_torch.train --prev_runid A`` then restore its
    ``checkpoint.msgpack`` (weights, Adam moments and count, epoch), replay
    the same history exactly, resume at the same epoch and log the same
    epoch losses within rtol 1e-4 over at most six steps (the CLI gate's
    tolerance above). Before the port read the JAX checkpoint, its warm
    start trained from the seeded weights at epoch 0."""
    ds = tmp_path / "data"
    write_synthetic_h5(str(ds / "seq0.h5"), n_events=1500, res=RES,
                       duration=1.0, seed=1)
    root = tmp_path / "store"
    path_a = write_cfg(tmp_path / "a.yml", train_cfg(str(ds), n_epochs=2))
    path = write_cfg(tmp_path / "warm.yml", train_cfg(str(ds), n_epochs=3))

    def jax_train(cfg_path, prev):
        args = argparse.Namespace(config=cfg_path, path_mlflow=str(root),
                                  path_cache="", prev_runid=prev)
        return train_flow.train(args, JaxParser(cfg_path))

    run_a = jax_train(path_a, "")
    ckpt, epoch = load_checkpoint(run_a,
                                  store=tracking.TrackingStore(str(root)))
    assert ckpt["optimizer"] is None and ckpt["optax_state"] is not None
    assert epoch in (0, 1) and ckpt["step"] == 2 * (epoch + 1)
    capsys.readouterr()
    runs = {"jax": jax_train(path, run_a),
            "port": run_port(path, root, prev_runid=run_a)}
    assert f"Model restored from {run_a}" in capsys.readouterr().out

    store = JaxStore(str(root))
    history = store.read_metric(run_a, "loss")
    assert len(history) == 2
    got = {k: store.read_metric(r, "loss") for k, r in runs.items()}
    for rows in got.values():
        assert [(v, s) for _, v, s in rows[:2]] == [
            (v, s) for _, v, s in history]
        assert [s for _, _, s in rows[2:]] == list(range(epoch, 3))
    jl, pl = ([v for _, v, _ in got[k][2:]] for k in ("jax", "port"))
    assert len(jl) * 2 <= 6 and np.isfinite(jl).all()
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
