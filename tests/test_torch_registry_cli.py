"""The registry variants through both CLIs on the CPU: the twin of
``tests/test_e2e.py::test_train_eval_registry_variants`` for the port.

Each case trains one epoch with ``train_flow.py`` and with
``train_flow_torch.py`` from the JAX trainer's own initial parameters
(converted and saved as a port checkpoint that the port's CLI warm-starts
from), then evaluates the JAX run's weights with ``eval_flow.py`` and with
``eval_flow_torch.py`` (the JAX checkpoint converted and written into the
run as ``checkpoint.pt``). The epoch loss must agree within 1e-4 relative
(``tests/test_torch_train_cli.py``'s gate), every metric within the
pipeline-parity tolerance."""

import argparse

import numpy as np
import pytest
import yaml

import jax

import eval_flow
import eval_flow_torch
import train_flow
import train_flow_torch
from taming_event_flow_tpu.configs import YAMLParser as JaxParser
from taming_event_flow_tpu.models import build_model as jax_build_model
from taming_event_flow_tpu.tracking import load_checkpoint as jax_load_ckpt
from taming_event_flow_tpu.tracking.store import TrackingStore as JaxStore
from taming_event_flow_tpu.training import build_optimizer as jax_build_opt
from taming_event_flow_tpu.training.step import (
    init_train_state as jax_init_state,
)
from taming_event_flow_tpu_torch import tracking
from taming_event_flow_tpu_torch.configs import YAMLParser
from taming_event_flow_tpu_torch.data import write_synthetic_h5
from taming_event_flow_tpu_torch.models import flax_params_to_state_dict

from .test_torch_eval_cli import eval_cfg
from .test_torch_train_cli import RES, train_cfg, write_cfg
from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

LOSS_RTOL = 1e-4
METRIC_TOL = dict(rtol=2e-3, atol=2e-4)  # the pipeline-parity tolerance

CASES = {
    "voxel": {"data": {"voxel": 4}},
    "fire": {"model": {"name": "FireFlowNet", "base_channels": 8,
                       "final_w_scale": 0.01}},
    "linear": {"loss": {"warping": "Linear"},
               "metrics": {"warping": "Linear"}},
    "evflownet": {"model": {"name": "EVFlowNet", "base_channels": 8,
                            "num_encoders": 2, "num_residual_blocks": 1,
                            "min_size": 4, "final_w_scale": 0.01}},
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    ds = tmp_path_factory.mktemp("registry_cli") / "data"
    write_synthetic_h5(str(ds / "seq0.h5"), n_events=3000, res=RES,
                       n_flow_frames=8, seed=1)
    return str(ds)


def _configs(ds, case):
    tcfg = train_cfg(ds, n_epochs=1)
    ecfg = eval_cfg(ds, store=False)
    change = CASES[case]
    for section in ("data", "loss"):
        tcfg[section].update(change.get(section, {}))
    if "model" in change:
        tcfg["model"] = dict(change["model"])
    ecfg["metrics"].update(change.get("metrics", {}))
    return tcfg, ecfg


def _losses(root, runid):
    return [v for _, v, _ in JaxStore(str(root)).read_metric(runid, "loss")]


def _params(cfg, num_bins, key):
    """The JAX model of ``cfg`` and parameters drawn from ``key``."""
    jm = jax_build_model(dict(cfg["model"]), num_bins=num_bins)
    opt = jax_build_opt(cfg["optimizer"], clip_grad=cfg["loss"]["clip_grad"])
    state = jax_init_state(jm, opt, 1, *RES, num_bins, rng_key=key)
    return jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("case", list(CASES))
def test_registry_variant_cli_matches_jax(dataset, tmp_path, case):
    tcfg, ecfg = _configs(dataset, case)
    voxel = tcfg["data"]["voxel"]
    num_bins = 2 if voxel is None else voxel
    tpath = write_cfg(tmp_path / "train.yml", tcfg)
    epath = write_cfg(tmp_path / "eval.yml", ecfg)

    # training: the JAX CLI, then the port's from the same initial weights
    jroot = tmp_path / "jax"
    jax_runid = train_flow.train(argparse.Namespace(
        config=tpath, path_mlflow=str(jroot), path_cache="", prev_runid=""),
        JaxParser(tpath))
    ref = _losses(jroot, jax_runid)

    proot = tmp_path / "port"
    store = tracking.TrackingStore(str(proot))
    init = store.start_run().info.run_id
    tracking.save_checkpoint(init, flax_params_to_state_dict(_params(
        tcfg, num_bins, jax.random.PRNGKey(tcfg["loader"]["seed"]))),
        store=store)
    runid = train_flow_torch.train(argparse.Namespace(
        config=tpath, path_mlflow=str(proot), path_cache="",
        prev_runid=init), YAMLParser(tpath), device="cpu")
    got = _losses(proot, runid)
    assert len(ref) == 1 and np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)

    # evaluation of the JAX run's weights by both CLIs
    restored, _ = jax_load_ckpt(
        jax_runid, {"params": _params(tcfg, num_bins, jax.random.PRNGKey(0)),
                    "opt_state": None, "step": np.int64(0),
                    "epoch": np.int64(0)}, store=JaxStore(str(jroot)))
    assert restored is not None
    tracking.save_checkpoint(
        jax_runid, flax_params_to_state_dict(
            jax.tree.map(np.asarray, restored["params"])),
        store=tracking.TrackingStore(str(jroot)))
    results = {}
    for tag, module, parser_cls, kw in (
            ("jax", eval_flow, JaxParser, {}),
            ("port", eval_flow_torch, YAMLParser, {"device": "cpu"})):
        results[tag] = module.test(argparse.Namespace(
            runid=jax_runid, config=epath, path_mlflow=str(jroot),
            path_results=str(tmp_path / f"results_{tag}") + "/"),
            parser_cls(epath), **kw)
    jres, pres = results["jax"], results["port"]
    assert jres["AEE"] and sorted(pres) == sorted(jres)
    for name, per_seq in jres.items():
        assert sorted(pres[name]) == sorted(per_seq), name
        for seq, v in per_seq.items():
            assert np.isfinite(float(pres[name][seq]))
            np.testing.assert_allclose(float(pres[name][seq]), float(v),
                                       err_msg=f"{name} {seq}", **METRIC_TOL)
