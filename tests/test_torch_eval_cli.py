"""The port's eval CLI, ``eval_flow_torch.py``, against ``eval_flow.py`` on
the CPU at ``tests/test_e2e.py``'s tiny config (32x32).

One JAX run is trained with ``train_flow.train``; its ``checkpoint.msgpack``
is read with the JAX ``load_checkpoint``, converted with
``models.flax_params_to_state_dict`` and written into the same run as the
port's ``checkpoint.pt``, so both CLIs evaluate identical weights. Each
case holds the port's per-sequence metrics, eval id, ``flow_bw`` PNG names,
``timestamps.txt`` and PNG pixels to the JAX CLI's."""

import argparse
import os
import runpy
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import eval_flow
import eval_flow_torch
import prepare_dsec_submission
import train_flow
from taming_event_flow_tpu.configs import YAMLParser as JaxParser
from taming_event_flow_tpu.data import base as jbase
from taming_event_flow_tpu.models import build_model as jax_build_model
from taming_event_flow_tpu.tracking import load_checkpoint as jax_load_ckpt
from taming_event_flow_tpu.tracking.store import TrackingStore as JaxStore
from taming_event_flow_tpu_torch import tracking
from taming_event_flow_tpu_torch.configs import YAMLParser
from taming_event_flow_tpu_torch.data import write_synthetic_h5
from taming_event_flow_tpu_torch.models import flax_params_to_state_dict

from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (32, 32)
RTOL, ATOL = 2e-3, 2e-4  # the pipeline-parity tolerance


def write_cfg(path, d):
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return str(path)


def train_cfg(ds):
    """``tests/test_e2e.py``'s ``make_train_cfg``."""
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
        "loader": {"n_epochs": 2, "batch_size": 1, "resolution": list(RES),
                   "augment": [], "augment_prob": [],
                   "max_num_grad_events": None, "seed": 11},
        "vis": {"verbose": False, "enabled": False, "store": False},
    }


def eval_cfg(ds, store=True):
    """``tests/test_e2e.py``'s ``make_eval_cfg``."""
    return {
        "data": {"path": ds, "mode": "gtflow", "window": 1,
                 "passes_loss": 2, "cache": False},
        "loader": {"resolution": list(RES), "augment": [],
                   "max_num_grad_events": None, "seed": 11},
        "metrics": {"warping": "Iterative",
                    "name": ["FWL", "RSAT", "AEE"]},
        "vis": {"enabled": False, "store": store, "bars": False,
                "mask_output": False, "dynamic": False,
                "show": ["flow_bw"] if store else None},
    }


def time_cfg(ds):
    """``test_eval_time_mode_deblurring_metrics``'s config, storing the
    (GT-less, so empty) ``flow_bw`` tree and its timestamps."""
    cfg = eval_cfg(ds)
    cfg["data"].update(mode="time", window=0.2)
    cfg["loader"]["n_events_pad"] = 1001
    cfg["metrics"]["name"] = ["FWL", "RSAT"]
    return cfg


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """A JAX training run whose weights also sit in it as ``checkpoint.pt``."""
    root = tmp_path_factory.mktemp("eval_cli")
    ds = root / "data"
    write_synthetic_h5(str(ds / "seq0.h5"), n_events=3000, res=RES,
                       n_flow_frames=8, seed=1)
    cfg = train_cfg(str(ds))
    path = write_cfg(root / "train.yml", cfg)
    args = argparse.Namespace(config=path, path_mlflow=str(root),
                              path_cache="", prev_runid="")
    runid = train_flow.train(args, JaxParser(path))

    jm = jax_build_model(dict(cfg["model"]), num_bins=2)
    carry = jm.init_state(1, *RES)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *RES, 2)),
                     carry)["params"]
    template = {"params": params, "opt_state": None,
                "step": np.int64(0), "epoch": np.int64(0)}
    restored, _ = jax_load_ckpt(runid, template, store=JaxStore(str(root)))
    assert restored is not None
    tracking.save_checkpoint(
        runid, flax_params_to_state_dict(
            jax.tree.map(np.asarray, restored["params"])),
        store=tracking.TrackingStore(str(root)))
    return root, str(ds), runid


def _rectified_data(root):
    ds = root / "data_rect"
    write_synthetic_h5(str(ds / "seq_rect.h5"), n_events=3000, res=RES,
                       n_flow_frames=8, seed=3, rectify=True)
    cfg = eval_cfg(str(ds))
    # a static event bucket, as the DSEC protocol sets one
    cfg["loader"]["n_events_pad"] = 1001
    return cfg


def _jump_data(root):
    ds = root / "data_jump"
    write_synthetic_h5(str(ds / "seq0.h5"), n_events=3000, res=RES,
                       n_flow_frames=8, seed=5, gt_gap_after=0.5)
    return eval_cfg(str(ds))


CASES = {
    "gtflow_store": lambda root, ds: eval_cfg(ds),
    "time_mode": lambda root, ds: time_cfg(ds),
    "ts_jump": lambda root, ds: _jump_data(root),
    # the loaders agree on a rectified file only on the numpy remap path
    # (cv2's remap is patched off in the JAX loader, as in test_torch_data)
    "rectified": lambda root, ds: _rectified_data(root),
}


def run_cli(module, parser_cls, cfg_path, root, runid, results, **kw):
    args = argparse.Namespace(runid=runid, config=cfg_path,
                              path_mlflow=str(root),
                              path_results=str(results) + "/")
    return module.test(args, parser_cls(cfg_path), **kw)


@pytest.fixture(scope="module")
def evaluated(trained_run):
    """``case -> (results_dir_jax, results_dir_port, results_jax,
    results_port)``, each case evaluated once by both CLIs."""
    root, ds, runid = trained_run
    done = {}

    def get(case):
        if case not in done:
            base = root / case
            base.mkdir()
            path = write_cfg(base / "eval.yml", CASES[case](base, ds))
            out = {}
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jbase, "cv2", None)
                for tag, module, parser_cls, kw in (
                    ("jax", eval_flow, JaxParser, {}),
                    ("port", eval_flow_torch, YAMLParser,
                     {"device": "cpu"}),
                ):
                    res_dir = base / f"results_{tag}"
                    out[tag] = (os.path.join(str(res_dir), runid),
                                run_cli(module, parser_cls, path, root,
                                        runid, res_dir, **kw))
            done[case] = (out["jax"][0], out["port"][0], out["jax"][1],
                          out["port"][1])
        return done[case]

    return get


def _metric_files(res_dir):
    return sorted(f for f in os.listdir(res_dir) if f.startswith("metrics_"))


def _tree(res_dir, eval_id=0):
    return os.path.join(res_dir, "results", f"eval_{eval_id}")


@pytest.mark.parametrize("case", list(CASES))
def test_eval_cli_matches_jax(evaluated, case):
    jdir, pdir, jres, pres = evaluated(case)

    # the eval ids and the metric files
    assert _metric_files(pdir) == _metric_files(jdir) == ["metrics_0.yml"]
    assert os.path.isfile(os.path.join(pdir, "eval_0.yml"))
    jm = yaml.safe_load(open(os.path.join(jdir, "metrics_0.yml")))
    pm = yaml.safe_load(open(os.path.join(pdir, "metrics_0.yml")))
    assert pm == {k: dict(v) for k, v in pres.items()}
    assert set(pm) == set(jm)
    counted = 0
    for metric in jm:
        assert set(pm[metric]) == set(jm[metric]), metric
        for seq, v in jm[metric].items():
            got = float(pm[metric][seq])
            assert np.isfinite(got)
            np.testing.assert_allclose(got, float(v), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} {metric} {seq}")
            counted += 1
    assert counted >= 2

    # the image tree: names, timestamps, and pixels within one u16 step
    jtree, ptree = _tree(jdir), _tree(pdir)
    seqs = sorted(os.listdir(jtree))
    assert sorted(os.listdir(ptree)) == seqs and seqs
    n_png = 0
    for seq in seqs:
        jts = open(os.path.join(jtree, seq, "timestamps.txt")).read()
        pts = open(os.path.join(ptree, seq, "timestamps.txt")).read()
        assert pts == jts and jts
        jfb = os.path.join(jtree, seq, "flow_bw")
        pfb = os.path.join(ptree, seq, "flow_bw")
        names = sorted(os.listdir(jfb))
        assert sorted(os.listdir(pfb)) == names
        for name in names:
            a = cv2.imread(os.path.join(jfb, name), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(os.path.join(pfb, name), cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape
            diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
            assert diff.max() <= 1, (case, name, diff.max())
            n_png += 1
    if case == "time_mode":
        assert n_png == 0  # no GT, no AEE, no flow_bw
    else:
        assert n_png >= 2


def test_submission_file_lists_match(evaluated, tmp_path):
    """``prepare_dsec_submission.prepare`` on the port's tree writes the
    file list it writes on the JAX tree."""
    jdir, pdir, _, _ = evaluated("gtflow_store")
    lists = []
    for tag, src in (("jax", jdir), ("port", pdir)):
        root = tmp_path / tag
        dst = root / "run" / "eval_0"
        shutil.copytree(_tree(src), dst)
        n = len(os.listdir(dst / "seq0" / "flow_bw"))
        flags = np.ones(n, np.int64)
        flags[1] = 0
        np.save(root / "seq0_flag.npy", flags)
        with open(root / "seq0.txt", "w") as f:
            f.write("# from_timestamp_us, to_timestamp_us, file_index\n")
            for i in range(n):
                f.write(f"{i * 100000}, {(i + 1) * 100000}, {i + 1:06d}\n")
        prepare_dsec_submission.prepare(argparse.Namespace(
            runid="run", path=str(root) + "/", eval_id=0))
        out = dst / "submission" / "seq0"
        lists.append(sorted(os.listdir(out)))
    assert lists[0] == lists[1] and len(lists[0]) >= 1


def _copy_run(root, runid, dst, artifacts=()):
    """A run of ``dst``'s store with ``runid``'s params (and the named
    ``artifacts/model`` files) from the store at ``root``."""
    run = tracking.TrackingStore(str(dst)).start_run()
    run_dir = os.path.dirname(run.info.artifact_uri)
    for name, val in JaxStore(str(root)).get_run(runid).data.params.items():
        with open(os.path.join(run_dir, "params", name), "w") as f:
            f.write(val)
    model_dir = os.path.join(run.info.artifact_uri, "model")
    os.makedirs(model_dir)
    for name in artifacts:
        shutil.copy(os.path.join(str(root), "mlruns", "0", runid,
                                 "artifacts", "model", name), model_dir)
    return run.info.run_id


def test_eval_reads_a_jax_only_checkpoint(trained_run, evaluated, tmp_path,
                                          capsys):
    """A run that holds only the JAX package's ``checkpoint.msgpack``
    evaluates with its weights: the port's CLI on it matches ``eval_flow.py``
    on the run (the pipeline-parity tolerance), and the port's own results
    from the ``checkpoint.pt`` of the same weights exactly. Before the port
    read the JAX checkpoint, this run raised."""
    root, ds, runid = trained_run
    _, _, jres, pres = evaluated("gtflow_store")
    copy = _copy_run(root, runid, tmp_path, ["checkpoint.msgpack"])
    path = write_cfg(tmp_path / "eval.yml", eval_cfg(ds))
    capsys.readouterr()
    got = run_cli(eval_flow_torch, YAMLParser, path, tmp_path, copy,
                  tmp_path / "results", device="cpu")
    assert f"Model restored from {copy}" in capsys.readouterr().out
    assert got == pres
    for metric, seqs in jres.items():
        for seq, v in seqs.items():
            np.testing.assert_allclose(float(got[metric][seq]), float(v),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{metric} {seq}")


def test_eval_reads_a_jax_transposed_conv_run(trained_run, tmp_path,
                                              capsys):
    """A JAX run of RecEVFlowNet with ``use_upsample_conv: false``, which
    holds only ``checkpoint.msgpack`` (``ConvTranspose_0`` decoders):
    the port's CLI restores it and matches ``eval_flow.py`` on the run
    within the pipeline-parity tolerance."""
    _, ds, _ = trained_run
    cfg = train_cfg(ds)
    cfg["model"]["use_upsample_conv"] = False
    cfg["loader"]["n_epochs"] = 1
    path = write_cfg(tmp_path / "train.yml", cfg)
    runid = train_flow.train(argparse.Namespace(
        config=path, path_mlflow=str(tmp_path), path_cache="",
        prev_runid=""), JaxParser(path))
    model_dir = os.path.join(str(tmp_path), "mlruns", "0", runid,
                             "artifacts", "model")
    assert os.listdir(model_dir) == ["checkpoint.msgpack"]
    path = write_cfg(tmp_path / "eval.yml", eval_cfg(ds, store=False))
    jres = run_cli(eval_flow, JaxParser, path, tmp_path, runid,
                   tmp_path / "results_jax")
    capsys.readouterr()
    got = run_cli(eval_flow_torch, YAMLParser, path, tmp_path, runid,
                  tmp_path / "results_port", device="cpu")
    assert f"Model restored from {runid}" in capsys.readouterr().out
    assert sorted(got) == sorted(jres)
    for metric, seqs in jres.items():
        assert sorted(got[metric]) == sorted(seqs)
        for seq, v in seqs.items():
            np.testing.assert_allclose(float(got[metric][seq]), float(v),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{metric} {seq}")


def test_eval_without_checkpoint_warns(trained_run, tmp_path, capsys):
    """A run with no checkpoint at all evaluates the seeded initial
    weights, with the warning of ``eval_flow.py``."""
    root, ds, runid = trained_run
    copy = _copy_run(root, runid, tmp_path)
    path = write_cfg(tmp_path / "eval.yml", eval_cfg(ds, store=False))
    results = run_cli(eval_flow_torch, YAMLParser, path, tmp_path, copy,
                      tmp_path / "results", device="cpu")
    assert "evaluating random init" in capsys.readouterr().out
    assert results["AEE"]


def test_eval_raises_without_a_card(trained_run, tmp_path, monkeypatch):
    root, ds, runid = trained_run
    path = write_cfg(tmp_path / "eval.yml", eval_cfg(ds))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli(eval_flow_torch, YAMLParser, path, root, runid,
                tmp_path / "results")
    assert not os.path.exists(tmp_path / "results")


def test_storing_without_cv2_raises(trained_run, tmp_path, monkeypatch):
    """A storing protocol on a machine without cv2 raises instead of
    writing an empty submission tree."""
    root, ds, runid = trained_run
    path = write_cfg(tmp_path / "eval.yml", eval_cfg(ds))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        run_cli(eval_flow_torch, YAMLParser, path, root, runid,
                tmp_path / "results", device="cpu")


def test_cli_script_evaluates_on_the_cpu_when_asked(trained_run, tmp_path,
                                                    monkeypatch, capsys):
    """``python eval_flow_torch.py <runid> --config ... --device cpu`` runs
    the CLI end to end (its ``__main__`` block, run in this process)."""
    root, ds, runid = trained_run
    path = write_cfg(tmp_path / "eval.yml", eval_cfg(ds))
    monkeypatch.setattr(sys, "argv", [
        "eval_flow_torch.py", runid, "--config", path, "--path_mlflow",
        str(root), "--path_results", str(tmp_path / "results") + "/",
        "--device", "cpu"])
    runpy.run_path(os.path.join(REPO, "eval_flow_torch.py"),
                   run_name="__main__")
    assert "Model restored from" in capsys.readouterr().out
    res = os.path.join(str(tmp_path), "results", runid)
    assert _metric_files(res) == ["metrics_0.yml"]
    assert os.listdir(os.path.join(_tree(res), "seq0", "flow_bw"))
