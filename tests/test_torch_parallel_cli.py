"""Both CLIs of the port over 2 gloo ranks on the CPU against their one-rank
runs, at ``tests/test_e2e.py``'s tiny config (32x32) over two synthetic
sequences: ranks in children started with ``spawn``
(``tests/torch_parallel_ranks.py``), the one-rank runs in this process.

- ``train_flow_torch.train`` with ``parallel: {event: 2}`` (the three
  flips on: both ranks stream the same lanes) and ``parallel: {data: 2}``
  (B = 2: each rank streams one lane from its shard of the two files, no
  augmentation, whose draws are seeded per shard): the epoch losses within
  1e-5 relative of the one-rank run's; rank 0 alone writes the run and its
  ``checkpoint.pt``.
- ``eval_flow_torch.test`` of a one-rank run over 2 ranks (the slot state
  sharded; no loader seed, so the ranks must share rank 0's): the metrics
  within the pipeline-parity tolerance (rtol 2e-3, atol 2e-4) of the
  one-rank evaluation, equal ``flow_bw`` file lists and
  ``timestamps.txt``; rank 0 alone writes the results.
"""

import argparse
import os

import numpy as np
import pytest
import yaml

import eval_flow_torch
import train_flow_torch
from taming_event_flow_tpu_torch import tracking
from taming_event_flow_tpu_torch.configs import YAMLParser
from taming_event_flow_tpu_torch.data import write_synthetic_h5
from taming_event_flow_tpu_torch.parallel.spawn import run_ranks

from . import torch_parallel_ranks as ranks
from .torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RES = (32, 32)
TIMEOUT = 300.0
LOSS_RTOL = 1e-5
PIPE_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_pipeline_parity.py:196
FLIPS = ["Horizontal", "Vertical", "Polarity"]


def write_cfg(path, d):
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return str(path)


def train_cfg(ds, parallel=None, batch=1, augment=()):
    """``tests/test_e2e.py``'s tiny training config for one epoch, with the
    static event bucket and seed a world of several ranks requires."""
    cfg = {
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
        "loader": {"n_epochs": 1, "batch_size": batch,
                   "resolution": list(RES), "augment": list(augment),
                   "augment_prob": [0.5] * len(augment),
                   "max_num_grad_events": None, "seed": 11,
                   "n_events_pad": 1024},
        "vis": {"verbose": False, "enabled": False, "store": False},
    }
    if parallel:
        cfg["parallel"] = parallel
    return cfg


def eval_cfg(ds):
    """``tests/test_e2e.py``'s ``make_eval_cfg``, storing ``flow_bw``, with
    no loader seed, as ``configs/eval_*.yml`` (the ranks then share one
    drawn on rank 0)."""
    return {
        "data": {"path": ds, "mode": "gtflow", "window": 1,
                 "passes_loss": 2, "cache": False},
        "loader": {"resolution": list(RES), "augment": [],
                   "max_num_grad_events": None, "seed": None},
        "metrics": {"warping": "Iterative",
                    "name": ["FWL", "RSAT", "AEE"]},
        "vis": {"enabled": False, "store": True, "bars": False,
                "mask_output": False, "dynamic": False,
                "show": ["flow_bw"]},
    }


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_cli")
    ds = root / "data"
    write_synthetic_h5(str(ds / "seq0.h5"), n_events=3000, res=RES,
                       n_flow_frames=8, seed=1)
    write_synthetic_h5(str(ds / "seq1.h5"), n_events=2700, res=RES,
                       n_flow_frames=8, seed=2)
    return root, str(ds)


def spawn(tmp_path_factory, fn, *args):
    url = "file://" + str(tmp_path_factory.mktemp("rdv") / "store")
    return run_ranks(fn, 2, (url,) + args, timeout=TIMEOUT)


def train_one_rank(cfg_path, root):
    args = argparse.Namespace(config=cfg_path, path_mlflow=str(root),
                              path_cache="", prev_runid="")
    return train_flow_torch.train(args, YAMLParser(cfg_path), device="cpu")


def losses(root, runid):
    store = tracking.TrackingStore(str(root))
    return [v for _, v, _ in store.read_metric(runid, "loss")]


def runs_in(root):
    exp = os.path.join(str(root), "mlruns", "0")
    return sorted(d for d in os.listdir(exp)
                  if os.path.isdir(os.path.join(exp, d)))


@pytest.mark.parametrize("parallel,batch,augment", [
    ({"event": 2}, 1, FLIPS),
    ({"data": 2}, 2, ()),
], ids=["event", "data"])
def test_train_cli_two_ranks_match_one(workspace, tmp_path_factory,
                                       parallel, batch, augment):
    root, ds = workspace
    work = tmp_path_factory.mktemp("train")
    one = write_cfg(work / "one.yml", train_cfg(ds, None, batch, augment))
    two = write_cfg(work / "two.yml", train_cfg(ds, parallel, batch,
                                                augment))
    one_root, two_root = work / "one", work / "two"
    runid = train_one_rank(one, one_root)
    out = spawn(tmp_path_factory, ranks.train_cli, two, str(two_root))
    assert out[1] == "rank1"
    # rank 0 alone wrote a run, with its checkpoint
    assert runs_in(two_root) == [out[0]]
    assert os.path.isfile(os.path.join(
        str(two_root), "mlruns", "0", out[0], "artifacts", "model",
        "checkpoint.pt"))
    ref, got = losses(one_root, runid), losses(two_root, out[0])
    assert len(ref) == len(got) == 1 and np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)


def _flow_bw_tree(results, runid):
    tree = os.path.join(results, runid, "results", "eval_0")
    out = {}
    for seq in sorted(os.listdir(tree)):
        files = sorted(os.listdir(os.path.join(tree, seq, "flow_bw")))
        with open(os.path.join(tree, seq, "timestamps.txt")) as f:
            out[seq] = (files, f.read())
    return out


def test_eval_cli_two_ranks_match_one(workspace, tmp_path_factory):
    root, ds = workspace
    work = tmp_path_factory.mktemp("eval")
    runid = train_one_rank(write_cfg(work / "train.yml", train_cfg(ds)),
                           work)
    cfg_path = write_cfg(work / "eval.yml", eval_cfg(ds))
    one_res, two_res = str(work / "res_one"), str(work / "res_two")
    args = argparse.Namespace(runid=runid, config=cfg_path,
                              path_mlflow=str(work), path_results=one_res)
    ref = eval_flow_torch.test(args, YAMLParser(cfg_path), device="cpu")
    out = spawn(tmp_path_factory, ranks.eval_cli, runid, cfg_path,
                str(work), two_res)
    assert out[1] is None
    got = out[0]
    assert set(got) == set(ref) == {"FWL", "RSAT", "AEE"}
    for metric in ref:
        assert set(got[metric]) == set(ref[metric]) and ref[metric]
        for seq in ref[metric]:
            np.testing.assert_allclose(float(got[metric][seq]),
                                       float(ref[metric][seq]),
                                       err_msg=f"{metric} {seq}", **PIPE_TOL)
    # rank 0 alone wrote the results: one eval id
    files = sorted(f for f in os.listdir(os.path.join(two_res, runid))
                   if f.endswith(".yml"))
    assert files == ["eval_0.yml", "metrics_0.yml"]
    tree = _flow_bw_tree(two_res, runid)
    assert tree == _flow_bw_tree(one_res, runid)
    assert all(files for files, _ in tree.values())
