"""BENCHMARK.json against the contract's shape, and every name resolving
to its files: a cell, configuration, mix and metric added as files alone
are picked up."""

import json
import os
import re

import pytest
import torch

from harness.runner import run_cell
from harness.spec import Spec

import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_resolves_by_name():
    spec = Spec(tiny.ROOT, tiny.BENCH_DIR)
    for w in spec.data["workloads"]:
        cfg = spec.config(w["config"])
        mix = spec.traffic(w["traffic"])
        assert hasattr(spec.driver(mix["kind"]), "run")
        assert spec.limits(w["name"])
        assert cfg["name"] == w["config"]
        e2e = [m["name"] for m in spec.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        readers = spec.per_layer(w["name"])
        assert readers
        for m in readers:
            assert hasattr(spec.reader(m["name"]), "read")


def test_a_cell_added_as_files_alone_runs(tiny_root):
    """A new configuration (a config file), a new mix (data only), a new
    per-layer metric (a reader file) and a new cell (BENCHMARK.json
    entries and a limits file): picked up with no edit to any file that
    was there."""
    bench = os.path.join(tiny_root, "benchmark")
    with open(os.path.join(bench, "configs",
                           "recevflownet_iterative.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "recevflownet_shallow"
    cfg["model"]["num_residual_blocks"] = 1
    with open(os.path.join(bench, "configs", "recevflownet_shallow.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "mvsec.json")) as f:
        mix = json.load(f)
    mix["events_per_pass"] = [50, 80]
    with open(os.path.join(bench, "traffic", "mvsec_sparse.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "layer_metrics", "windows.eval.py"),
              "w") as f:
        f.write("def read(ctx):\n    return float(ctx.get('windows'))\n")
    with open(os.path.join(bench, "limits", "iter_mvsec_sparse.json"),
              "w") as f:
        with open(os.path.join(bench, "limits",
                               "iter_mvsec_eval.json")) as g:
            f.write(g.read())
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append({"name": "recevflownet_shallow",
                         "source": "https://arxiv.org/abs/2303.13019",
                         "file": "benchmark/configs/recevflownet_shallow.json",
                         "reduced": ["num_residual_blocks"],
                         "why": "one residual block"})
    b["workloads"].append({"name": "iter_mvsec_sparse",
                           "config": "recevflownet_shallow",
                           "traffic": "mvsec_sparse", "chips": 1,
                           "why": "sparse MVSEC"})
    for m in b["end_to_end"]:
        if "workloads" in m and "iter_mvsec_eval" in m["workloads"]:
            m["workloads"].append("iter_mvsec_sparse")
    b["per_layer"].append({"name": "windows.eval", "unit": "windows",
                           "better": "higher", "source": "host_clock",
                           "layer": "pipeline/eval.py EvalPipeline",
                           "moves": "eval_ms_per_pass",
                           "workloads": ["iter_mvsec_sparse"]})
    with open(path, "w") as f:
        json.dump(b, f)
    spec = Spec(tiny_root, bench)
    cpu = torch.device("cpu")
    r0 = run_cell(spec, "iter_mvsec_sparse", 7, 0.2, False, cpu, 0.0)
    assert r0["correct"]
    assert set(r0["metrics"]) == {"setup_s", "eval_ms_per_pass"}
    r1 = run_cell(spec, "iter_mvsec_sparse", 7, 0.2, True, cpu, 0.0)
    assert r1["metrics"]["windows.eval"]["value"] >= 1


TOY = '''
FIXED = {"act": "relu"}
NUMBERS = ("width",)


def weight_shapes(cfg):
    return {"conv.weight": (cfg["width"], 2, 3, 3),
            "conv.bias": (cfg["width"],)}


def init_bounds(name, shape, cfg):
    return None if name.endswith(".bias") else (0.5, 0.0)


def conv_layers(cfg, h, w):
    return [(2, cfg["width"], 3, h, w, True)]
'''


def test_a_model_added_as_a_file_alone_is_found(tmp_path, monkeypatch):
    """A model family is ``reference/models/<name>.py``: the weights and
    the operation count find a new one by the configuration's name."""
    from harness import work
    from harness.weights import make_weights
    from reference import models

    (tmp_path / "toynet.py").write_text(TOY)
    monkeypatch.setattr(models, "__path__",
                        [str(tmp_path)] + list(models.__path__))
    cfg = {"name": "ToyNet", "width": 4, "act": "relu"}
    w = make_weights(cfg, 3, "cpu")
    assert w["conv.weight"].shape == (4, 2, 3, 3)
    assert float(w["conv.weight"].abs().max()) <= 0.5
    assert not w["conv.bias"].any()
    assert work.pass_flops(cfg, 8, 8, 1, train=False) == 2 * 4 * 2 * 9 * 64


@pytest.mark.parametrize("change", [
    {"use_upsample_conv": False}, {"norm": "IN"}, {"skip_type": "concat"},
    {"final_activation": None}, {"num_groups": 2}, {"name": "EVFlowNet"}])
def test_a_model_option_the_reference_lacks_is_refused(tiny_root, change):
    """A configuration that states a model option the reference does not
    implement (or a model it has no file for) is refused at set-up, before
    anything runs."""
    from harness.weights import make_weights

    cfg = tiny.model_cfg(**change)
    with pytest.raises(NotImplementedError):
        make_weights(cfg, 1, "cpu")
    path = os.path.join(tiny_root, "benchmark", "configs",
                        "recevflownet_iterative.json")
    with open(path) as f:
        data = json.load(f)
    data["model"].update(change)
    with open(path, "w") as f:
        json.dump(data, f)
    spec = Spec(tiny_root, os.path.join(tiny_root, "benchmark"))
    with pytest.raises(NotImplementedError):
        run_cell(spec, "iter_mvsec_eval", 1, 0.2, False,
                 torch.device("cpu"), 0.0)


def test_a_loss_option_the_reference_lacks_is_refused():
    from reference.losses import loss_for

    with pytest.raises(NotImplementedError):
        loss_for({"warping": "Linear", "round_ts": True})
    with pytest.raises(NotImplementedError):
        loss_for({"warping": "Multi"})
