"""The port's config parser against the JAX package's: the cases of
``tests/test_configs.py`` through both parsers, and every config the repo
ships parsed by both to equal dicts. Exact: parsing is no arithmetic."""

import os
import random

import numpy as np
import pytest

from taming_event_flow_tpu.configs import YAMLParser as JaxParser
from taming_event_flow_tpu.configs.parser import DEFAULTS as JAX_DEFAULTS
from taming_event_flow_tpu.configs.parser import deep_merge as jax_deep_merge
from taming_event_flow_tpu_torch.configs import DEFAULTS, YAMLParser, deep_merge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                      if f.endswith(".yml"))


def test_defaults_equal_jax():
    assert DEFAULTS == JAX_DEFAULTS


@pytest.mark.parametrize("name", REPO_CONFIGS)
def test_repo_configs_parse_as_jax(name):
    path = os.path.join(REPO, "configs", name)
    assert YAMLParser(path).config == JaxParser(path).config


def test_defaults_and_file_merge(tmp_path):
    p = tmp_path / "cfg.yml"
    p.write_text("data:\n  mode: time\n  window: 0.01\n")
    cfg = YAMLParser(str(p)).config
    assert cfg == JaxParser(str(p)).config
    assert cfg["data"]["mode"] == "time"
    assert cfg["data"]["window"] == 0.01
    # untouched defaults survive
    assert cfg["loader"]["batch_size"] == 1
    assert cfg["optimizer"]["name"] == "Adam"


def test_deep_merge_nested():
    for merge in (deep_merge, jax_deep_merge):
        dst = {"a": {"b": 1, "c": 2}, "d": 3, "f": 5}
        merge(dst, {"a": {"c": 9}, "e": 4, "f": {"g": 1}})
        assert dst == {"a": {"b": 1, "c": 9}, "d": 3, "e": 4, "f": {"g": 1}}


def test_merge_configs_precedence(tmp_path):
    """defaults < tracked train params < eval yaml (reference parser.py:113-129)."""
    eval_yml = tmp_path / "eval.yml"
    eval_yml.write_text(
        "data:\n  mode: gtflow\n  window: 1\nloader:\n  resolution: [260, 346]\n"
    )
    run_params = {
        "data": str({"mode": "time", "window": 0.01, "passes_loss": 10,
                     "scales_loss": 1, "voxel": None, "cache": False}),
        "loss": str({"warping": "Iterative", "flow_scaling": 32,
                     "iterative_mode": "two", "round_ts": False}),
        "model": str({"name": "RecEVFlowNet", "final_w_scale": 0.01}),
        "prev_runid": "",
    }
    cfg = YAMLParser(str(eval_yml)).merge_configs(run_params)
    assert cfg == JaxParser(str(eval_yml)).merge_configs(run_params)
    # eval yaml wins
    assert cfg["data"]["mode"] == "gtflow"
    assert cfg["loader"]["resolution"] == [260, 346]
    # train params survive where eval is silent
    assert cfg["data"]["passes_loss"] == 10
    assert cfg["loss"]["flow_scaling"] == 32
    assert cfg["model"]["final_w_scale"] == 0.01

    # values merged from a dict act as the same file's
    parser = YAMLParser()
    values = {"data": {"mode": "gtflow", "window": 1},
              "loader": {"resolution": [260, 346]}}
    parser.merge(values)
    assert parser.config == YAMLParser(str(eval_yml)).config
    assert parser.merge_configs(run_params) == cfg
    values["data"]["mode"] = "events"  # merged as a copy
    assert parser.config["data"]["mode"] == "gtflow"


def test_merge_configs_rejects_code_injection():
    with pytest.raises((ValueError, SyntaxError)):
        YAMLParser().merge_configs({"data": "{__import__('os').system('true')}"})


def test_seeding(tmp_path):
    p = tmp_path / "cfg.yml"
    p.write_text("loader:\n  seed: 123\n")
    YAMLParser(str(p))
    a = np.random.rand(), random.random()
    YAMLParser(str(p))
    b = np.random.rand(), random.random()
    JaxParser(str(p))
    c = np.random.rand(), random.random()
    assert a == b == c


def test_update_restarts_from_defaults(tmp_path):
    p1, p2 = tmp_path / "a.yml", tmp_path / "b.yml"
    p1.write_text("data:\n  mode: time\n")
    p2.write_text("loader:\n  batch_size: 4\n")
    ours, ref = YAMLParser(str(p1)), JaxParser(str(p1))
    ours.update(str(p2))
    ref.update(str(p2))
    assert ours.config == ref.config
    assert ours.config["data"]["mode"] == "events"


def test_jax_only_keys_parse_and_runtime_does_nothing(tmp_path):
    """The JAX package's performance keys parse; ``apply_runtime`` has no
    compilation cache to set and changes nothing; ``combine_entries``
    passes the config through."""
    p = tmp_path / "cfg.yml"
    p.write_text("loss:\n  matmul_precision: highest\n  warp_backend: xla\n"
                 "  scan_unroll: 4\nruntime:\n  compilation_cache: /x\n"
                 "  packed_wire: false\n")
    parser = YAMLParser(str(p))
    cfg = parser.config
    assert cfg == JaxParser(str(p)).config
    snapshot = repr(cfg)
    assert YAMLParser.apply_runtime(cfg) is None
    assert parser.combine_entries(cfg) is cfg
    assert repr(cfg) == snapshot
