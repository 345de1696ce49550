"""YAML config system: the port's own copy of
``taming_event_flow_tpu/configs/parser.py``.

The same defaults, merge precedence, seeding and eval-time reconstruction
of a train config from tracked run params (``ast.literal_eval``, never
``eval``). Two differences:

  * configs are copied with ``copy.deepcopy``, so only :meth:`YAMLParser.
    parse_config` needs PyYAML (imported there);
  * :meth:`YAMLParser.apply_runtime` has no compilation cache to set and
    does nothing. Of the JAX package's performance keys, the port's
    pipelines read ``runtime.packed_wire``, ``runtime.u32_wire`` and
    ``runtime.probe_wire``; ``loss.matmul_precision``,
    ``loss.warp_backend``, ``loss.scan_unroll``,
    ``loss.triangular_warp``, ``loss.warp_remat`` and the other
    ``runtime`` keys parse and change nothing here.
"""

from __future__ import annotations

import ast
import copy
import random
from typing import Any, Dict, Optional

import numpy as np

DEFAULTS: Dict[str, Any] = {
    "experiment": "Default",
    "data": {
        "mode": "events",
        "window": 5000,
        "voxel": None,
        "cache": False,
        "passes_loss": 1,
        "scales_loss": 1,
    },
    "loader": {
        "resolution": [180, 240],
        "batch_size": 1,
        "n_epochs": 500,
        "augment": [],
        "augment_prob": [],
        "max_num_grad_events": None,
        "n_events_pad": None,
        "gpu": 0,
        "seed": 42,
    },
    "model": {},
    "parallel": {
        # device-mesh shape for training (data-parallel lanes x event-axis
        # shards); the port trains on one device and refuses more
        "data": None,
        "event": 1,
    },
    "loss": {
        "flow_scaling": 32,
        "round_ts": False,
        "iterative_mode": "two",
        "flow_spat_smooth_weight": None,
        "flow_temp_smooth_weight": None,
        "clip_grad": None,
        # the JAX package's performance knobs; the port runs the defaults
        "matmul_precision": "default",
        "warp_remat": False,
        "scan_unroll": 1,
        "warp_backend": "auto",
        "batched_sweep": False,
        "triangular_warp": True,
    },
    "metrics": {},
    "optimizer": {"name": "Adam", "lr": 1e-5},
    "runtime": {
        "compilation_cache": None,
    },
    "vis": {
        "enabled": False,
        "bars": False,
        "store": False,
        "verbose": False,
        "px": 400,
        "mask_output": False,
        "dynamic": False,
        "show": None,
    },
}


def deep_merge(dst: Dict, src: Dict) -> Dict:
    """Recursively merge ``src`` into ``dst`` (reference ``parser.py:73-87``)."""
    for key, val in src.items():
        if isinstance(val, dict):
            node = dst.setdefault(key, {})
            if isinstance(node, dict):
                deep_merge(node, val)
            else:
                dst[key] = val
        else:
            dst[key] = val
    return dst


class YAMLParser:
    def __init__(self, config_path: Optional[str] = None):
        self._config = copy.deepcopy(DEFAULTS)
        self._explicit: Dict[str, Any] = {}
        if config_path is not None:
            self.parse_config(config_path)
        if self._config["loader"].get("seed") is not None:
            self.init_seeds()

    def parse_config(self, path: str):
        import yaml

        with open(path) as f:
            self.merge(yaml.safe_load(f) or {})

    def merge(self, values: Dict):
        """Merge ``values`` as if a config file held them: over the
        defaults, and over a tracked run's params in
        :meth:`merge_configs`."""
        deep_merge(self._explicit, copy.deepcopy(values))
        deep_merge(self._config, copy.deepcopy(values))

    @property
    def config(self) -> Dict:
        return self._config

    def update(self, config_path: str):
        self._config = copy.deepcopy(DEFAULTS)
        self.parse_config(config_path)

    def init_seeds(self):
        seed = self._config["loader"]["seed"]
        np.random.seed(seed)
        random.seed(seed)

    def merge_configs(self, run_params: Dict[str, str]) -> Dict:
        """Rebuild a train-time config from tracked (stringified) params,
        then overwrite with this parser's *explicit* eval-file settings
        (precedence: defaults < train params < eval yaml; reference
        ``parser.py:113-129``)."""
        parsed: Dict[str, Any] = {}
        for key, val in run_params.items():
            if isinstance(val, str) and len(val) > 0 and val[0] == "{":
                parsed[key] = ast.literal_eval(val)
            else:
                parsed[key] = val
        config = copy.deepcopy(DEFAULTS)
        deep_merge(config, parsed)
        deep_merge(config, copy.deepcopy(self._explicit))
        return config

    @staticmethod
    def apply_runtime(config: Dict) -> None:
        """The JAX package sets its compilation cache here; the port has
        none to set."""

    @staticmethod
    def combine_entries(config: Dict) -> Dict:
        """Kept for CLI-contract compatibility (reference ``parser.py:131-137``
        is a no-op placeholder for tracking-backend param-length limits)."""
        return config
