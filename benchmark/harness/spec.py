"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``benchmark/configs/<file>``, from the
configuration's ``file``) and a traffic mix (``benchmark/traffic/<mix>.
json``); the mix's ``kind`` names its driver (``benchmark/drivers/
<kind>.py``); each per-layer metric is read by ``benchmark/layer_metrics/
<metric>.py``; a cell's correctness limits are ``benchmark/limits/<cell>.
json``. Adding a cell, a configuration, a mix or a metric is adding files
and entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """The benchmark as ``BENCHMARK.json`` declares it, rooted at ``root``
    (the checkout) with its files under ``bench_dir``."""

    def __init__(self, root: str = ROOT, bench_dir: str = BENCH_DIR,
                 data: Optional[Dict] = None):
        self.root = root
        self.bench_dir = bench_dir
        if data is None:
            with open(os.path.join(root, "BENCHMARK.json")) as f:
                data = json.load(f)
        self.data = data

    def _json(self, *parts) -> Dict:
        with open(os.path.join(self.bench_dir, *parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name + ".json")

    def limits(self, workload: str) -> Dict[str, float]:
        return self._json("limits", workload + ".json")["limits"]

    def driver(self, kind: str):
        return _load_module(os.path.join(self.bench_dir, "drivers",
                                         kind + ".py"), "bench_driver_" + kind)

    def reader(self, metric: str):
        """The per-layer metric's reader: a module with ``read(ctx)``."""
        return _load_module(os.path.join(self.bench_dir, "layer_metrics",
                                         metric + ".py"),
                            "bench_metric_" + metric.replace(".", "_"))

    def _listed(self, metric: Dict, workload: str) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    def end_to_end(self, workload: str):
        return [m for m in self.data["end_to_end"]
                if self._listed(m, workload)]

    def per_layer(self, workload: str):
        return [m for m in self.data["per_layer"]
                if self._listed(m, workload)]
