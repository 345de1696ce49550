"""Experiment tracking: the port's own copy of
``taming_event_flow_tpu/tracking/store.py``, a file-backed run store with
the MLflow FileStore directory layout
(``mlruns/<exp>/<run_id>/{params,metrics,artifacts,meta.yaml}``).

The layout is the JAX package's byte for byte, so either package reads the
other's runs, and an MLflow UI pointed at the directory browses them.
"""

from __future__ import annotations

import os
import shutil
import time
import uuid
from typing import Any, Dict, Optional


class RunInfo:
    def __init__(self, run_id: str, artifact_uri: str):
        self.run_id = run_id
        self.artifact_uri = artifact_uri


class RunData:
    def __init__(self, params: Dict[str, str]):
        self.params = params


class Run:
    def __init__(self, info: RunInfo, data: RunData):
        self.info = info
        self.data = data

    def to_dictionary(self):
        return {"info": {"run_id": self.info.run_id}}


class TrackingStore:
    """One tracking root (default ``./mlruns``), one experiment id ``0``."""

    def __init__(self, root: str = ""):
        self.set_root(root)
        self.experiment = "0"
        self.experiment_name = "Default"
        self._active: Optional[Run] = None

    def set_root(self, root: str):
        self.root = os.path.join(root or ".", "mlruns")

    def _exp_dir(self) -> str:
        d = os.path.join(self.root, self.experiment)
        os.makedirs(d, exist_ok=True)
        meta = os.path.join(d, "meta.yaml")
        if not os.path.exists(meta):
            with open(meta, "w") as f:
                f.write(
                    f"artifact_location: {d}\nexperiment_id: '{self.experiment}'\n"
                    f"lifecycle_stage: active\nname: {self.experiment_name}\n"
                )
        return d

    def _run_dir(self, run_id: str) -> str:
        return os.path.join(self._exp_dir(), run_id)

    def set_experiment(self, name: str):
        self.experiment_name = name

    def start_run(self, run_id: Optional[str] = None) -> Run:
        if run_id is None:
            run_id = uuid.uuid4().hex
        d = self._run_dir(run_id)
        for sub in ["params", "metrics", "artifacts"]:
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        meta = os.path.join(d, "meta.yaml")
        if not os.path.exists(meta):
            with open(meta, "w") as f:
                f.write(
                    f"artifact_uri: {os.path.abspath(d)}/artifacts\n"
                    f"experiment_id: '{self.experiment}'\n"
                    f"run_id: {run_id}\nrun_uuid: {run_id}\n"
                    f"run_name: {self.experiment_name}\n"
                    f"lifecycle_stage: active\nstatus: 1\n"
                    f"start_time: {int(time.time() * 1000)}\n"
                )
        self._active = self.get_run(run_id)
        return self._active

    def active_run(self) -> Optional[Run]:
        return self._active

    def end_run(self):
        self._active = None

    def get_run(self, run_id: str) -> Run:
        d = self._run_dir(run_id)
        if not os.path.isdir(d):
            raise KeyError(f"Run {run_id!r} not found under {self.root}")
        params: Dict[str, str] = {}
        pdir = os.path.join(d, "params")
        if os.path.isdir(pdir):
            for name in os.listdir(pdir):
                with open(os.path.join(pdir, name)) as f:
                    params[name] = f.read()
        return Run(
            RunInfo(run_id, os.path.abspath(os.path.join(d, "artifacts"))),
            RunData(params),
        )

    def log_param(self, key: str, value: Any):
        d = self._run_dir(self._require_active().info.run_id)
        with open(os.path.join(d, "params", key), "w") as f:
            f.write(str(value))

    def log_params(self, params: Dict[str, Any]):
        for k, v in params.items():
            self.log_param(k, v)

    def log_metric(self, key: str, value: float, step: int = 0,
                   run_id: Optional[str] = None):
        rid = run_id or self._require_active().info.run_id
        d = self._run_dir(rid)
        os.makedirs(os.path.join(d, "metrics"), exist_ok=True)
        with open(os.path.join(d, "metrics", key), "a") as f:
            f.write(f"{int(time.time() * 1000)} {value} {step}\n")

    def read_metric(self, run_id: str, key: str):
        """[(timestamp_ms, value, step)] history (MLflow metric-file format)."""
        path = os.path.join(self._run_dir(run_id), "metrics", key)
        if not os.path.isfile(path):
            return []
        rows = []
        with open(path) as f:
            for line in f:
                t, v, s = line.split()
                rows.append((int(t), float(v), int(s)))
        return rows

    def log_artifact(self, path: str, run_id: Optional[str] = None):
        rid = run_id or self._require_active().info.run_id
        dst = os.path.join(self._run_dir(rid), "artifacts")
        os.makedirs(dst, exist_ok=True)
        shutil.copy(path, dst)

    def artifact_dir(self, run_id: str, *sub: str) -> str:
        d = os.path.join(self._run_dir(run_id), "artifacts", *sub)
        os.makedirs(d, exist_ok=True)
        return d

    def _require_active(self) -> Run:
        if self._active is None:
            raise RuntimeError("no active run; call start_run() first")
        return self._active


# module-level default store (mirrors mlflow's module API)
_STORE = TrackingStore()


def set_tracking_uri(path: str):
    _STORE.set_root(path)


def set_experiment(name: str):
    _STORE.set_experiment(name)


def start_run(run_id: Optional[str] = None) -> Run:
    return _STORE.start_run(run_id)


def active_run() -> Optional[Run]:
    return _STORE.active_run()


def end_run():
    _STORE.end_run()


def log_params(params: Dict[str, Any]):
    _STORE.log_params(params)


def log_metric(key: str, value: float, step: int = 0, run_id=None):
    _STORE.log_metric(key, value, step, run_id=run_id)


def log_artifact(path: str, run_id=None):
    _STORE.log_artifact(path, run_id=run_id)


def get_run(run_id: str) -> Run:
    return _STORE.get_run(run_id)


def default_store() -> TrackingStore:
    return _STORE
