"""Result and config logging of the eval CLI: the port's own copy of
``taming_event_flow_tpu/tracking/loggers.py`` (reference
``utils/mlflow.py:8-41``, ``utils/utils.py:52-58,125-134``).

Per-eval-id YAML files in the results tree (``eval_<id>.yml``,
``metrics_<id>.yml``), each also attached to the tracked run's artifacts
in the layout the JAX package's store reads. PyYAML is imported only
where a file is written.
"""

from __future__ import annotations

import os
from typing import Dict

from .store import default_store


def create_model_dir(path_results: str, runid: str) -> str:
    d = os.path.join(path_results, runid)
    os.makedirs(d, exist_ok=True)
    print(f"Results stored at {d}\n")
    return d


def next_eval_id(path_results: str) -> int:
    """One more than the largest ``<name>_<id>.yml`` id in the directory."""
    eval_id = 0
    for f in os.listdir(path_results):
        if f.endswith(".yml"):
            try:
                tmp = int(f.split(".")[0].split("_")[-1])
            except ValueError:
                continue
            eval_id = max(eval_id, tmp + 1)
    return eval_id


def _dump_and_attach(path: str, content: Dict, runid: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(content, f, default_flow_style=False)
    try:
        default_store().log_artifact(path, run_id=runid)
    except KeyError:  # no such run in the store: the file alone
        pass


def log_config(path_results: str, runid: str, config: Dict) -> int:
    """Write ``eval_<id>.yml`` and attach it to the run; returns the id."""
    eval_id = next_eval_id(path_results)
    _dump_and_attach(os.path.join(path_results, f"eval_{eval_id}.yml"),
                     config, runid)
    return eval_id


def log_results(runid: str, results: Dict, path_results: str, eval_id: int):
    """Write ``metrics_<id>.yml`` and attach it to the run."""
    _dump_and_attach(os.path.join(path_results, f"metrics_{eval_id}.yml"),
                     results, runid)


def initialize_quant_results(results: Dict, filename: str, metrics) -> Dict:
    """Zeroed ``{"metric", "it"}`` accumulators of ``metrics`` for one
    sequence, leaving existing ones as they are."""
    if filename not in results:
        results[filename] = {}
    for metric in metrics:
        results[filename].setdefault(metric, {"metric": 0.0, "it": 0})
    return results
