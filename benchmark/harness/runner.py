"""One run of one cell: the driver, the comparison, the readers and the
result line."""

from __future__ import annotations

import math
from typing import Dict

import torch

from harness import compare
from harness.spec import Spec
from harness.work import card_peaks


def _finite(x):
    """A number JSON can carry (an infinite gap prints as 1e300)."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300
    return x


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> Dict:
    """Run ``workload`` once and return the result line's object."""
    cell = spec.workload(workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    driver = spec.driver(mix["kind"])
    out = driver.run(cfg, mix, seed, seconds, trace, device, t_start)

    if mix["kind"] == "train":
        numbers = compare.train_numbers(*out["program"], *out["reference"])
    else:
        numbers = compare.eval_numbers(out["program"], out["reference"])
    ok, checks = compare.check(numbers, limits)
    correct = ok and out["failed"] == 0

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    ctx = out["ctx"]
    # a share of the card's peak exists only on the card
    ctx["peaks"] = card_peaks(name) if device.type == "cuda" else None
    metrics = {}
    if not trace:
        for m in spec.end_to_end(workload):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in spec.per_layer(workload):
            value = spec.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": name, "count": 1,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    tr = ctx.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": _finite(v["value"]), "limit":
                            v["limit"]} for k, v in checks.items()}
    # seconds from the process start at which each part of set-up ended
    result["setup_parts"] = out["setup_parts"]
    return result
