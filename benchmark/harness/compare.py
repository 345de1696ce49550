"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each number held to its limit
(``benchmark/limits/<cell>.json``).

Training (three steps from the seed): the widest gap of the model's flows
in step 1; the relative gap of the first step's loss; of the parameter change after the three steps, for the median
leaf, the gap between the norms of the program's and the reference's and
the norm of their difference, each against the reference leaf's norm or
the median leaf's, whichever is larger. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out, by that rule.

Eval (every GT window due in the window, against the reference's replay of
its position in the sequence): the worst window's relative gaps of FWL,
RSAT and AEE, and of ``flow_bw`` the worst window's mean gap in u16
lattice steps (a reordered bfloat16 forward moves single pixels by
hundreds of steps, PERF.md section 2).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np


def _norms(tensors: Dict) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep):
    """Each kept leaf's gap of norms, against the reference leaf's norm or
    the median leaf's, whichever is larger; sorted."""
    med = float(np.median([ref[k] for k in keep]))
    return sorted(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                  for k in keep)


def train_numbers(prog_losses: List[float], prog_flows, prog_change: Dict,
                  ref_losses: List[float], ref_flows, ref_change: Dict,
                  ref_grad: Dict) -> Dict[str, float]:
    """``flow1_gap``: the widest gap of the model's flows in step 1, against
    the reference's largest. ``loss1_gap``: the first step's loss,
    relative. Over the kept leaves (:func:`kept_leaves`), each against the
    reference leaf's change norm or the median leaf's, whichever is larger,
    the median leaf's ``change_median_gap`` (the gap between the two norms
    of its change) and ``change_dir_median`` (the norm of the two changes'
    difference, which an update of the right size in another direction
    moves)."""
    p0, r0 = prog_losses[0], ref_losses[0]
    loss1 = (abs(p0 - r0) / max(abs(r0), 1e-30) if math.isfinite(p0)
             else math.inf)
    flow1 = float((prog_flows.double() - ref_flows.double()).abs().max()
                  / max(float(ref_flows.abs().max()), 1e-30))
    keep = kept_leaves(ref_grad)
    rc, pc = _norms(ref_change), _norms(prog_change)
    med = float(np.median([rc[k] for k in keep]))
    diff = _norms({k: prog_change[k] - ref_change[k] for k in keep})
    return {"flow1_gap": flow1 if math.isfinite(flow1) else math.inf,
            "loss1_gap": loss1,
            "change_median_gap": float(np.median(_leaf_gaps(pc, rc, keep))),
            "change_dir_median": float(np.median(
                [diff[k] / max(rc[k], med, 1e-30) for k in keep]))}


def kept_leaves(ref_grad: Dict) -> List[str]:
    """The leaves compared: those whose reference first gradient is at
    least a thousandth of the median leaf's (the others move by round-off
    alone)."""
    rg = _norms(ref_grad)
    med = float(np.median(list(rg.values())))
    return [k for k in rg if rg[k] >= 1e-3 * med]


def eval_numbers(prog: List[Optional[Dict]], ref: List[Dict]
                 ) -> Dict[str, float]:
    """``prog[j]`` the j-th GT window's host outputs (``None`` if it never
    came), ``ref`` the reference's windows of one pass of the sequence."""
    out = {"missing": 0.0, "fwl_gap": 0.0, "rsat_gap": 0.0, "aee_gap": 0.0}
    if ref and ref[0].get("flow_bw") is not None:
        out["flow_bw_mean_steps"] = 0.0

    def rel(a, b):
        a, b = float(a), float(b)
        if not math.isfinite(a):
            return math.inf
        return abs(a - b) / max(abs(b), 1e-12)

    for j, p in enumerate(prog):
        if p is None:
            out["missing"] += 1
            continue
        r = ref[j % len(ref)]
        out["fwl_gap"] = max(out["fwl_gap"], rel(p["fwl"], r["fwl"]))
        out["rsat_gap"] = max(out["rsat_gap"], rel(p["rsat"], r["rsat"]))
        out["aee_gap"] = max(out["aee_gap"], rel(p["aee"], r["aee"]))
        if "flow_bw_mean_steps" in out:
            d = np.abs(p["flow_bw"].astype(np.int64)
                       - r["flow_bw"].astype(np.int64)).mean()
            out["flow_bw_mean_steps"] = max(out["flow_bw_mean_steps"],
                                            float(d))
    return out


def check(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every number with its limit, in the order of
    the limits; a number without a limit fails, as does one over it."""
    checks, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name, math.inf)
        checks[name] = {"value": v, "limit": lim}
        ok = ok and v <= lim
    return ok, checks
