"""Read a cell's control and faults: the plain reference put in the
program's place, computed one precision below the configuration's (or with
a fault planted), held to the reference by the same numbers the benchmark
compares. The benchmark's own runs never run this.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]
                                 [--variant <name>]

Variants: ``control`` (the default: TF32 for a float32 configuration, fp8
for a bfloat16 forward, :mod:`reference.precision`); ``reorder`` (a
witness of a sound change, not a control: the reference in the cell's own
precision with every convolution's operands laid out channels-last, cuDNN
free to pick its fastest and non-deterministic algorithms, so float sums
run in another order); for a training cell ``half_batch`` (a fault: the
loss over the first half of the lanes, scaled by two), ``signflip`` (a
fault: Adam steps up the gradient, an update of the right size in the
wrong direction) and ``jitter`` (a witness: the weights times 1 + 1e-6 of
a seeded normal, which shows how far the numbers move on rounding-sized
changes). Prints one JSON line a seed with the numbers the limits compare
and the ones they leave out (training: ``loss_gap``, the worst step's
loss; ``grad_gap``, ``change_gap``, the worst leaf's gap of norms of the
first gradient and of the change; eval: :func:`eval_diagnostics`). The limits of
``benchmark/limits/<cell>.json`` should fail each control and fault line
and pass each witness line.
"""

import argparse
import json
import os
import sys
import time

import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def channels_last(t):
    """A convolution operand laid out channels-last (the witness)."""
    return t.contiguous(memory_format=torch.channels_last) \
        if t.dim() == 4 else t


def _cudnn_free(free: bool) -> None:
    """cuDNN as a run sets it (deterministic, no search), or free to
    choose its fastest algorithm, as a change for speed would."""
    torch.backends.cudnn.benchmark = free
    torch.backends.cudnn.deterministic = not free


def _witness(run):
    """``run(channels_last)`` with cuDNN free to choose."""
    _cudnn_free(True)
    try:
        return run(channels_last)
    finally:
        _cudnn_free(False)


def diagnostics(other, ref):
    """The training numbers the limits leave out (PERF.md section 2)."""
    from harness import compare

    (ol, _, oc, og), (rl, _, rc, rg) = other, ref
    keep = compare.kept_leaves(rg)
    loss = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(ol, rl))
    return {"loss_gap": loss,
            "grad_gap": compare._leaf_gaps(compare._norms(og),
                                           compare._norms(rg), keep)[-1],
            "change_gap": compare._leaf_gaps(compare._norms(oc),
                                             compare._norms(rc), keep)[-1]}


def eval_diagnostics(other, ref):
    """Eval numbers the limits leave out: the median window's relative
    gaps, and the worst window's widest and 99.9th-percentile gap of
    ``flow_bw`` in u16 steps."""
    import numpy as np

    out = {}
    for m in ("fwl", "rsat", "aee"):
        out[m + "_median_gap"] = float(np.median(
            [abs(o[m] - r[m]) / max(abs(r[m]), 1e-12)
             for o, r in zip(other, ref)]))
    if ref[0].get("flow_bw") is not None:
        d = [np.abs(o["flow_bw"].astype(np.int64)
                    - r["flow_bw"].astype(np.int64))
             for o, r in zip(other, ref)]
        out["flow_bw_steps"] = max(float(x.max()) for x in d)
        out["flow_bw_p999_steps"] = max(float(np.quantile(x, 0.999))
                                        for x in d)
    return out


def readings(spec, workload: str, seed: int, variant: str, device):
    """The numbers of one seed: the reference against the reference with
    ``variant``."""
    from harness import compare, events
    from harness.weights import make_weights
    from reference.precision import QUANT, control_for

    cell = spec.workload(workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    mcfg = cfg["model"]
    _cudnn_free(False)
    weights = make_weights(mcfg, seed, device)
    if mix["kind"] == "train":
        from reference.train import run_steps

        pool = events.train_pool(mix, seed, first=3)
        res = tuple(mix["resolution"])
        wins = [{"event_list": torch.from_numpy(w.events).to(device),
                 "grad_mask": torch.from_numpy(w.grad).to(device),
                 "res": res} for w in pool]
        rcfg = {"model": mcfg, "optimizer": cfg["optimizer"],
                "loss": dict(cfg["loss"], passes_loss=mix["passes"])}
        ref = run_steps(weights, rcfg, wins)
        if variant == "half_batch":
            other = run_steps(weights, rcfg, wins, half_batch=True)
        elif variant == "signflip":
            opt = dict(cfg["optimizer"], lr=-cfg["optimizer"]["lr"])
            other = run_steps(weights, dict(rcfg, optimizer=opt), wins)
        elif variant == "jitter":
            gen = torch.Generator(device=device).manual_seed(seed)
            shaken = {k: v * (1 + 1e-6 * torch.randn(
                v.shape, generator=gen, device=device))
                for k, v in weights.items()}
            other = run_steps(shaken, rcfg, wins)
        elif variant == "reorder":
            other = _witness(lambda q: run_steps(weights, rcfg, wins,
                                                 quant=q))
        else:
            other = run_steps(weights, rcfg, wins,
                              quant=QUANT[control_for("float32")])
        return dict(compare.train_numbers(*other[:3], *ref),
                    **diagnostics(other, ref))
    from reference.eval import replay

    seq = events.eval_sequence(mix, seed)
    dt = ("bfloat16" if mix["pipeline"]["metrics"].get("inference_dtype")
          in ("bfloat16", "bf16") else "float32")
    fs = cfg["loss"]["flow_scaling"]
    ref = replay(seq, weights, mcfg, mix, fs, device)
    if variant == "reorder":
        other = _witness(lambda q: replay(seq, weights, mcfg, mix, fs,
                                          device, quant=q))
    else:
        other = replay(seq, weights, mcfg, mix, fs, device,
                       quant=QUANT[control_for(dt)])
    return dict(compare.eval_numbers(other, ref),
                **eval_diagnostics(other, ref))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant", default="control",
                    choices=("control", "reorder", "half_batch",
                             "signflip", "jitter"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, BENCH_DIR]
    from harness.spec import Spec

    spec = Spec(ROOT, BENCH_DIR)
    device = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.time()
        nums = readings(spec, args.workload, seed, args.variant, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "variant": args.variant, "numbers": nums,
                          "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
