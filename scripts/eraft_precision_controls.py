"""E-RAFT's float32 island against the ``eraft_dsec_eval`` cell's limits.

The configuration keeps E-RAFT's correlation, its pyramid, the lookups,
the coordinates and the flow in float32 under a bfloat16 forward
(``benchmark/configs/eraft_iterative.json``, ``precision.eval``). This
script computes the benchmark's plain reference
(``benchmark/reference/models/eraft.py``) with one part of that island
lower, and holds it to the reference by the numbers and limits the cell
compares (``benchmark/limits/eraft_dsec_eval.json``), as
``benchmark/control.py`` does for its controls:

* ``volume_bf16``: the volume and each pyramid level held in bfloat16
  (each pool reads the rounded level below it);
* ``coords_bf16``: the coordinates held in bfloat16: each lookup reads a
  bfloat16 coordinate and each refinement's update lands on one.

Rounding the correlation matmul's operands to bfloat16 or TF32 is no
variant: under the bfloat16 forward they are ``fnet``'s bfloat16 outputs,
which both formats hold exactly, so a tensor-core matmul that accumulates
in float32 computes the same products.

    python3 scripts/eraft_precision_controls.py --seeds <n> [<n> ...]
                                                [--variants <name> ...]

Prints one JSON line a seed and variant: the numbers, and the limits each
number exceeds (``fails``). Runs on the card by default (``--device``).
"""

import argparse
import contextlib
import json
import os
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmark")
CELL = "eraft_dsec_eval"


def _bf16(t):
    return t.bfloat16().float()


def _variant_patches(mod, name):
    """``{attribute: replacement}`` of the reference module ``mod`` that
    computes the variant ``name``."""
    corr_pyramid = mod.corr_pyramid
    if name == "volume_bf16":
        def pyramid(fmap1, fmap2, levels, quant=None):
            out = [_bf16(corr_pyramid(fmap1, fmap2, 1, quant)[0])]
            for _ in range(levels - 1):
                out.append(_bf16(F.avg_pool2d(out[-1], 2, stride=2)))
            return out
        return {"corr_pyramid": pyramid}
    if name == "coords_bf16":
        lookup, update_block = mod.corr_lookup, mod.update_block
        last = {}

        def rounded_lookup(pyramid, coords, r):
            last["coords"] = _bf16(coords)
            return lookup(pyramid, last["coords"], r)

        def rounded_update(p, net, inp, corr, flow, quant=None):
            # the forward adds the update to the coordinates the lookup
            # read: land that sum on a bfloat16 coordinate (the difference
            # of two bfloat16 values in this range is exact in float32)
            net, delta = update_block(p, net, inp, corr, flow, quant)
            c = last["coords"]
            return net, _bf16(c + delta.float()) - c
        return {"corr_lookup": rounded_lookup,
                "update_block": rounded_update}
    raise ValueError(f"unknown variant {name!r}")


VARIANTS = ("volume_bf16", "coords_bf16")


@contextlib.contextmanager
def variant(mod, name):
    """The reference module ``mod`` computing ``name`` inside the block."""
    patches = _variant_patches(mod, name)
    saved = {k: getattr(mod, k) for k in patches}
    try:
        for k, v in patches.items():
            setattr(mod, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, BENCH_DIR]
    import control
    from harness import compare, events
    from harness.spec import Spec
    from harness.weights import make_weights
    from reference.eval import replay
    from reference.models import lookup

    spec = Spec(ROOT, BENCH_DIR)
    cell = spec.workload(CELL)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    with open(os.path.join(BENCH_DIR, "limits", CELL + ".json")) as f:
        limits = json.load(f)["limits"]
    mcfg, fs = cfg["model"], cfg["loss"]["flow_scaling"]
    mod = lookup(mcfg)
    device = torch.device(args.device)
    control._cudnn_free(False)
    for seed in args.seeds:
        weights = make_weights(mcfg, seed, device)
        seq = events.eval_sequence(mix, seed)
        ref = replay(seq, weights, mcfg, mix, fs, device)
        for name in args.variants:
            t0 = time.time()
            with variant(mod, name):
                other = replay(seq, weights, mcfg, mix, fs, device)
            nums = dict(compare.eval_numbers(other, ref),
                        **control.eval_diagnostics(other, ref))
            fails = sorted(k for k, v in limits.items() if nums[k] > v)
            print(json.dumps({"workload": CELL, "seed": seed,
                              "variant": name, "numbers": nums,
                              "fails": fails,
                              "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
