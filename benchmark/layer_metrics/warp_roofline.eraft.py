"""``warp_roofline.eraft``: an E-RAFT eval GT window's warp-kernel work at
the card's memory roofline over the device time of the warp kernels that
did it (``harness.trace.KERNEL_MAP``'s ``warp`` group), over a traced
stretch; in percent.

Those kernels do two jobs in this cell: the Iterative validation's gathers
and splats and the u32 wire's row gathers, counted by
``warp_roofline.eval.py``'s ``window_bytes`` (loaded from that file), and
E-RAFT's correlation lookups, counted here from the configuration's shapes
(never read from the program): per query position of the padded input at
1/8 resolution, pyramid level and refinement, the ``(2r + 2)^2`` corner
values its ``(2r + 1)^2`` bilinear taps touch read once, its ``(2r + 1)^2``
float outputs written once and its coordinates (two floats) read once."""

import importlib.util
import os

F32 = 4
MIN_SIZE = 32  # E-RAFT's input padding


def _eval_reader():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "warp_roofline.eval.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_warp_roofline_eval", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lookup_bytes_per_pass(model, mix):
    """Bytes of one pass's correlation lookups (batch 1)."""
    h, w = (n + (MIN_SIZE - n % MIN_SIZE) % MIN_SIZE
            for n in mix["resolution"])
    queries = (h // 8) * (w // 8)
    r = model["corr_radius"]
    per = ((2 * r + 2) ** 2 + (2 * r + 1) ** 2 + 2) * F32
    return queries * model["corr_levels"] * model["iters"] * per


def read(ctx):
    tr = ctx.get("trace") if ctx.get("kind") == "eval" else None
    if tr is None or not ctx.get("peaks"):
        return None
    kernel_s = tr.kernel_s("warp")
    if kernel_s <= 0:
        return None
    window_bytes = _eval_reader().window_bytes
    lookups = lookup_bytes_per_pass(ctx["cfg"]["model"], ctx["mix"])
    total = sum(window_bytes(c, ctx["mix"], ctx["rectified"])
                + len(c) * lookups for c in ctx["trace_counts"])
    return 100.0 * total / ctx["peaks"]["hbm_bytes_s"] / kernel_s
