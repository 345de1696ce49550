"""``h2d_mb_per_window.dsec``: the megabytes (1e6 bytes) the eval pipeline
uploads a GT window, its counter ``h2d_bytes`` (each host array
``pipeline/eval.py: EvalPipeline._dev`` hands the device) summed over a
traced stretch, over its GT windows (``harness/program_spans.py``)."""

from harness import program_spans


def read(ctx):
    if ctx.get("kind") != "eval":
        return None
    total = program_spans.counter_sum(ctx, "h2d_bytes")
    if total is None:
        return None
    return total / len(ctx["trace_counts"]) / 1e6
