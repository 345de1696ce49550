"""``assemble_idle_ms.dsec``: the milliseconds a GT window in which the
device ran nothing while the host was inside the eval pipeline's section
``window_assemble`` (``pipeline/eval.py: EvalPipeline.run_window``: the
wire staging, u32 packing and uploads of a window), the mean over a traced
stretch's GT windows (``harness/program_spans.py``)."""

from harness import program_spans


def read(ctx):
    if ctx.get("kind") != "eval":
        return None
    return program_spans.span_ms(ctx, ["window_assemble"], idle=True)
