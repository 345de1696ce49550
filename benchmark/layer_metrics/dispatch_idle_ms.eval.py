"""``dispatch_idle_ms.eval``: the milliseconds a GT window in which the
device ran nothing while the host was inside the eval pipeline's call of
its step: the section ``window_call`` on the windowed path (the window
step's P forwards and validation updates) or ``pass_call`` on the per-pass
path (``pipeline/eval.py: EvalPipeline``), the mean over a traced
stretch's GT windows (``harness/program_spans.py``)."""

from harness import program_spans


def read(ctx):
    if ctx.get("kind") != "eval":
        return None
    return program_spans.span_ms(ctx, ["window_call", "pass_call"],
                                 idle=True)
