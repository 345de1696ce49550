"""``window_call_ms.dsec``: the eval pipeline's own ``SectionTimer``
section ``window_call`` (the window step's call: the P forwards and
validation updates of a GT window, dispatched; ``pipeline/eval.py:
EvalPipeline.run_window``), the mean per GT window over the measured
window, as ``window_assemble_ms.dsec`` reads ``window_assemble``."""


def read(ctx):
    sec = ctx.get("sections") if ctx.get("kind") == "eval" else None
    if not sec or "window_call" not in sec:
        return None
    total, count = sec["window_call"]
    return total / count * 1e3
