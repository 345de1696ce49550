"""``window_assemble_ms.dsec``: the eval pipeline's own ``SectionTimer``
section ``window_assemble`` (wire staging, u32 packing, uploads of a GT
window; ``pipeline/eval.py: EvalPipeline.run_window``), the mean per GT
window over the measured window."""


def read(ctx):
    sec = ctx.get("sections") if ctx.get("kind") == "eval" else None
    if not sec or "window_assemble" not in sec:
        return None
    total, count = sec["window_assemble"]
    return total / count * 1e3
