"""``refine_idle_ms.eraft``: the milliseconds a GT window in which the
device ran nothing while the host was inside the program's span
``eraft.refine`` (``models/eraft.py``: E-RAFT's refinement iterations), the
mean over a traced stretch's GT windows (``harness/program_spans.py``)."""

from harness import program_spans


def read(ctx):
    if ctx.get("kind") != "eval":
        return None
    return program_spans.span_ms(ctx, ["eraft.refine"], idle=True)
