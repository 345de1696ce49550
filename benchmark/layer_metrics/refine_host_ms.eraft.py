"""``refine_host_ms.eraft``: the host's milliseconds a GT window inside the
program's span ``eraft.refine`` (``models/eraft.py``: E-RAFT's refinement
iterations, the correlation lookups, the motion encoder, the GRU and the
flow head, dispatched), the mean over a traced stretch's GT windows
(``harness/program_spans.py``)."""

from harness import program_spans


def read(ctx):
    if ctx.get("kind") != "eval":
        return None
    return program_spans.span_ms(ctx, ["eraft.refine"])
