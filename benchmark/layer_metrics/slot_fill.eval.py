"""``slot_fill.eval``: the share of the event rows the eval pipeline
stages that hold a real event, in percent: its counter ``events`` (rows of
nonzero polarity) over its counter ``slots`` (every row staged, padding to
the bucket included), each summed over a traced stretch
(``pipeline/eval.py: EvalPipeline``; ``harness/program_spans.py``)."""

from harness import program_spans


def read(ctx):
    if ctx.get("kind") != "eval":
        return None
    events = program_spans.counter_sum(ctx, "events")
    slots = program_spans.counter_sum(ctx, "slots")
    if events is None or not slots:
        return None
    return 100.0 * events / slots
