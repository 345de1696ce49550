"""``graph_replay_share.eval``: the share of the traced GT windows whose
window step replayed its CUDA graph, in percent: the program's counter
``eval_graph_replays`` (``training/graphed.py``, one a replayed window)
summed over a traced stretch, over its GT windows
(``harness/program_spans.py``)."""

from harness import program_spans


def read(ctx):
    if ctx.get("kind") != "eval":
        return None
    replays = program_spans.counter_sum(ctx, "eval_graph_replays")
    if replays is None:
        return None
    return 100.0 * replays / len(ctx["trace_counts"])
