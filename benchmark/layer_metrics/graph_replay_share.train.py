"""``graph_replay_share.train``: the share of the traced training steps
that replayed the step's CUDA graph, in percent: the program's counter
``train_graph_replays`` (``training/graphed.py``, one a replayed step)
summed over a traced stretch, over its steps
(``harness/program_spans.py``)."""

from harness import program_spans


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    replays = program_spans.counter_sum(ctx, "train_graph_replays")
    if replays is None:
        return None
    return 100.0 * replays / len(ctx["trace_counts"])
