"""``forward_host_ms.train``: the host's milliseconds a training step inside
the program's span ``train.forward`` (``training/step.py:
make_train_step``: the window's unpack and the P recurrent passes), the
mean over a traced stretch's steps (``harness/program_spans.py``)."""

from harness import program_spans


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return program_spans.span_ms(ctx, ["train.forward"])
