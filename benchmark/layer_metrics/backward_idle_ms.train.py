"""``backward_idle_ms.train``: the milliseconds a training step in which the
device ran nothing while the host was inside the program's span
``train.backward`` (``training/step.py: make_train_step``:
``loss.backward()``: the host waits there while the autograd engine
dispatches), the mean over a traced stretch's steps
(``harness/program_spans.py``)."""

from harness import program_spans


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return program_spans.span_ms(ctx, ["train.backward"], idle=True)
