"""``loss_idle_ms.train``: the milliseconds a training step in which the
device ran nothing while the host was inside the program's span
``train.loss`` (``training/step.py: make_train_step``: the
contrast-maximisation loss, ``LOSS_REGISTRY``'s call), the mean over a
traced stretch's steps (``harness/program_spans.py``)."""

from harness import program_spans


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return program_spans.span_ms(ctx, ["train.loss"], idle=True)
