"""``step_host_ms.train``: the host's time to dispatch one training step
(``training/step.py``'s step call, timed by the benchmark's clock without a
synchronise), the mean over the measured window's steps."""


def read(ctx):
    ms = ctx.get("step_host_ms") if ctx.get("kind") == "train" else None
    if not ms:
        return None
    return sum(ms) / len(ms)
