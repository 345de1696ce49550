"""``device_idle.eval``: the share of a traced stretch of GT windows in
which no operation ran on the device, 1 - busy / stretch, in percent."""


def read(ctx):
    tr = ctx.get("trace") if ctx.get("kind") == "eval" else None
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
