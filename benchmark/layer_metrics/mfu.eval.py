"""``mfu.eval``: the whole eval window's share of the card's peak in the
precision the forward runs in (bfloat16 for DSEC, float32 for MVSEC): the
forward operations of one GT window (``harness.work.pass_flops``) times the
GT windows of the measured window, over the window's seconds, over the
peak; in percent."""


def read(ctx):
    if ctx.get("kind") != "eval" or not ctx.get("peaks"):
        return None
    rate = ctx["flops_per_window"] * ctx["windows"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"][ctx["peak"]]
