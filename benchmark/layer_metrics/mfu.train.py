"""``mfu.train``: the whole training step's share of the card's float32
peak (the step runs float32 with TF32 off): the operations of one step
(``harness.work.pass_flops``, counted from the configuration's shapes as
``torch.utils.flop_counter`` counts them) times the steps of the measured
window, over the window's seconds, over the peak; in percent."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("peaks"):
        return None
    rate = ctx["flops_per_step"] * ctx["steps"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"][ctx["peak"]]
