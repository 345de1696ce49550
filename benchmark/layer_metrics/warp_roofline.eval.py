"""``warp_roofline.eval``: an eval GT window's warp work at the card's
memory roofline over the device time of the warp kernels that did it
(``harness.trace.KERNEL_MAP``'s ``warp`` group), over a traced stretch; in
percent.

The work is counted from the protocol and the algorithm (Iterative
validation, ``metrics/validation.py``), for the real events of each pass:
each pass's gather of its flow map at every stored window's forward-warped
events and at the H x W accumulated grid; at the boundary, RSAT and FWL's
two 4-channel splats of the window's events, and with ``mask_aee`` the
event image's 2-channel splat; on a rectified sequence's u32 wire, the
row gather of each event's rectified coordinates and the row gather that
remaps each pass's count rows. Each input counted read once, each output
written once."""

F32 = 4
I32 = 4


def window_bytes(counts, mix, rectified):
    """Bytes of one GT window; ``counts [P]`` real events a pass."""
    h, w = mix["resolution"]
    px = h * w
    n = [int(x) for x in counts]
    total = 0
    for p in range(len(n)):
        rows = sum(n[: p + 1]) + px
        total += px * 2 * F32 + rows * 2 * F32 + rows * 2 * F32
    rows = sum(n)
    total += 2 * (rows * (2 + 4) * F32 + px * 4 * F32)
    if mix["pipeline"]["metrics"].get("mask_aee"):
        total += rows * (2 + 2) * F32 + px * 2 * F32
    if rectified:
        total += rows * (I32 + 2 * F32 + 2 * F32)
        total += len(n) * px * (I32 + 2 * F32 + 2 * F32)
    return total


def read(ctx):
    tr = ctx.get("trace") if ctx.get("kind") == "eval" else None
    if tr is None or not ctx.get("peaks"):
        return None
    kernel_s = tr.kernel_s("warp")
    if kernel_s <= 0:
        return None
    total = sum(window_bytes(c, ctx["mix"], ctx["rectified"])
                for c in ctx["trace_counts"])
    return 100.0 * total / ctx["peaks"]["hbm_bytes_s"] / kernel_s
