"""``warp_roofline.train``: the training step's warp work at the card's
memory roofline over the device time of the warp kernels that did it
(``csrc/warp_kernels.cu`` through ``ops/cuda_warp.py``: the kernels
``harness.trace.KERNEL_MAP`` files under ``warp``), over a traced stretch;
in percent.

The work is counted from the configuration and the algorithm, never from
the program's launch counters: bytes that the loss's bilinear gathers and
splats must read and write, each input once and each output once, for the
real (unpadded) events of each window, forward and backward, every model
scale. A gather reads its map and its locations and writes a value a row;
its backward splats the cotangent into the map's gradient and, where the
locations carry a gradient, reads the map again for the location gradient.
A splat reads locations and values and writes its image; its backward
reads the image's cotangent, the locations and values, and writes the
location gradient. Iterative: the triangular warp table (a gather of one
flow map a timeline step, over the windows that have joined, in both
directions) and one 4-channel splat a tref over the windows inside its
deblurring extent. Linear: one arrival gather of every window's events
and two 4-channel splats (forward and backward warp)."""

F32 = 4


def _gather(map_px, c, rows, grad_rows):
    fwd = map_px * c * F32 + rows * 2 * F32 + rows * c * F32
    d_map = rows * 2 * F32 + rows * c * F32 + map_px * c * F32
    d_loc = 0
    if grad_rows:
        d_loc = map_px * c * F32 + grad_rows * (2 + c + 2) * F32
    return fwd + d_map + d_loc


def _splat(map_px, c, rows):
    fwd = rows * (2 + c) * F32 + map_px * c * F32
    bwd = map_px * c * F32 + rows * (2 + c) * F32 + rows * 2 * F32
    return fwd + bwd


def iterative_bytes(n, map_px, mode="two"):
    """One model scale's table and sweep; ``n[t]``: real events of window
    ``t`` over the lanes; ``map_px``: B x H x W."""
    p = len(n)
    total = 0
    for tau in range(p):
        fw_rows = sum(n[: tau + 1])
        total += _gather(map_px, 2, fw_rows, fw_rows - n[tau] if tau else 0)
        bw_rows = sum(n[tau:])
        total += _gather(map_px, 2, bw_rows,
                         bw_rows - n[tau] if tau < p - 1 else 0)
    delta = p // {"one": 1, "two": 2, "four": 4}[mode]
    lo_t, hi_t = (delta, 3 * delta + 1) if mode == "four" else (0, p + 1)
    for tref in range(lo_t, hi_t):
        rows = sum(n[max(0, tref - delta): min(p, tref + delta)])
        total += _splat(map_px, 4, rows)
    return total


def linear_bytes(n, map_px):
    p, rows = len(n), sum(n)
    arrival = (p * map_px * 2 * F32 + rows * 4 * F32
               + rows * 4 * F32 + p * map_px * 2 * F32)
    return arrival + 2 * _splat(map_px, 4, rows)


def step_bytes(counts, cfg, mix):
    """Bytes of one step; ``counts [P, B]`` real events a pass and lane."""
    h, w = mix["resolution"]
    map_px = mix["batch"] * h * w
    n = [int(x) for x in counts.sum(axis=1)]
    scales = cfg["model"]["num_encoders"]
    loss = cfg["loss"]
    if loss["warping"] == "Iterative":
        one = iterative_bytes(n, map_px, loss.get("iterative_mode", "two"))
    else:
        one = linear_bytes(n, map_px)
    return scales * one


def read(ctx):
    tr = ctx.get("trace") if ctx.get("kind") == "train" else None
    if tr is None or not ctx.get("peaks"):
        return None
    kernel_s = tr.kernel_s("warp")
    if kernel_s <= 0:
        return None
    total = sum(step_bytes(c, ctx["cfg"], ctx["mix"])
                for c in ctx["trace_counts"])
    return 100.0 * total / ctx["peaks"]["hbm_bytes_s"] / kernel_s
